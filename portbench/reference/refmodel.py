# Frozen copy of the functions of tests/refmodel.py (the port's test
# oracle, as of the commit this benchmark was added on) that the
# -polish reference calls: traverse_paths and ref_best_variant with
# their helpers, each as it is there.
"""Independent naive oracle for merfin semantics.

A deliberately scalar, dict/string-based transcription of the reference
C++ (merfin's src/merfin), sharing NO code with merfin_tpu's
engine (string k-mers instead of bit-packed, Python loops instead of
arrays).  Tests compare merfin_tpu's outputs against this model on tiny
synthetic inputs.
"""

from __future__ import annotations

_U64 = 1 << 64


# ---- variant scoring (varMer.C) ----

def traverse_paths(template: str, ref_idx: list[int], ref_len: list[int],
                   haps: list[list[str]]):
    """traverse() (merfin-variants.C:22-126) + addSeqPath dedup."""
    out: list[tuple[str, list[int], list[int], list[int]]] = []
    seen: set[str] = set()
    n = len(ref_idx)
    if n == 0:
        return out
    idxs = list(ref_idx)
    path: list[int] = []

    def add(seq, gt, ii, ll):
        if seq not in seen:
            seen.add(seq)
            out.append((seq, list(gt), list(ii), list(ll)))

    def rec(pos: int, lens: list[str], cand: str):
        lens = list(lens)
        orig = lens[pos]
        for j in range(len(haps[pos])):
            path.append(j)
            cur = pos
            replaced = cand
            skipped = 0
            overlaps = False
            delta = 0
            if j > 0:
                lens[pos] = orig
                a = idxs[pos]
                replaced = cand[:a] + haps[pos][j] + cand[a + lens[pos]:]
                delta = len(haps[pos][j]) - lens[pos]
                affected = idxs[pos] + lens[pos]
                lens[pos] = len(haps[pos][j])
                i = cur + 1
                while i < n and idxs[i] < affected:
                    overlaps = True
                    cur += 1
                    path.append(0)
                    skipped += 1
                    i += 1
                if overlaps and cur == n - 1:
                    add(replaced, path, idxs, lens)
                    for _ in range(skipped):
                        path.pop()
                    path.pop()
                    continue
                for i2 in range(cur + 1, n):
                    idxs[i2] += delta
            if cur + 1 < n:
                rec(cur + 1, lens, replaced)
            if cur == n - 1:
                add(replaced, path, idxs, lens)
            for i2 in range(cur + 1, n):
                idxs[i2] -= delta
            for _ in range(skipped):
                path.pop()
            path.pop()

    rec(0, ref_len, template)
    return out


# ---- selectors (varMer.C:150-467) ----
#
# Literal scalar transcriptions of the five selection policies, written
# from the C++ alone and operating on plain data (no merfin_tpu types):
#   seqs:     list[str]               (varMer::seqs)
#   num_ms:   list[int]               (varMer::numMs, uint32)
#   gt_paths: list[list[int]]         (varMer::gtPaths)
#   dkstrs:   list[list[float]]       (varMer::dkstrs)
#   gts:      list[(pos0, qual, alleles)]  (posGT::_gts: _pos, _qual, _alleles)
# These are the independent oracle for merfin_tpu/variants/select.py.

UINT32_MAX = 0xFFFFFFFF


def _all_missing_size_t(num_m: int, seq_len: int, k: int) -> bool:
    """numMs.at(ii) == seqs.at(ii).size() - merSize() + 1: the RHS is
    size_t arithmetic, so seq_len < k-1 wraps huge (varMer.C:158,408)."""
    return num_m == (seq_len - k + 1) % _U64


def ref_hom_record(chrom, gts, gt_path) -> str:
    """varMer::getHomRecord (varMer.C:531-550)."""
    records = ""
    for i in range(len(gt_path)):
        alt_idx = gt_path[i]
        if alt_idx > 0:
            pos, qual, alleles = gts[i]
            qual_str = str(int(qual))          # to_string((int)_qual)
            records = (records + chrom + "\t" + str(pos + 1) + "\t.\t" +
                       alleles[0] + "\t" + alleles[alt_idx] + "\t" +
                       qual_str + "\t" + "PASS\t.\tGT\t1/1\n")
    return records


def ref_het_record(chrom, gts, gt1, gt2) -> str:
    """varMer::getHetRecord (varMer.C:472-529)."""
    records = ""
    for i in range(len(gt1)):
        alt1, alt2 = gt1[i], gt2[i]
        if alt1 + alt2 > 0:
            pos, qual, alleles = gts[i]
            qual_str = str(int(qual))
            records = (records + chrom + "\t" + str(pos + 1) + "\t" +
                       "." + "\t" + alleles[0] + "\t")
            if alt1 == alt2:
                records += alleles[alt1] + "\t" + qual_str + "\tPASS\t.\tGT\t1/1\n"
            elif alt1 == 0 and alt2 > 0:
                records += alleles[alt2] + "\t" + qual_str + "\tPASS\t.\tGT\t0/1\n"
            elif alt1 > 0 and alt2 > 0:
                records += (alleles[alt1] + "," + alleles[alt2] + "\t" +
                            qual_str + "\tPASS\t.\tGT\t1/2\n")
            elif alt1 > 0 and alt2 == 0:
                records += alleles[alt1] + "\t" + qual_str + "\tPASS\t.\tGT\t1/0\n"
    return records


def ref_totdk(dkstrs, idx) -> float:
    """varMer::getTotdK (varMer.C:648-659)."""
    s = 0.0
    for v in dkstrs[idx]:
        s += v
    return s


def _multimap_insert_greater_int(mm, key: float, val: int) -> None:
    """multimap<double,int,greater<int>>::insert (varMer.H:72): the
    comparator takes ints, so double keys truncate toward zero when
    compared; insert lands at upper_bound, i.e. AFTER existing
    int-equal keys (insertion order preserved among equals)."""
    pos = len(mm)
    for j in range(len(mm)):
        if int(key) > int(mm[j][0]):           # comp(new, elem)
            pos = j
            break
    mm.insert(pos, (key, val))


def ref_best_variant(seqs, num_ms, gt_paths, dkstrs, chrom, gts, k) -> str:
    """varMer::bestVariant — -polish (varMer.C:400-467).  PLAIN scan:
    no numM==0 block; empty test is numMissing == UINT32_MAX."""
    num_missing = UINT32_MAX
    idxs = []
    for ii in range(len(num_ms)):
        if _all_missing_size_t(num_ms[ii], len(seqs[ii]), k):
            continue
        if num_ms[ii] < num_missing:
            num_missing = num_ms[ii]
            idxs = [ii]
        elif num_ms[ii] == num_missing:
            idxs.append(ii)
    if num_missing == UINT32_MAX:
        return ""
    if len(idxs) == 1:
        return ref_hom_record(chrom, gts, gt_paths[idxs[0]])
    elif len(idxs) > 1:
        avg_ks = []
        for i in range(len(idxs)):
            idx = idxs[i]
            _multimap_insert_greater_int(avg_ks, ref_totdk(dkstrs, idx), idx)
        avg_k1, idx1 = avg_ks[0]
        avg_k2, idx2 = avg_ks[1]
        if avg_k1 == avg_k2:                   # DOUBLE compare (varMer.C:453)
            if len(seqs[idx1]) >= len(seqs[idx2]):
                return ref_het_record(chrom, gts, gt_paths[idx1], gt_paths[idx2])
            else:
                return ref_het_record(chrom, gts, gt_paths[idx2], gt_paths[idx1])
        else:
            return ref_hom_record(chrom, gts, gt_paths[idx1])
    return ""
