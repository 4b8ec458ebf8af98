"""Per-cluster output selection — the five report policies.

Reference: varMer.C:150-467 (bestFilter / bestVariant / betterVariant /
strictPolish / loosePolish) and the record emitters varMer.C:469-550.
All tie-break quirks are reproduced:

  * bestFilter pushes zero-missing paths TWICE into the candidate list
    (varMer.C:161-163 `numM == 0` block + varMer.C:173-175 equality
    block both fire, and the zero block pre-sets numMissing so the
    strict-`<` reset never clears).  bestVariant does NOT share this:
    varMer.C:406-421 is a plain scan — a zero-missing path arrives via
    the strict-`<` branch, CLEARS the pre-zero survivors, and appends
    once; the empty-result test is `numMissing == UINT32_MAX`
    (varMer.C:424), not `idxs.empty()`.
  * bestVariant ranks tied paths with a multimap keyed by totdK but
    compared with greater<int> (varMer.H:72): descending by the
    INT-TRUNCATED totdK, insertion order preserved among equal ints.
  * "all k-mers missing" test is `numM == len(seq) - k + 1` computed in
    size_t arithmetic: paths shorter than k-1 never match (varMer.C:158).
  * quals print as (int)-cast strings (varMer.C:486,537).
"""

from __future__ import annotations

import sys

import numpy as np

from merfin_tpu_torch.io.vcf import PosGT
from merfin_tpu_torch.variants.enumerate import VarPath
from merfin_tpu_torch.variants.score import PathScore

_U64 = 1 << 64


def _all_missing(num_m: int, seq_len: int, k: int) -> bool:
    """numM == (size_t)(len - k + 1) (varMer.C:158,408)."""
    return num_m == (seq_len - k + 1) % _U64


def _min_missing_idxs_filterlike(paths, scores, k) -> list[int]:
    """The bestFilter loop (varMer.C:156-178), WITH the zero-missing
    double-push quirk (the `numM == 0` block at :161-163 fires in
    addition to the equality block at :173-175)."""
    num_missing = 0xFFFFFFFF
    idxs: list[int] = []
    for ii, (p, s) in enumerate(zip(paths, scores)):
        if _all_missing(s.num_m, len(p.seq), k):
            continue
        if s.num_m == 0:
            idxs.append(ii)
            num_missing = 0
        if s.num_m < num_missing:
            num_missing = s.num_m
            idxs = [ii]
        elif s.num_m == num_missing:
            idxs.append(ii)
    return idxs


def _min_missing_idxs_plain(paths, scores, k) -> tuple[list[int], int]:
    """The bestVariant loop (varMer.C:406-421): a PLAIN running-minimum
    scan with no `numM == 0` block — strict decrease clears + pushes,
    equality appends.  Returns (idxs, num_missing) because the caller's
    empty test is `numMissing == UINT32_MAX` (varMer.C:424), which
    differs from `not idxs` when a path carries num_m == UINT32_MAX."""
    num_missing = 0xFFFFFFFF
    idxs: list[int] = []
    for ii, (p, s) in enumerate(zip(paths, scores)):
        if _all_missing(s.num_m, len(p.seq), k):
            continue
        if s.num_m < num_missing:
            num_missing = s.num_m
            idxs = [ii]
        elif s.num_m == num_missing:
            idxs.append(ii)
    return idxs, num_missing


def best_filter(paths: list[VarPath], scores: list[PathScore], pos_gt: PosGT, k: int):
    """-filter: union of ALT indices over min-missing paths; emit the
    ORIGINAL input records (varMer.C:150-199)."""
    idxs = _min_missing_idxs_filterlike(paths, scores, k)
    if not idxs:
        return []
    gt_idxs = sorted({i for idx in idxs for i, g in enumerate(paths[idx].gt_path) if g > 0})
    return [pos_gt.gts[i].record for i in gt_idxs]


def get_hom_record(pos_gt: PosGT, gt_path: list[int]) -> str:
    """varMer::getHomRecord (varMer.C:531-550)."""
    records = ""
    for i, alt_idx in enumerate(gt_path):
        if alt_idx > 0:
            gt = pos_gt.gts[i]
            qual = str(int(gt.qual))     # (int) cast, truncates toward zero
            records += (f"{pos_gt.chrom}\t{gt.pos + 1}\t.\t{gt.alleles[0]}\t"
                        f"{gt.alleles[alt_idx]}\t{qual}\tPASS\t.\tGT\t1/1\n")
    return records


def get_het_record(pos_gt: PosGT, gt1: list[int], gt2: list[int]) -> str:
    """varMer::getHetRecord (varMer.C:472-529)."""
    records = ""
    for i, (a1, a2) in enumerate(zip(gt1, gt2)):
        if a1 + a2 > 0:
            gt = pos_gt.gts[i]
            qual = str(int(gt.qual))
            head = f"{pos_gt.chrom}\t{gt.pos + 1}\t.\t{gt.alleles[0]}\t"
            if a1 == a2:
                records += head + f"{gt.alleles[a1]}\t{qual}\tPASS\t.\tGT\t1/1\n"
            elif a1 == 0 and a2 > 0:
                records += head + f"{gt.alleles[a2]}\t{qual}\tPASS\t.\tGT\t0/1\n"
            elif a1 > 0 and a2 > 0:
                records += head + f"{gt.alleles[a1]},{gt.alleles[a2]}\t{qual}\tPASS\t.\tGT\t1/2\n"
            elif a1 > 0 and a2 == 0:
                records += head + f"{gt.alleles[a1]}\t{qual}\tPASS\t.\tGT\t1/0\n"
    return records


def tot_dk(score: PathScore) -> float:
    """getTotdK (varMer.C:648-659): the deltas added in path order, one
    at a time (np.sum's pairwise order can differ in the last bit, on
    which -polish's ordering and het test depend); device-reduced scores
    carry the same sum as a precomputed scalar (the per-window arrays
    never left the chip)."""
    if score.totdk is not None:
        return score.totdk
    return float(np.add.accumulate(score.dkstr)[-1]) if score.dkstr.size \
        else 0.0


def best_variant(paths, scores, pos_gt: PosGT, k: int) -> str:
    """-polish (varMer.C:400-467).  Uses the PLAIN min-missing scan —
    unlike bestFilter there is no zero-missing double-push, so a
    zero-missing path clears any pre-zero survivors (varMer.C:406-421)
    and the empty test is numMissing == UINT32_MAX (varMer.C:424)."""
    idxs, num_missing = _min_missing_idxs_plain(paths, scores, k)
    if num_missing == 0xFFFFFFFF:
        return ""
    if len(idxs) == 1:
        return get_hom_record(pos_gt, paths[idxs[0]].gt_path)

    # multimap<double,int,greater<int>>: descending by (int)totdK,
    # insertion order preserved for equal int keys.
    entries = [(tot_dk(scores[idx]), idx) for idx in idxs]
    order = sorted(range(len(entries)), key=lambda i: int(entries[i][0]), reverse=True)
    avg_k1, idx1 = entries[order[0]]
    avg_k2, idx2 = entries[order[1]]

    if avg_k1 == avg_k2:
        if len(paths[idx1].seq) >= len(paths[idx2].seq):
            return get_het_record(pos_gt, paths[idx1].gt_path, paths[idx2].gt_path)
        return get_het_record(pos_gt, paths[idx2].gt_path, paths[idx1].gt_path)
    return get_hom_record(pos_gt, paths[idx1].gt_path)


def _min_missing_idxs_vs_ref(scores, include_neutral: bool) -> list[int]:
    """Shared loop of betterVariant/strictPolish/loosePolish
    (varMer.C:216-230,271-285,332-346)."""
    if not scores:
        return []
    ref_missing = scores[0].num_m
    num_missing = ref_missing
    idxs: list[int] = []
    for ii, s in enumerate(scores):
        if s.num_m < num_missing:
            num_missing = s.num_m
            idxs = [ii]
        elif s.num_m == num_missing and (
            s.num_m <= ref_missing if include_neutral else s.num_m < ref_missing
        ):
            idxs.append(ii)
    return idxs


def _longest_of(paths, idxs: list[int]) -> int:
    """Tie-break: longest sequence, first wins ties (varMer.C:246-254)."""
    idx = idxs[0]
    max_len = len(paths[idx].seq)
    for ii in idxs[1:]:
        if len(paths[ii].seq) > max_len:
            max_len = len(paths[ii].seq)
            idx = ii
    return idx


def better_variant(paths, scores, pos_gt: PosGT, k: int) -> str:
    """-better (varMer.C:204-258)."""
    if not scores:
        return ""
    idxs = _min_missing_idxs_vs_ref(scores, include_neutral=False)
    if not idxs:
        return ""
    return get_hom_record(pos_gt, paths[_longest_of(paths, idxs)].gt_path)


def strict_polish(paths, scores, pos_gt: PosGT, k: int) -> str:
    """-strict (varMer.C:260-315) — identical logic to -better."""
    return better_variant(paths, scores, pos_gt, k)


def loose_polish(paths, scores, pos_gt: PosGT, k: int, log=sys.stderr) -> str:
    """-loose (varMer.C:317-395): neutral paths included."""
    if not scores:
        return ""
    idxs = _min_missing_idxs_vs_ref(scores, include_neutral=True)
    if not idxs:
        return ""
    if len(idxs) == 1:
        return get_hom_record(pos_gt, paths[idxs[0]].gt_path)
    if idxs[0] == 0 and len(idxs) == 2:
        return get_hom_record(pos_gt, paths[idxs[1]].gt_path)

    max_vars = 0
    max_idx = idxs[0]
    for ii in idxs[1:]:
        count = sum(1 for g in paths[ii].gt_path if g > 0)
        if count > max_vars:
            max_vars = count
            max_idx = ii
    rec = pos_gt.gts[0].record.save()
    print(f"[ WARNING ] :: Multiple ({len(idxs)}) alternate pathes detected in a "
          f"path beginning with variant : {rec}", end="", file=log)
    print(f"[ WARNING ] :: Max. {max_vars} ALT variants selected", file=log)
    return get_hom_record(pos_gt, paths[max_idx].gt_path)


# ---- array-native selection (fused-scorer PathBlock path) ----
#
# Exact closed forms of the scalar scans above, derived from their
# running-minimum structure so a 165k-path comb=15 cluster selects from
# numpy arrays without materializing per-path objects.  Fuzz-tested
# against the scalar versions (tests/test_selectors.py).

def _allmiss_arr(nm: np.ndarray, lens: np.ndarray, k: int) -> np.ndarray:
    """Vector form of _all_missing: numM == (size_t)(len - k + 1).
    nm >= 0, so the size_t wrap (len < k - 1) can never compare equal."""
    span = lens - k + 1
    return (span >= 0) & (nm == span)


def _min_missing_idxs_plain_arr(nm, lens, k) -> tuple[np.ndarray, int]:
    """Closed form of _min_missing_idxs_plain (the bestVariant scan,
    varMer.C:406-421): the survivors of a strict-decrease-clears /
    equality-appends scan are exactly the positions achieving the
    overall minimum, in order.  Returns (idxs, num_missing) with
    num_missing == UINT32_MAX when every path is all-missing."""
    ok_idx = np.flatnonzero(~_allmiss_arr(nm, lens, k))
    if ok_idx.size == 0:
        return np.zeros(0, np.int64), 0xFFFFFFFF
    vals = nm[ok_idx]
    m = int(vals.min())
    if m >= 0xFFFFFFFF:
        # paths pushed at the UINT32_MAX sentinel never lower numMissing
        return ok_idx[vals == m].astype(np.int64), 0xFFFFFFFF
    return ok_idx[vals == m].astype(np.int64), m


def _min_missing_idxs_filterlike_arr(nm, lens, k) -> np.ndarray:
    """Closed form of _min_missing_idxs_filterlike (int64 array).

    The scalar scan resets idxs only on a STRICT decrease, and the
    numM==0 block sets num_missing to 0 *before* the < test, so zero
    paths never reset — each zero path appends twice (both blocks fire)
    and the achievers of the pre-zero running minimum survive in front.
    """
    ok_idx = np.flatnonzero(~_allmiss_arr(nm, lens, k))
    if ok_idx.size == 0:
        return np.zeros(0, np.int64)
    vals = nm[ok_idx]
    zeros = np.flatnonzero(vals == 0)
    if zeros.size == 0:
        m = vals.min()
        return ok_idx[vals == m].astype(np.int64)
    parts = []
    z0 = zeros[0]
    if z0 > 0:
        pre = vals[:z0]
        parts.append(ok_idx[:z0][pre == pre.min()])
    parts.append(np.repeat(ok_idx[zeros], 2))   # the double-push quirk
    return np.concatenate(parts).astype(np.int64)


def _min_missing_idxs_vs_ref_arr(nm, include_neutral: bool) -> np.ndarray:
    """Closed form of _min_missing_idxs_vs_ref (int64 array): a strict
    decrease below scores[0].num_m resets, equals-at-minimum append
    (gated by the neutral rule); if nothing beats the REF path, only
    the neutral rule can populate idxs."""
    if nm.size == 0:
        return np.zeros(0, np.int64)
    ref = nm[0]
    m = nm.min()
    if m < ref:
        return np.flatnonzero(nm == m).astype(np.int64)
    if include_neutral:
        return np.flatnonzero(nm == ref).astype(np.int64)
    return np.zeros(0, np.int64)


def select_block(mode: str, nm: np.ndarray, td: np.ndarray,
                 lens: np.ndarray, gtp: np.ndarray, pos_gt: PosGT,
                 k: int, log=sys.stderr):
    """Per-cluster selection from score arrays (num_m, totdk) and the
    block's (lens, gtp) — mirrors _select_task over PathScore lists.
    gtp rows index pos_gt.gts exactly like VarPath.gt_path."""
    if mode == "filter":
        idxs = _min_missing_idxs_filterlike_arr(nm, lens, k)
        if idxs.size == 0:
            return []
        gt_idxs = np.unique(np.nonzero(gtp[idxs] > 0)[1])
        return [pos_gt.gts[int(i)].record for i in gt_idxs]

    if mode == "polish":
        # plain bestVariant scan — no zero double-push (varMer.C:406-424)
        idxs, num_missing = _min_missing_idxs_plain_arr(nm, lens, k)
        if num_missing == 0xFFFFFFFF:
            return ""
        if idxs.size == 1:
            return get_hom_record(pos_gt, gtp[idxs[0]])
        # stable descending sort by INT-TRUNCATED totdk (varMer.H:72):
        # order[0]/order[1] are the first occurrence of the max int key
        # and the next element in that ordering — closed form, no sort
        tdv = td[idxs]
        tdi = tdv.astype(np.int64)       # truncates toward zero, like int()
        at_max = np.flatnonzero(tdi == tdi.max())
        i1 = int(at_max[0])
        if at_max.size >= 2:
            i2 = int(at_max[1])
        else:
            rest = tdi[tdi != tdi[i1]]
            i2 = int(np.flatnonzero(tdi == rest.max())[0])
        avg_k1, idx1 = float(tdv[i1]), int(idxs[i1])
        avg_k2, idx2 = float(tdv[i2]), int(idxs[i2])
        if avg_k1 == avg_k2:
            if lens[idx1] >= lens[idx2]:
                return get_het_record(pos_gt, gtp[idx1], gtp[idx2])
            return get_het_record(pos_gt, gtp[idx2], gtp[idx1])
        return get_hom_record(pos_gt, gtp[idx1])

    if mode in ("better", "strict"):
        idxs = _min_missing_idxs_vs_ref_arr(nm, include_neutral=False)
        if idxs.size == 0:
            return ""
        # first-occurrence max length (the scan replaces only on >)
        best = int(idxs[np.argmax(lens[idxs])])
        return get_hom_record(pos_gt, gtp[best])

    assert mode == "loose"
    idxs = _min_missing_idxs_vs_ref_arr(nm, include_neutral=True)
    if idxs.size == 0:
        return ""
    if idxs.size == 1:
        return get_hom_record(pos_gt, gtp[idxs[0]])
    if idxs[0] == 0 and idxs.size == 2:
        return get_hom_record(pos_gt, gtp[idxs[1]])
    # first-occurrence max ALT count over idxs[1:], but only a count > 0
    # replaces the initial idxs[0] (the scan starts at max_vars = 0)
    counts = (gtp[idxs[1:]] > 0).sum(axis=1)
    max_vars = int(counts.max()) if counts.size else 0
    max_idx = int(idxs[1 + np.argmax(counts)]) if max_vars > 0 else int(idxs[0])
    rec = pos_gt.gts[0].record.save()
    print(f"[ WARNING ] :: Multiple ({idxs.size}) alternate pathes detected in a "
          f"path beginning with variant : {rec}", end="", file=log)
    print(f"[ WARNING ] :: Max. {max_vars} ALT variants selected", file=log)
    return get_hom_record(pos_gt, gtp[max_idx])


# ---- debug statistics (varMer.C:553-659) ----

def min_abs_k(score: PathScore) -> float:
    vals = score.kstr[score.kstr >= 0]
    return float(vals.min()) if vals.size else -1.0


def max_abs_k(score: PathScore) -> float:
    """Max over ALL entries incl. -1 markers; -2 if empty (varMer.C:572-585)."""
    return float(score.kstr.max()) if score.kstr.size else -2.0


def avg_abs_k(score: PathScore) -> float:
    n = score.kstr.size
    if n == score.num_m:
        return -1.0
    s = float(score.kstr[score.kstr >= 0].sum())
    return s / (n - score.num_m)


def med_abs_k(score: PathScore) -> float:
    """Median of non-negative entries, reference indexing (varMer.C:608-624)."""
    kstr = np.sort(score.kstr)
    i = int(np.searchsorted(kstr, 0.0, side="left"))
    n = kstr.size
    if i == n:
        return -1.0
    return float(kstr[i + (n - i) // 2])
