"""Variant-cluster path enumeration — exact traverse() semantics.

Reference: merfin-variants.C:22-126 (recursive REF/ALT product with
overlap skipping and index shifting) plus varMer::addSeqPath dedup
(varMer.C:38-45, first-seen sequence wins).

The enumeration happens on the host (it is irregular, string-based and
tiny per cluster); the resulting candidate set is scored as one padded
batch on device.  Preserved quirks:

  * When an ALT replacement covers later variant positions, those
    variants are force-skipped with the REF allele and their stored
    positions are NOT shifted by the replacement delta
    (merfin-variants.C:72-96, "refIdx in overlaps should remain").
  * When the skip runs off the end of the cluster, the path is recorded
    without shifting later indices at all (merfin-variants.C:83-93).
  * A variant with an empty allele list (e.g. a "./." record) yields zero
    iterations at its position, so the whole cluster produces no paths.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class VarPath:
    seq: str                 # candidate window sequence
    gt_path: list[int]       # allele index per variant (0 = REF)
    idx_path: list[int]      # variant start offsets within seq (possibly shifted)
    len_path: list[int]      # allele length per variant along this path


def enumerate_paths(
    template: str,
    ref_idx_list: list[int],
    ref_len_list: list[int],
    haps: list[list[str]],
) -> list[VarPath]:
    """All REF/ALT combination windows for one cluster.

    template      — the reference window (rStart..rEnd padded by k-1)
    ref_idx_list  — variant start offsets within the window
    ref_len_list  — REF allele lengths
    haps[i]       — allele strings for variant i; haps[i][0] is REF
    """
    paths: list[VarPath] = []
    seen: set[str] = set()

    def add(seq: str, gt: list[int], idxs: list[int], lens: list[int]) -> None:
        if seq in seen:
            return
        seen.add(seq)
        paths.append(VarPath(seq, list(gt), list(idxs), list(lens)))

    n = len(ref_idx_list)
    if n == 0:
        return paths

    ref_idx = list(ref_idx_list)     # shared, mutated and restored (a C++ reference)
    path: list[int] = []             # shared gt path stack

    def traverse(idx: int, ref_len: list[int], candidate: str) -> None:
        # ref_len is passed BY VALUE in the reference (fresh copy per frame).
        ref_len = list(ref_len)
        hap_list = haps[idx]
        ref_len_orig = ref_len[idx]

        for j in range(len(hap_list)):
            path.append(j)
            hap = hap_list[j]
            replaced = candidate
            skipped = 0
            overlaps = False
            delta = 0
            cur = idx                # 'idx' is mutated in the reference frame

            if j > 0:
                ref_len[idx] = ref_len_orig
                a = ref_idx[idx]
                replaced = candidate[:a] + hap + candidate[a + ref_len[idx]:]
                delta = len(hap) - ref_len[idx]
                ref_affected = ref_idx[idx] + ref_len[idx]
                ref_len[idx] = len(hap)

                # Force-skip later variants whose start lies inside the
                # replaced region (their positions are NOT shifted).
                i = cur + 1
                while i < n:
                    if ref_idx[i] >= ref_affected:
                        break
                    overlaps = True
                    cur += 1
                    path.append(0)
                    skipped += 1
                    i += 1

                if overlaps and cur == n - 1:
                    add(replaced, path, ref_idx, ref_len)
                    for _ in range(skipped):
                        path.pop()
                    path.pop()
                    continue

                for i in range(cur + 1, n):
                    ref_idx[i] += delta

            if cur + 1 < n:
                traverse(cur + 1, ref_len, replaced)

            if cur == n - 1:
                add(replaced, path, ref_idx, ref_len)

            for i in range(cur + 1, n):
                ref_idx[i] -= delta

            for _ in range(skipped):
                path.pop()

            path.pop()

    traverse(0, ref_len_list, template)
    return paths
