"""State of the JAX package, as numpy arrays, in the port's form.

* The union table, from either JAX form:
  - ``_JnpSortJoin2.tree()`` -> (keys, read, asm), already the port's
    structure of arrays;
  - ``SortJoinUnionV4``'s ``rec``/``seg_first`` -> decode the big-endian
    byte planes of ``build_rec2_np`` (merfin_tpu/ops/join_kernel4.py:
    354-395) back to keys and values and drop the pads.
* The value map and the bin tables: the host arrays of the shared
  ``ValueMap``/``BinTable`` as they are, placed on the device.
"""

from __future__ import annotations

import numpy as np
import torch

# join_kernel4.py's record geometry (8 key + 8 value byte planes of 64
# rows x 128 lanes per 8192-key segment, then 8 fence rows)
SEG_ROWS = 64
LANES = 128
N_PLANES = 16
PAD_KEY = np.uint64(0x7FFFFFFF_FFFFFFFF)


def union_from_tree(tree):
    """``_JnpSortJoin2.tree()`` -> (keys u64, read u32, asm u32)."""
    keys, va, vb = (np.asarray(x) for x in tree)
    return (keys.astype(np.uint64), va.astype(np.uint32),
            vb.astype(np.uint32))


def union_from_rec2(rec, seg_first=None, n: int | None = None):
    """``SortJoinUnionV4`` records -> (keys u64, read u32, asm u32).

    ``n`` is the real key count (``SortJoinUnionV4.n``); without it the
    trailing pad entries (pad key, both values 0) are dropped.
    ``seg_first`` is only checked against the decoded keys."""
    rec = np.asarray(rec)
    n_segs = rec.shape[0]
    planes = rec[:, : N_PLANES * SEG_ROWS, :].reshape(
        n_segs, N_PLANES, SEG_ROWS * LANES)
    planes = planes.transpose(1, 0, 2).reshape(N_PLANES, -1).astype(np.uint32)

    def word(p0):        # four big-endian byte planes -> u32
        return ((planes[p0] << 24) | (planes[p0 + 1] << 16)
                | (planes[p0 + 2] << 8) | planes[p0 + 3])

    keys = (word(0).astype(np.uint64) << np.uint64(32)) | word(4)
    va, vb = word(8), word(12)
    if n is None:
        real = np.flatnonzero(~((keys == PAD_KEY) & (va == 0) & (vb == 0)))
        n = int(real[-1]) + 1 if real.size else 0
    keys, va, vb = keys[:n], va[:n], vb[:n]
    if seg_first is not None and n:
        seg_first = np.asarray(seg_first, np.uint64)
        real = keys[:: SEG_ROWS * LANES]
        assert np.array_equal(seg_first[: real.size], real)
    return keys, va, vb


def value_map_tensors(value_map, device):
    """(read_k f64 [vcap+1], prob f64 [vcap+1]) of a shared ValueMap."""
    return (torch.from_numpy(np.ascontiguousarray(
                value_map.read_k_host, np.float64)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                value_map.prob_host, np.float64)).to(device))


def bin_table_tensors(bin_table, device):
    """(undr, over) int32 [(rmax+1)*(amax+1)] of a shared BinTable."""
    return (torch.from_numpy(np.ascontiguousarray(
                bin_table.undr_host.reshape(-1), np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                bin_table.over_host.reshape(-1), np.int32)).to(device))
