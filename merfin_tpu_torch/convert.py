"""State of the JAX package, as numpy arrays, in the port's form.

* The union table, from either JAX form:
  - ``_JnpSortJoin2.tree()`` -> (keys, read, asm), already the port's
    structure of arrays;
  - ``SortJoinUnionV4``'s ``rec``/``seg_first`` -> decode the big-endian
    byte planes of ``build_rec2_np`` (merfin_tpu/ops/join_kernel4.py:
    354-395) back to keys and values and drop the pads.
* The single-value tables:
  - ``_JnpSortJoin.tree()`` -> (keys, vals);
  - ``SortJoinTable.tree()`` / ``SortJoinTableV5.tree()`` (v1/v5: u32
    hi/lo/value planes and ``keys_u64``) -> keys, the first n values;
  - ``SortJoinTableV4``'s ``rec``/``seg_first`` -> decode the 8 key and
    4 value byte planes of ``build_rec_np`` (join_kernel4.py:128-171).
* A JAX ``DeviceScorer``'s union table (``_sj_union``, either form
  above) -> the same three arrays.
* A gather table: ``DeviceLookup``'s bucket geometry (bits, shift,
  rows, strategy, search steps), its padded keys and values and its
  offsets -> the port's ``DeviceLookup`` with the same state.
* The value map and the bin tables: the host arrays of
  ``ValueMap``/``BinTable`` as they are, placed on the device; the
  scorer flavour of the value map (``ValueMap.device_arrays_scorer``)
  carries readK as int32 when the integer fast path holds.
"""

from __future__ import annotations

import numpy as np
import torch

from merfin_tpu_torch.table.lookup import DeviceLookup

# join_kernel4.py's record geometry (8 key planes then 4 bytes for each
# u32 value column, of 64 rows x 128 lanes per 8192-key segment, then 8
# fence rows)
SEG_ROWS = 64
LANES = 128
N_KEY_PLANES = 8
PAD_KEY = np.uint64(0x7FFFFFFF_FFFFFFFF)


def union_from_tree(tree):
    """``_JnpSortJoin2.tree()`` -> (keys u64, read u32, asm u32)."""
    keys, va, vb = (np.asarray(x) for x in tree)
    return (keys.astype(np.uint64), va.astype(np.uint32),
            vb.astype(np.uint32))


def single_from_tree(tree):
    """``_JnpSortJoin.tree()`` (keys, vals) or a v1/v5 ``tree()``
    (t_hi, t_lo, t_v, keys_u64) -> (keys u64, vals u32)."""
    if len(tree) == 2:
        keys, vals = (np.asarray(x) for x in tree)
    else:
        keys = np.asarray(tree[3])
        vals = np.asarray(tree[2]).reshape(-1)[: keys.size]
    return keys.astype(np.uint64), vals.astype(np.uint32)


def decode_rec(rec, n_vals: int, seg_first=None, n: int | None = None):
    """v4 records with ``n_vals`` u32 value columns -> (keys u64, u32
    column, ...).

    ``n`` is the real key count (the table's ``n``); without it the
    trailing pad entries (pad key, every value 0) are dropped.
    ``seg_first`` is only checked against the decoded keys."""
    rec = np.asarray(rec)
    n_planes = N_KEY_PLANES + 4 * n_vals
    n_segs = rec.shape[0]
    planes = rec[:, : n_planes * SEG_ROWS, :].reshape(
        n_segs, n_planes, SEG_ROWS * LANES)
    planes = planes.transpose(1, 0, 2).reshape(n_planes, -1).astype(np.uint32)

    def word(p0):        # four big-endian byte planes -> u32
        return ((planes[p0] << 24) | (planes[p0 + 1] << 16)
                | (planes[p0 + 2] << 8) | planes[p0 + 3])

    keys = (word(0).astype(np.uint64) << np.uint64(32)) | word(4)
    vals = [word(N_KEY_PLANES + 4 * j) for j in range(n_vals)]
    if n is None:
        pad = keys == PAD_KEY
        for v in vals:
            pad &= v == 0
        real = np.flatnonzero(~pad)
        n = int(real[-1]) + 1 if real.size else 0
    keys = keys[:n]
    if seg_first is not None and n:
        seg_first = np.asarray(seg_first, np.uint64)
        real = keys[:: SEG_ROWS * LANES]
        assert np.array_equal(seg_first[: real.size], real)
    return (keys, *(v[:n] for v in vals))


def union_from_rec2(rec, seg_first=None, n: int | None = None):
    """``SortJoinUnionV4`` records -> (keys u64, read u32, asm u32)."""
    return decode_rec(rec, 2, seg_first, n)


def union_from_device_scorer(scorer):
    """A JAX ``DeviceScorer(..., sortjoin=True)``'s union table ->
    (keys u64, read u32, asm u32)."""
    u = scorer._sj_union
    if hasattr(u, "rec"):                  # SortJoinUnionV4
        return union_from_rec2(np.asarray(u.rec), np.asarray(u.seg_first),
                               n=u.n)
    return union_from_tree(u.tree())       # _JnpSortJoin2


def single_from_rec(rec, seg_first=None, n: int | None = None):
    """``SortJoinTableV4`` records -> (keys u64, vals u32)."""
    return decode_rec(rec, 1, seg_first, n)


def device_lookup_from_jax(lookup, device) -> DeviceLookup:
    """A JAX ``DeviceLookup`` -> the port's, with its buckets, strategy
    and padding as they are (not rebuilt), placed lazily on ``device``."""
    port = DeviceLookup.__new__(DeviceLookup)
    for name in ("k", "n", "window", "strategy", "bits", "shift", "rows",
                 "windowed", "search_iters", "nblocks"):
        setattr(port, name, getattr(lookup, name))
    port.device = torch.device(device)
    keys, vals, offsets = (np.asarray(x) for x in lookup.tree())
    port._host = (np.array(keys, np.uint64).view(np.int64),
                  np.array(vals, np.uint32).view(np.int32),
                  np.array(offsets, np.int32))
    port._tree = None
    port.keys_np = np.asarray(lookup.keys_np, np.uint64)
    port.vals_np = np.asarray(lookup.vals_np, np.uint32)
    return port


def value_map_tensors(value_map, device):
    """(read_k f64 [vcap+1], prob f64 [vcap+1]) of a ValueMap."""
    return (torch.from_numpy(np.ascontiguousarray(
                value_map.read_k_host, np.float64)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                value_map.prob_host, np.float64)).to(device))


def value_map_scorer_tensors(value_map, device):
    """(readK, prob f64) for the fused variant scorer: readK int32 when
    ``value_map.int_scorer_ok()`` (the integer fast path), else f64."""
    read_k, prob = value_map_tensors(value_map, device)
    if value_map.int_scorer_ok():
        read_k = torch.from_numpy(
            value_map.read_k_host.astype(np.int32)).to(device)
    return read_k, prob


def bin_table_tensors(bin_table, device):
    """(undr, over) int32 [(rmax+1)*(amax+1)] of a BinTable."""
    return (torch.from_numpy(np.ascontiguousarray(
                bin_table.undr_host.reshape(-1), np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                bin_table.over_host.reshape(-1), np.int32)).to(device))
