"""The union sorted join: one probe returns (read, asm) for each query.

Port of ``merfin_tpu/ops/join_kernel4.py`` (``SortJoinUnionV4``,
``join_sorted_rec2``, ``union_merge_np``) and of its CPU stand-in
``merfin_tpu/ops/sortjoin.py:_JnpSortJoin2``.  Every getK needs both DB
values of the same canonical mer (merfin-globals.C:101-110), so the two
DBs merge into ONE key-sorted table with two value columns.

Layout: sorted unique keys (u64 bit patterns in int64) plus read and asm
values (u32 bit patterns in int32), structure of arrays, and a fence
index (every ``FENCE_STRIDE``-th key) that the kernel searches first.
The TPU's u8 byte planes are not carried over: they existed only to make
bf16 MXU products exact.

``UnionTable.lookup2_sorted`` dispatches on the query's device: a CUDA
tensor launches the hand-written kernel (``csrc/union_join.cu``) or
raises; a CPU tensor runs the plain PyTorch version.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from merfin_tpu_torch.ops import _build
from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias

_VP = ctypes.c_void_p

# keys a leaf of the fence index: csrc/union_join.cu's F (one 128-byte
# line of keys); the kernel wrapper checks the two agree
FENCE_STRIDE = 16


def fence_index(keys: torch.Tensor) -> torch.Tensor:
    """keys[::FENCE_STRIDE], contiguous, on the keys' device."""
    return keys[::FENCE_STRIDE].contiguous()


def union_merge_np(keys_a, vals_a, keys_b, vals_b):
    """Merge two sorted-unique (keys, vals) DBs into union keys + two
    aligned value columns (0 where a DB lacks the key).

    Same result as the JAX package's ``union_merge_np``; the two sorted
    runs are merged by one stable argsort (a single timsort merge)
    instead of a union sort plus two searchsorted passes."""
    keys_a = np.asarray(keys_a, np.uint64)
    keys_b = np.asarray(keys_b, np.uint64)
    na = keys_a.size
    both = np.concatenate([keys_a, keys_b])
    order = np.argsort(both, kind="stable")
    ks = both[order]
    del both
    first = np.ones(ks.size, bool)
    first[1:] = ks[1:] != ks[:-1]
    keys = ks[first]
    del ks
    slot = np.cumsum(first) - 1
    va = np.zeros(keys.size, np.uint32)
    vb = np.zeros(keys.size, np.uint32)
    from_a = order < na
    va[slot[from_a]] = np.asarray(vals_a, np.uint32)[order[from_a]]
    from_b = ~from_a
    vb[slot[from_b]] = np.asarray(vals_b, np.uint32)[order[from_b] - na]
    return keys, va, vb


def u32_to_int64(x: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns held in int32 -> their int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def probe_plain(keys, q, keys_biased=None):
    """Plain sorted-join probe: (index of the first key >= q, clamped into
    the table; hit mask).  Sentinels never hit.  ``keys_biased`` is
    ``bias(keys)``, precomputed by callers that probe many times."""
    n = keys.shape[0]
    if keys_biased is None:
        keys_biased = bias(keys)
    idx = torch.searchsorted(keys_biased, bias(q)).clamp_(max=n - 1)
    return idx, (keys[idx] == q) & (q != U64_MAX)


def lookup2_plain(keys, read_vals, asm_vals, q, keys_biased=None):
    """Plain PyTorch union join (the ``_JnpSortJoin2`` probe):
    searchsorted + clamp + equality + gather."""
    if keys.shape[0] == 0:
        z = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        return z, z.clone()
    idx, hit = probe_plain(keys, q, keys_biased)
    zero = torch.zeros((), dtype=torch.int32, device=q.device)
    return (torch.where(hit, read_vals[idx], zero),
            torch.where(hit, asm_vals[idx], zero))


class FencedJoinKernel(_build.Kernel):
    """An entry of ``csrc/union_join.cu``'s windowed template: its tile
    and fence geometry, the fence-index check and the window scratch."""

    lib = "union_join"
    source = "merfin_tpu_torch/csrc/union_join.cu"
    init = "merfin_join_init"
    configs = "merfin_join_config"
    config_keys = ("tile", "fence", "smem", "fences_per_query")

    def config(self) -> dict:
        cfg = super().config()
        if cfg["fence"] != FENCE_STRIDE:
            raise RuntimeError(f"{self.name}: the library's fence stride "
                               f"{cfg['fence']} != {FENCE_STRIDE}")
        return cfg

    def windows(self, keys, fences, q):
        """Check the fence index against ``keys``; the int64 window
        scratch (two entries a tile of queries)."""
        if fences.shape[0] != -(-keys.shape[0] // FENCE_STRIDE):
            raise ValueError(f"{self.name}: fence index has "
                             f"{fences.shape[0]} entries for "
                             f"{keys.shape[0]} keys")
        if keys.data_ptr() % 16 or fences.data_ptr() % 16:
            raise ValueError(f"{self.name}: keys and fences must be "
                             f"16-byte aligned")
        self.build()
        tiles = -(-q.shape[0] // self.config()["tile"])
        return torch.empty(2 * tiles, dtype=torch.int64, device=q.device)


class UnionJoinKernel(FencedJoinKernel):
    """ctypes wrapper of ``csrc/union_join.cu:merfin_union_join``."""

    name = "union_join"
    symbol = "merfin_union_join"
    replaces = "merfin_tpu/ops/join_kernel4.py:264"
    argtypes = [_VP, _VP, _VP, ctypes.c_longlong, _VP, _VP,
                ctypes.c_longlong, _VP, _VP, _VP, _VP]

    def __call__(self, keys, read_vals, asm_vals, fences, q):
        self.check(q, (keys, torch.int64), (read_vals, torch.int32),
                   (asm_vals, torch.int32), (fences, torch.int64),
                   (q, torch.int64))
        n, m = keys.shape[0], q.shape[0]
        if read_vals.shape[0] != n or asm_vals.shape[0] != n:
            raise ValueError("union_join: value columns must match keys")
        out_r = torch.empty(m, dtype=torch.int32, device=q.device)
        out_a = torch.empty(m, dtype=torch.int32, device=q.device)
        if m == 0:
            return out_r, out_a
        win = self.windows(keys, fences, q)
        self.launch(keys.data_ptr(), read_vals.data_ptr(),
                    asm_vals.data_ptr(), n, fences.data_ptr(), q.data_ptr(),
                    m, out_r.data_ptr(), out_a.data_ptr(), win.data_ptr(),
                    _build.raw_stream(q.device))
        return out_r, out_a


union_join_kernel = UnionJoinKernel()


class UnionTable:
    """The union table on one device."""

    def __init__(self, keys, read_vals, asm_vals, device):
        keys = np.ascontiguousarray(keys, np.uint64)
        self.n = int(keys.size)
        self.device = torch.device(device)
        self.keys = torch.from_numpy(keys.view(np.int64)).to(self.device)
        self.read_vals = torch.from_numpy(
            np.ascontiguousarray(read_vals, np.uint32).view(np.int32)
        ).to(self.device)
        self.asm_vals = torch.from_numpy(
            np.ascontiguousarray(asm_vals, np.uint32).view(np.int32)
        ).to(self.device)
        # the kernel's table-side index: the fence index
        self.index = fence_index(self.keys)
        self._keys_biased = None

    @classmethod
    def from_dbs(cls, keys_a, vals_a, keys_b, vals_b, device):
        return cls(*union_merge_np(keys_a, vals_a, keys_b, vals_b), device)

    def nbytes(self) -> int:
        return self.n * 16 + self.index.shape[0] * 8

    def lookup2_plain(self, q):
        if self._keys_biased is None:
            self._keys_biased = bias(self.keys)
        return lookup2_plain(self.keys, self.read_vals, self.asm_vals, q,
                             self._keys_biased)

    def lookup2_sorted(self, q):
        """(read, asm) u32 bit patterns (int32) for a SORTED int64 query
        stream (u64 order); (0, 0) for misses and u64::MAX sentinels."""
        if q.is_cuda:
            return union_join_kernel(self.keys, self.read_vals,
                                     self.asm_vals, self.index, q)
        return self.lookup2_plain(q)
