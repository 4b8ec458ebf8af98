"""The single-value sorted join: one u32 value for each sorted query.

Port of ``merfin_tpu/ops/join_kernel4.py`` (``SortJoinTableV4``,
``join_sorted_rec``, ``build_rec_np``'s contract) and of its CPU stand-in
``merfin_tpu/ops/sortjoin.py:_JnpSortJoin``.  -completeness probes the
assembly DB with the read DB's sorted keys through it.

Layout: sorted unique keys (u64 bit patterns in int64) and values (u32
bit patterns in int32), structure of arrays, and the fence index of
``ops/union_join.py`` (every 16th key); the TPU's u8 byte planes, fence
rows and segment index existed only to make bf16 MXU products exact and
to narrow each block's segments.

``SortedJoinTable.lookup_sorted`` dispatches on the query's device: a
CUDA tensor launches the windowed kernel (``csrc/union_join.cu``,
``merfin_sorted_join``) or raises; a CPU tensor runs the plain PyTorch
version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from merfin_tpu_torch.ops import _build
from merfin_tpu_torch.ops.kmer_ops import bias
from merfin_tpu_torch.ops.union_join import (FencedJoinKernel, fence_index,
                                             probe_plain)

_VP = ctypes.c_void_p


def lookup_plain(keys, vals, q, keys_biased=None):
    """Plain PyTorch single-value join (the ``_JnpSortJoin`` probe):
    searchsorted + clamp + equality + gather; int32 u32 bit patterns."""
    if keys.shape[0] == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    idx, hit = probe_plain(keys, q, keys_biased)
    return torch.where(hit, vals[idx],
                       torch.zeros((), dtype=torch.int32, device=q.device))


class SortedJoinKernel(FencedJoinKernel):
    """ctypes wrapper of ``csrc/union_join.cu:merfin_sorted_join``."""

    name = "sorted_join"
    symbol = "merfin_sorted_join"
    replaces = "merfin_tpu/ops/join_kernel4.py:33"
    argtypes = [_VP, _VP, ctypes.c_longlong, _VP, _VP, ctypes.c_longlong,
                _VP, _VP, _VP]

    def __call__(self, keys, vals, fences, q):
        self.check(q, (keys, torch.int64), (vals, torch.int32),
                   (fences, torch.int64), (q, torch.int64))
        n, m = keys.shape[0], q.shape[0]
        if vals.shape[0] != n:
            raise ValueError(f"{self.name}: values must match keys")
        out = torch.empty(m, dtype=torch.int32, device=q.device)
        if m == 0:
            return out
        win = self.windows(keys, fences, q)
        self.launch(keys.data_ptr(), vals.data_ptr(), n, fences.data_ptr(),
                    q.data_ptr(), m, out.data_ptr(), win.data_ptr(),
                    _build.raw_stream(q.device))
        return out


sorted_join_kernel = SortedJoinKernel()


class SortedJoinTable:
    """A single-value table on one device, probed by the windowed join.

    ``keys``/``vals``: host arrays, keys sorted ascending and unique."""

    kernel = sorted_join_kernel
    unique_keys = True

    def __init__(self, keys, vals, device):
        # copies: torch takes no read-only (memmapped) array
        keys = np.array(keys, np.uint64)
        vals = np.array(vals, np.uint32)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError("keys and values must be 1-D and aligned")
        step = keys[1:] > keys[:-1] if self.unique_keys \
            else keys[1:] >= keys[:-1]
        if not step.all():
            raise ValueError(f"{type(self).__name__}: keys must be sorted"
                             + (" and unique" if self.unique_keys else ""))
        self.n = int(keys.size)
        self.device = torch.device(device)
        self.keys = torch.from_numpy(keys.view(np.int64)).to(self.device)
        self.vals = torch.from_numpy(vals.view(np.int32)).to(self.device)
        self.index = self._index(self.keys, self.vals)
        self._aux = None

    def tree(self):
        return (self.keys, self.vals)

    def nbytes(self) -> int:
        return self.n * 12 + self.index.numel() * self.index.element_size()

    # the kernel's table-side index (built once, on the table's device):
    # here the fence index
    def _index(self, keys, vals):
        return fence_index(keys)

    def _index_of(self, keys, vals):
        """The table's own index for its own tree, else one built for the
        foreign (keys, vals)."""
        if keys is self.keys and vals is self.vals:
            return self.index
        return self._index(keys, vals)

    def _kernel(self, keys, vals, q):
        return self.kernel(keys, vals, self._index_of(keys, vals), q)

    # the plain version; ``aux`` is what it precomputes from the table
    def _plain_aux(self, keys, vals):
        return bias(keys)

    def _plain(self, keys, vals, q, aux):
        return lookup_plain(keys, vals, q, aux)

    def lookup_plain(self, q):
        if self._aux is None:
            self._aux = self._plain_aux(self.keys, self.vals)
        return self._plain(self.keys, self.vals, q, self._aux)

    def lookup_sorted(self, q):
        return self.lookup_sorted_with(self.tree(), q)

    def lookup_sorted_with(self, tree, q):
        """u32 bit patterns (int32) for a SORTED int64 query stream (u64
        order, any length); 0 for misses and u64::MAX sentinels."""
        keys, vals = tree
        if q.is_cuda:
            return self._kernel(keys, vals, q)
        if keys is self.keys:
            return self.lookup_plain(q)
        return self._plain(keys, vals, q, self._plain_aux(keys, vals))
