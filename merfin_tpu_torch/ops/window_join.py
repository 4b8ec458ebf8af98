"""The window join: v1's and v5's single-value sorted join.

Port of ``merfin_tpu/ops/join_kernel.py`` (``SortJoinTable``) and
``merfin_tpu/ops/join_kernel5.py`` (``SortJoinTableV5``), which compute
one function: for each query of a sorted u64 stream, the u32 sum of the
values of the equal table keys (wrapping, as their int32 sums cast to
u32), 0 where there is none.  v5 differs from v1 only in a TPU query
layout, so both entry points sit on one table and one kernel,
``csrc/window_join.cu``: each block of 1024 sorted queries streams its
table window through shared memory.  Its cost is linear in the window,
so the table builder gives it only dense query streams
(``ops/sortjoin.py``).

A CUDA query tensor launches the kernel or raises; a CPU tensor runs the
plain PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from merfin_tpu_torch.ops import _build
from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias
from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
from merfin_tpu_torch.ops.union_join import u32_to_int64

_VP = ctypes.c_void_p


def prefix_sums(vals):
    """int64 [n + 1] running sums of u32 values (the plain version's
    table-side precomputation)."""
    z = torch.zeros(1, dtype=torch.int64, device=vals.device)
    return torch.cat([z, torch.cumsum(u32_to_int64(vals), 0)])


def lookup_plain(keys, vals, q, keys_biased=None, csum=None):
    """Plain PyTorch window join: the equal-key run [lo, hi) of every
    query by two searchsorted passes, its value sum by prefix sums, cut
    to u32 (int32 bit patterns); sentinels answer 0."""
    if keys.shape[0] == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    kb = bias(keys) if keys_biased is None else keys_biased
    cs = prefix_sums(vals) if csum is None else csum
    qb = bias(q)
    s = cs[torch.searchsorted(kb, qb, right=True)] - cs[torch.searchsorted(kb, qb)]
    s = torch.where(q != U64_MAX, s, torch.zeros((), dtype=torch.int64,
                                                 device=q.device))
    return (s & 0xFFFFFFFF).to(torch.int32)


class WindowJoinKernel(_build.Kernel):
    """ctypes wrapper of ``csrc/window_join.cu:merfin_window_join``."""

    name = lib = "window_join"
    symbol = "merfin_window_join"
    source = "merfin_tpu_torch/csrc/window_join.cu"
    replaces = "merfin_tpu/ops/join_kernel.py:32"
    argtypes = [_VP, _VP, ctypes.c_longlong, _VP, ctypes.c_longlong, _VP,
                _VP]

    def __call__(self, keys, vals, q):
        self.check(q, (keys, torch.int64), (vals, torch.int32),
                   (q, torch.int64))
        n, m = keys.shape[0], q.shape[0]
        if vals.shape[0] != n:
            raise ValueError(f"{self.name}: values must match keys")
        out = torch.empty(m, dtype=torch.int32, device=q.device)
        if m == 0:
            return out
        self.launch(keys.data_ptr(), vals.data_ptr(), n, q.data_ptr(), m,
                    out.data_ptr(),
                    torch.cuda.current_stream(q.device).cuda_stream)
        return out


window_join_kernel = WindowJoinKernel()


class SortJoinTable(SortedJoinTable):
    """v1's table (``tree()``, ``lookup_sorted``, ``lookup_sorted_with``)
    on the window-join kernel.  Keys sorted; equal keys are allowed and
    their values sum."""

    kernel = window_join_kernel
    unique_keys = False

    def _index(self, keys):
        return None          # the window join streams its window

    def _kernel(self, keys, vals, q):
        return self.kernel(keys, vals, q)

    def _plain_aux(self, keys, vals):
        return bias(keys), prefix_sums(vals)

    def _plain(self, keys, vals, q, aux):
        return lookup_plain(keys, vals, q, *aux)


class SortJoinTableV5(SortJoinTable):
    """v5's entry points: v1's table and contract, the same kernel."""
