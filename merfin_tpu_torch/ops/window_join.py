"""The window join: v1's and v5's single-value sorted join.

Port of ``merfin_tpu/ops/join_kernel.py`` (``SortJoinTable``) and
``merfin_tpu/ops/join_kernel5.py`` (``SortJoinTableV5``), which compute
one function: for each query of a sorted u64 stream, the u32 sum of the
values of the equal table keys (wrapping, as their int32 sums cast to
u32), 0 where there is none.  v5 differs from v1 only in a TPU query
layout, so both entry points sit on one table and one kernel,
``csrc/window_join.cu``.  The table keeps, beside its keys and values,
the wrapped u32 prefix column of the values (its kernel-side index, built
once), so the kernel answers a run of equal keys of any length with two
prefix entries.  Each tile of sorted queries finds its table window by a
warp-wide 32-ary search and streams it through shared memory in chunks
that load while the previous one is merged; a tile whose window is wide
for its queries searches device memory instead.

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


def prefix_u32(vals):
    """The kernel's index: int32 [n + 1] bit patterns of the running sums
    of u32 values, wrapped mod 2^32 (entry i sums vals[:i])."""
    return (prefix_sums(vals) & 0xFFFFFFFF).to(torch.int32)


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
    init = "merfin_window_init"
    source = "merfin_tpu_torch/csrc/window_join.cu"
    replaces = "merfin_tpu/ops/join_kernel.py:32"
    argtypes = [_VP, _VP, ctypes.c_longlong, _VP, ctypes.c_longlong, _VP,
                _VP, _VP]
    # queries a tile, keys a shared-memory stage, and the keys a query
    # above which a tile's window is searched in device memory
    configs = "merfin_window_config"
    config_keys = ("tile", "chunk", "wide")

    def __call__(self, keys, pre, q):
        self.check(q, (keys, torch.int64), (pre, torch.int32),
                   (q, torch.int64))
        n, m = keys.shape[0], q.shape[0]
        if pre.shape[0] != n + 1:
            raise ValueError(f"{self.name}: prefix column has "
                             f"{pre.shape[0]} entries for {n} keys")
        if m == 0:
            return torch.empty(0, dtype=torch.int32, device=q.device)
        # one allocation: the output, then (16-byte aligned) the window
        # scratch, an int64 bound for each tile of queries and one more
        at = -(-m // 4) * 4
        buf = torch.empty(at + 2 * (-(-m // self.config()["tile"]) + 1),
                          dtype=torch.int32, device=q.device)
        self.launch(keys.data_ptr(), pre.data_ptr(), n, q.data_ptr(), m,
                    buf.data_ptr(), buf.data_ptr() + 4 * at,
                    _build.raw_stream(q.device))
        return buf[:m]


window_join_kernel = WindowJoinKernel()


class SortJoinTable(SortedJoinTable):
    """v1's table (``tree()``, ``lookup_sorted``, ``lookup_sorted_with``)
    on the window-join kernel.  Keys sorted; equal keys are allowed and
    their values sum.  Its index is the wrapped prefix column of the
    values (4 bytes a key, 16 in all: the values stay for ``tree()`` and
    the plain version)."""

    kernel = window_join_kernel
    unique_keys = False

    def _index(self, keys, vals):
        return prefix_u32(vals)

    def _kernel(self, keys, vals, q):
        return self.kernel(keys, self._index_of(keys, vals), q)

    def _plain_aux(self, keys, vals):
        return bias(keys), prefix_sums(vals)

    def _plain(self, keys, vals, q, aux):
        return lookup_plain(keys, vals, q, *aux)


class SortJoinTableV5(SortJoinTable):
    """v5's entry points: v1's table and contract, the same kernel."""
