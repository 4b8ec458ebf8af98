"""The multi-device -hist, -completeness and -dump steps (port of
``merfin_tpu/parallel/multichip.py``): chunk rows over the mesh's "d"
axis, table shards over "t".

Each d-row's chunk unpacks, builds its windows and probes every t-shard
(``sharded.dual_probe_local``) on the row's device; the value map,
classification, bins, histograms and kover parts run there with the
single-device engine's functions; the row partials then add over d on
the mesh's first device (``max_idx`` takes the maximum), in the
``zero_hist_state``/``fold_hist_state`` layout.  There is no host sync
per row: inputs come placed on their rows (``sharded.put_global``),
copies between devices are ``non_blocking``, and the caller fetches once.

On a host-spanning mesh a process computes only the rows it holds an
entry of (``Mesh.rows``; a row's probe sums add over its holders), and
only the holder of a row's (r, 0) entry folds that row's partials; the
state then adds over every process once (``reduce_hist_state``, the
completeness step's per-row partials), so it comes out the same on
every process.

Correctness contract: the same function as the single-device engine
(``modes/engine.py``) on hostile inputs too: raw values above the value
map's cap take the counted float fallback, and bins outside the exact
tables the counted float fallback, with the NBINS guard left to the
caller.
"""

from __future__ import annotations

import torch

from merfin_tpu_torch import convert
from merfin_tpu_torch.modes.engine import (NBINS, fold_hist_state,  # noqa: F401  (zero_hist_state for step callers)
                                           seg_counts_by_sort,
                                           two_hist_by_sort,
                                           zero_hist_state)
from merfin_tpu_torch.ops.kmer_ops import (kmer_windows, seg_from_marks,
                                          unpack_transfer)
from merfin_tpu_torch.parallel.sharded import ShardedLookup, dual_probe_local
from merfin_tpu_torch.score import bin_table as bin_ops
from merfin_tpu_torch.score import value_map as vm_ops
from merfin_tpu_torch.score.bin_table import BinTable
from merfin_tpu_torch.score.kover import kover_parts


class _PerDevice:
    """A table's tensors, made on each device at first use."""

    def __init__(self, make):
        self._make = make
        self._by_dev: dict = {}

    def __call__(self, dev):
        if dev not in self._by_dev:
            self._by_dev[dev] = self._make(dev)
        return self._by_dev[dev]


def _row_codes(data, r: int, chunk: int, k: int):
    """Row r's codes from its transfer-packed (planes, vbits)."""
    return unpack_transfer(data[0][r], data[1][r], chunk + k - 1)


def _classify(value_map, vm, read_v, asm_v, valid):
    """getK and the undr/over split (processHistogram)."""
    read_k, prob, overflow = vm_ops.lookup(value_map, read_v, vm)
    zero = torch.zeros((), dtype=torch.float64, device=read_v.device)
    read_k = torch.where(valid, read_k, zero)
    asm_k = torch.where(valid, asm_v.to(torch.float64), zero)
    missing = valid & (read_k == 0)
    is_undr = valid & (read_k > 0) & (asm_k > read_k)
    is_over = valid & (read_k > 0) & ~is_undr
    return read_k, asm_k, prob, overflow, missing, is_undr, is_over


def _hist_parts(mesh, read_lookup, asm_lookup, k, value_map, asm_max_value,
                bin_table, nbins, kover_vmaxp, grouped):
    """The per-row -hist program shared by both steps: row r's codes (and
    seg) -> the 12 hist-state partials on the row's device."""
    bin_table = bin_table or BinTable()
    # even-k palindromes double the probed values (merfin-globals.C:101-110)
    a_max_eff = (asm_max_value * (2 if k % 2 == 0 else 1)
                 if asm_max_value is not None else None)
    vm = _PerDevice(lambda dev: convert.value_map_tensors(value_map, dev))
    bins = _PerDevice(lambda dev: convert.bin_table_tensors(bin_table, dev))

    def row(r, codes, seg=None):
        dev = codes.device
        fmer, rmer, valid = kmer_windows(codes, k)
        # seg rides the probe's sort as a carry
        read_v, asm_v, valid, *seg_s = dual_probe_local(
            read_lookup, asm_lookup, r, fmer, rmer, valid, k,
            carries=(seg,) if grouped else ())
        read_k, asm_k, prob, overflow, missing, is_undr, is_over = \
            _classify(value_map, vm(dev), read_v, asm_v, valid)
        if grouped:
            kasm, kmissing = seg_counts_by_sort(seg_s[0], valid, missing)
        else:
            kasm, kmissing = valid.sum(), missing.sum()
        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, kover_vmaxp,
            bin_table.amax, r_max=value_map.readk_bound(), a_max=a_max_eff)
        undr_idx, over_idx, bin_exact = bin_ops.lookup(
            bin_table, read_k, asm_k, bins(dev))
        fallbacks = ((is_undr | is_over) & ~bin_exact).sum()
        zero = torch.zeros((), dtype=undr_idx.dtype, device=dev)
        max_idx = torch.maximum(torch.where(is_undr, undr_idx, zero).max(),
                                torch.where(is_over, over_idx, zero).max())
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, nbins)
        return [kasm, kmissing, kover_fb, undr_hist, over_hist, max_idx,
                overflow, fallbacks, kc, kn, kr, kfbc]

    return row


def _fold_rows(mesh, state, parts) -> None:
    """Add the partials of the rows this process owns (``parts[r]``,
    None for a row it does not compute) into ``state`` on the mesh's
    first device."""
    for r, out in enumerate(parts):
        if out is not None and mesh.owns_row(r):
            fold_hist_state(state, [x.to(mesh.home, non_blocking=True)
                                    for x in out])


def reduce_hist_state(mesh, state) -> None:
    """Add a hist state over the processes of a host-spanning mesh, in
    place (``max_idx`` takes the maximum): each process folded the rows
    it owns.  A no-op on a mesh of one process."""
    if not mesh.spans_hosts:
        return
    ints = [i for i, x in enumerate(state)
            if i != 5 and x.dtype == torch.int64]
    flat = mesh.all_reduce_(torch.cat([state[i].reshape(-1) for i in ints]))
    for i, x in zip(ints, flat.split([state[i].numel() for i in ints])):
        state[i].copy_(x.reshape(state[i].shape))
    mesh.all_reduce_(state[2])
    mesh.all_reduce_(state[5], op="max")


def make_hist_step(mesh, read_lookup: ShardedLookup,
                   asm_lookup: ShardedLookup, k: int, value_map,
                   pack_chunk: int, asm_max_value: int | None = None,
                   bin_table=None, nbins: int = NBINS, kover_vmaxp: int = 0):
    """-hist step: ``run(state, *data)`` folds one batch into ``state``
    (``zero_hist_state`` on ``mesh.home``) in place and returns it.
    ``data`` is the transfer-packed (planes, vbits) of uint8 rows
    [C + k - 1], ``pack_chunk`` = the engine's chunk C; each a list of D
    row tensors from ``put_global``.  On a host-spanning mesh the caller
    adds the finished state over the processes (``reduce_hist_state``)."""
    row = _hist_parts(mesh, read_lookup, asm_lookup, k, value_map,
                      asm_max_value, bin_table, nbins, kover_vmaxp, False)

    def run(state, *data):
        _fold_rows(mesh, state, [
            row(r, _row_codes(data, r, pack_chunk, k)) if r in mesh.rows
            else None for r in range(mesh.shape["d"])])
        return state

    return run


def make_hist_group_step(mesh, read_lookup: ShardedLookup,
                         asm_lookup: ShardedLookup, k: int, value_map,
                         pack_chunk: int, asm_max_value: int | None = None,
                         bin_table=None, nbins: int = NBINS,
                         kover_vmaxp: int = 0):
    """Packed-group -hist over the mesh: ``run(*data)`` -> the 12 state
    entries with kasm/kmissing per slot ([SEG_MAX] each) — the
    fragmented-assembly packing (``modes/engine.py:hist_group``) on the
    sharded table.  ``data`` is (planes, vbits, marks_bits, base) from
    ``pack_group_transfer``."""
    from merfin_tpu_torch.modes.engine import SEG_MAX

    row = _hist_parts(mesh, read_lookup, asm_lookup, k, value_map,
                      asm_max_value, bin_table, nbins, kover_vmaxp, True)

    def run(*data):
        parts = [None] * mesh.shape["d"]
        for r in mesh.rows:
            codes = _row_codes(data, r, pack_chunk, k)
            seg = seg_from_marks(data[2][r], data[3][r], pack_chunk)
            parts[r] = row(r, codes, seg)
        state = zero_hist_state(nbins, (bin_table or BinTable()).amax,
                                kover_vmaxp, mesh.home)
        for i in (0, 1):
            state[i] = torch.zeros(SEG_MAX, dtype=torch.int64,
                                   device=mesh.home)
        _fold_rows(mesh, state, parts)
        reduce_hist_state(mesh, state)
        return state

    return run


def make_completeness_step(mesh, asm_lookup: ShardedLookup, value_map):
    """-completeness step: ``run(rkeys, rvals, rmask)``, read-DB rows per
    d-row (keys int64 u64 bits, SORTED, padding u64::MAX; values int64;
    mask bool) -> (total readK, undr copies), f64 on ``mesh.home``.

    The reference merge-joins 64 sorted DB streams
    (merfin-completeness.C:65-121); here each row's read keys probe the
    t-sharded asm table (asm-only k-mers are never visited,
    merfin-completeness.C:100-109) with no device sort: MKDB slices are
    sorted on disk."""
    vm = _PerDevice(lambda dev: convert.value_map_tensors(value_map, dev))

    def run(rkeys, rvals, rmask):
        # [D, 2] row partials, each from its row's owner alone, so that
        # the sum over the processes is exact and the rows add in order
        parts = torch.zeros((mesh.shape["d"], 2), dtype=torch.float64,
                            device=mesh.home)
        for r in mesh.rows:
            keys = rkeys[r]
            asm_v = mesh.row_sum_(asm_lookup.probe_row(r, keys), r)
            if not mesh.owns_row(r):
                continue
            read_k, _, _ = vm_ops.lookup(value_map, rvals[r],
                                         vm(keys.device))
            zero = torch.zeros((), dtype=torch.float64, device=keys.device)
            read_k = torch.where(rmask[r], read_k, zero)
            asm_k = torch.where(rmask[r], asm_v.to(torch.float64), zero)
            parts[r, 0] = read_k.sum().to(mesh.home, non_blocking=True)
            parts[r, 1] = torch.where(read_k > asm_k, read_k - asm_k,
                                      zero).sum().to(mesh.home,
                                                     non_blocking=True)
        mesh.all_reduce_(parts)
        total = torch.zeros((), dtype=torch.float64, device=mesh.home)
        undrc = torch.zeros((), dtype=torch.float64, device=mesh.home)
        for r in range(mesh.shape["d"]):
            total += parts[r, 0]
            undrc += parts[r, 1]
        return total, undrc

    return run


def make_dump_step(mesh, read_lookup: ShardedLookup,
                   asm_lookup: ShardedLookup, k: int, value_map,
                   pack_chunk: int):
    """-dump step: ``run(planes, vbits)`` -> per row (readK, asmK) [C] in
    window order, kasm and kmissing (None for a row this process does
    not compute), and the overflow count summed over the rows it owns.

    readK/asmK come as u32 bit patterns (int32) when ``value_map.
    fits_u32(k)`` proves them integers below 2^32, else f64 (the host
    computes K* from them, as the single-device -dump does)."""
    vm = _PerDevice(lambda dev: convert.value_map_tensors(value_map, dev))
    fits32 = value_map.fits_u32(k)

    def run(*data):
        D = mesh.shape["d"]
        rks, aks, kasms, kmiss = [None] * D, [None] * D, [None] * D, [None] * D
        overflow = torch.zeros((), dtype=torch.int64, device=mesh.home)
        for r in mesh.rows:
            codes = _row_codes(data, r, pack_chunk, k)
            fmer, rmer, valid = kmer_windows(codes, k)
            # positional: per-position rows (merfin.C:384)
            read_v, asm_v, valid = dual_probe_local(
                read_lookup, asm_lookup, r, fmer, rmer, valid, k,
                positional=True)
            read_k, asm_k, _, over, missing, _, _ = _classify(
                value_map, vm(codes.device), read_v, asm_v, valid)
            if mesh.owns_row(r):
                overflow += over.to(mesh.home, non_blocking=True)
            if fits32:
                read_k = read_k.to(torch.int64).to(torch.int32)
                asm_k = asm_k.to(torch.int64).to(torch.int32)
            rks[r], aks[r] = read_k, asm_k
            kasms[r], kmiss[r] = valid.sum(), missing.sum()
        return rks, aks, kasms, kmiss, overflow

    return run
