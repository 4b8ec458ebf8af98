"""The multi-device K* engine (port of ``merfin_tpu/parallel/engine.py``):
``KstarEngine``'s interface with the tables sharded over the
mesh's "t" axis and chunk batches over "d", so ``run_hist`` and
``run_dump`` take either engine unchanged.  Batches always travel
transfer-packed: the JAX engine's unpacked u8 option (``pack_transfer=
False``) is left out, as the single-device port leaves it out.

Correctness: the single-device engine's results, hostile edges
included: value-map overflow takes the counted fallback and bins outside
the exact tables are counted, with the same NBINS guard.
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.kcore.pack import pack_transfer_np
from merfin_tpu_torch.modes.engine import (NBINS, PAD_CODE, BinOverflow,
                                           SeqStats, pack_group_transfer)
import torch

from merfin_tpu_torch.parallel.multichip import (make_dump_step,
                                                 make_hist_group_step,
                                                 make_hist_step,
                                                 reduce_hist_state,
                                                 zero_hist_state)
from merfin_tpu_torch.parallel.sharded import ShardedLookup, put_global
from merfin_tpu_torch.score.bin_table import BinTable
from merfin_tpu_torch.score.kover import finish_kover, kover_vmaxp
from merfin_tpu_torch.score.kstar import ProbTable, k_metric_np
from merfin_tpu_torch.score.value_map import ValueMap
from merfin_tpu_torch.utils.prefetch import prefetch_iter


class ShardedKstarEngine:
    def __init__(self, mesh, read_lookup: ShardedLookup,
                 asm_lookup: ShardedLookup, k: int, peak: float,
                 prob_table: ProbTable | None = None, chunk: int = 1 << 19,
                 max_value: int | None = None, exact_max: bool = False,
                 asm_max_value: int | None = None):
        self.mesh = mesh
        self.k = k
        self.peak = float(peak)
        self.chunk = chunk
        self.data = mesh.shape["d"]
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.bin_table = BinTable()
        self.prob_table = prob_table
        self.kover_vmaxp = kover_vmaxp(prob_table)
        self.asm_max_value = asm_max_value
        self.overflow_values = 0
        self.bin_fallbacks = 0
        self.kover_fallbacks = 0
        self._read_lookup = read_lookup
        self._asm_lookup = asm_lookup
        self.nbins = NBINS
        self._step = self._make_hist_step()
        self._dump_step = None   # built on first dump_sequence call
        self._group_step = None  # built on first hist_group call
        # packed-group capacity: one batch = one chunk row per "d" row;
        # -dump packs no groups on the mesh (run_dump reads 0 as "none")
        self.group_capacity = self.data * self.chunk
        self.dump_group_capacity = 0
        # True when the mesh spans processes: every process drives the
        # same sequences (run_hist/run_dump skip striping)
        self.spans_hosts = mesh.spans_hosts

    def _make_hist_step(self):
        return make_hist_step(self.mesh, self._read_lookup, self._asm_lookup,
                              self.k, self.value_map, self.chunk,
                              asm_max_value=self.asm_max_value,
                              bin_table=self.bin_table, nbins=self.nbins,
                              kover_vmaxp=self.kover_vmaxp)

    def grow_bins(self, min_bins: int) -> None:
        """Grow the k* bin count and rebuild the hist steps (the
        ``KstarEngine.grow_bins`` contract)."""
        self.nbins = max(self.nbins * 2, 1 << (min_bins - 1).bit_length())
        self._step = self._make_hist_step()
        self._group_step = None   # rebuilt lazily with the new nbins

    def _put(self, batch):
        return put_global(batch, self.mesh)

    def _put_codes(self, batch):
        """Place one [D, C + k - 1] code batch as its transfer-packed
        2-bit planes and validity bits (``pack_transfer_np``)."""
        planes, vbits = pack_transfer_np(batch)
        return (self._put(planes), self._put(vbits))

    def _batches_of(self, codes: np.ndarray):
        """Yield ([D, C + k - 1] batch, row starts) covering every window,
        one chunk row per d-row."""
        C, k, B = self.chunk, self.k, self.data
        n_pos = codes.shape[0] - k + 1
        starts = list(range(0, max(n_pos, 1), C))
        for gi in range(0, len(starts), B):
            batch = np.full((B, C + k - 1), PAD_CODE, dtype=np.uint8)
            group = starts[gi: gi + B]
            for row, start in enumerate(group):
                piece = codes[start: start + C + k - 1]
                batch[row, : piece.shape[0]] = piece
            yield batch, group

    def hist_sequence(self, codes: np.ndarray):
        """Full -hist stats for one sequence (``KstarEngine.
        hist_sequence``): state on the device, one fetch per sequence;
        placing batch i+1 overlaps batch i's steps."""
        stats = SeqStats()
        undr = np.zeros(self.nbins, dtype=np.int64)
        over = np.zeros(self.nbins, dtype=np.int64)
        if codes.shape[0] < self.k:
            return stats, undr, over

        def inputs():
            for batch, _ in self._batches_of(codes):
                yield self._put_codes(batch)

        state = zero_hist_state(self.nbins, self.bin_table.amax,
                                self.kover_vmaxp, self.mesh.home)
        for inp in prefetch_iter(inputs(), depth=2):
            self._step(state, *inp)
        reduce_hist_state(self.mesh, state)
        (kasm, kmissing, kover_fb, uh, oh, max_idx,
         overflow, fallbacks, kc, kn, kr, kfbc) = state
        if int(max_idx) >= self.nbins:
            raise BinOverflow(int(max_idx), self.nbins)
        # counted only on success: grow-and-retry re-runs the sequence
        self.overflow_values += int(overflow)
        self.bin_fallbacks += int(fallbacks)
        stats.kasm = int(kasm)
        stats.kmissing = int(kmissing)
        stats.kover_cpy = self._finish_kover(kover_fb, kc, kn, kr, kfbc)
        undr += uh.cpu().numpy()
        over += oh.cpu().numpy()
        return stats, undr, over

    def hist_group_dispatch(self, seqs):
        """Run one packed-group -hist step over the mesh; ``run_hist``
        keeps 2 in flight (``KstarEngine.hist_group_dispatch``)."""
        if self._group_step is None:
            self._group_step = make_hist_group_step(
                self.mesh, self._read_lookup, self._asm_lookup, self.k,
                self.value_map, self.chunk,
                asm_max_value=self.asm_max_value, bin_table=self.bin_table,
                nbins=self.nbins, kover_vmaxp=self.kover_vmaxp)
        planes, vbits, marks, base, _ = pack_group_transfer(
            seqs, self.k, self.chunk, self.data, self.group_capacity)
        inputs = (self._put(planes), self._put(vbits), self._put(marks),
                  self._put(base))
        # dispatch-time nbins rides the handle (grow_bins may run while
        # 2 are in flight)
        return len(seqs), self.nbins, self._group_step(*inputs)

    def _finish_kover(self, kover_fb, kc, kn, kr, kfbc) -> float:
        self.kover_fallbacks += int(kfbc)
        return finish_kover(kc.cpu().numpy(), kn.cpu().numpy(),
                            kr.cpu().numpy(), float(kover_fb),
                            self.prob_table, self.kover_vmaxp,
                            self.bin_table.amax)

    def hist_group_finalize(self, handle):
        """Fetch one hist_group_dispatch's results."""
        n_seq, nbins_d, (kasm_seg, kmis_seg, kover_fb, uh, oh, max_idx,
                         overflow, fallbacks, kc, kn, kr, kfbc) = handle
        if int(max_idx) >= nbins_d:
            raise BinOverflow(int(max_idx), nbins_d)
        self.overflow_values += int(overflow)
        self.bin_fallbacks += int(fallbacks)
        kover = self._finish_kover(kover_fb, kc, kn, kr, kfbc)
        kasm_seg = kasm_seg.cpu().numpy()
        kmis_seg = kmis_seg.cpu().numpy()
        stats = [SeqStats(kasm=int(kasm_seg[i]), kmissing=int(kmis_seg[i]))
                 for i in range(n_seq)]
        return stats, uh.cpu().numpy(), oh.cpu().numpy(), kover

    def hist_group(self, seqs):
        return self.hist_group_finalize(self.hist_group_dispatch(seqs))

    def _dump_batches(self, codes: np.ndarray):
        """Yield (row starts, (readK, asmK, kasm, kmissing) rows) of every
        batch of one sequence; the overflow count adds over the processes
        of a host-spanning mesh once the sequence is done."""
        if self._dump_step is None:
            self._dump_step = make_dump_step(
                self.mesh, self._read_lookup, self._asm_lookup, self.k,
                self.value_map, self.chunk)
        overflow = torch.zeros((), dtype=torch.int64, device=self.mesh.home)
        for batch, group in self._batches_of(codes):
            rk, ak, kasm, kmis, over = self._dump_step(
                *self._put_codes(batch))
            overflow += over
            yield group, rk, ak, kasm, kmis
        self.overflow_values += int(self.mesh.all_reduce_(overflow))

    @staticmethod
    def _f64(x) -> np.ndarray:
        x = x.cpu().numpy()
        if x.dtype == np.int32:
            x = x.view(np.uint32)
        return x.astype(np.float64, copy=False)

    def dump_sequence_local(self, codes: np.ndarray):
        """Host-spanning -dump: yield (chunk_ordinal, start, readK, asmK,
        K*, kasm, kmissing) for the chunk rows THIS process owns (the
        holder of each row's (r, 0) entry, so each row is emitted once
        over all processes); the caller routes rows to part files and
        merges by ordinal.  Every process must iterate the same
        sequences, each to its end."""
        if codes.shape[0] < self.k:
            return
        n_pos = codes.shape[0] - self.k + 1
        ordinal = 0
        for group, rk, ak, kasm, kmis in self._dump_batches(codes):
            for row, start in enumerate(group):
                if self.mesh.owns_row(row):
                    n = min(self.chunk, n_pos - start)
                    r = self._f64(rk[row])[:n]
                    a = self._f64(ak[row])[:n]
                    yield (ordinal + row, start, r, a, k_metric_np(r, a),
                           int(kasm[row]), int(kmis[row]))
            ordinal += len(group)

    def dump_sequence(self, codes: np.ndarray):
        """Yield (start, readK, asmK, K*, kasm, kmissing) per chunk, in
        input order (the ``KstarEngine.dump_sequence`` contract).  A
        host-spanning mesh dumps through ``dump_sequence_local``."""
        if self.spans_hosts:
            raise ValueError("a host-spanning mesh dumps through "
                             "dump_sequence_local")
        if codes.shape[0] < self.k:
            return
        n_pos = codes.shape[0] - self.k + 1
        for group, rk, ak, kasm, kmis in self._dump_batches(codes):
            for row, start in enumerate(group):
                n = min(self.chunk, n_pos - start)
                r = self._f64(rk[row])[:n]
                a = self._f64(ak[row])[:n]
                yield (start, r, a, k_metric_np(r, a), int(kasm[row]),
                       int(kmis[row]))
