"""The streaming K* engine for -hist and -dump (port of
``merfin_tpu/modes/engine.py``).

Sequences are cut into fixed-size windows with k-1 overlap; each batch of
chunks runs one device step: unpack the 2-bit transfer planes, k-mer
windows, canonical mer, the two DB values, getK via the value map,
classification, the histogram bins and the integer kover parts.  The
per-sequence state stays on the device and is fetched once per sequence.

Two routes give the DB values, as in the JAX package:

* the gather route (``sortjoin=False``, the default): two positional
  probes of the gather tables (``table/lookup.py:DeviceLookup``).
  Invalid windows are probed like any other and masked after the value
  map, so the overflow count sees them, as JAX's does.  Every -dump step
  takes this route (it needs values by position);
* the union route (``sortjoin=True``, -hist only): ONE sort of the
  canonical mers (invalid windows sort last as u64::MAX sentinels) and
  the union sorted join (one probe gives the read and the asm value).
  Every consumer is a reduction, so the sort's permutation never
  matters; the even-k x2 flag and the group path's segment ids follow
  the sort through its permutation (argsort + gather).

Even k: palindromic windows (fmer == rmer) double both values
(merfin-globals.C:101-110).

Not ported (see ROADMAP.md): the two-table join and the
``MERFIN_HIST_BOUNDS=runs`` counting variant.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from merfin_tpu_torch import convert
from merfin_tpu_torch.kcore.pack import pack_transfer_np
from merfin_tpu_torch.ops.kmer_ops import (U64_MAX, bias,
                                          canonical_and_mult, kmer_windows,
                                          seg_from_marks, umin,
                                          unpack_transfer)
from merfin_tpu_torch.ops.union_join import UnionTable, u32_to_int64
from merfin_tpu_torch.score import bin_table as bin_ops
from merfin_tpu_torch.score import value_map as vm_ops
from merfin_tpu_torch.score.bin_table import BinTable
from merfin_tpu_torch.score.kover import (finish_kover, kover_parts,
                                          kover_vmaxp)
from merfin_tpu_torch.score.kstar import ProbTable, k_metric_np
from merfin_tpu_torch.score.value_map import ValueMap
from merfin_tpu_torch.utils.prefetch import prefetch_iter

NBINS = 1 << 14          # default k* bins per side
PAD_CODE = 4
SEG_MAX = 1024           # max sequences packed into one group dispatch


class BinOverflow(RuntimeError):
    """A k* histogram bin exceeded the engine's current nbins; run_hist
    grows the bins and retries (increaseArray, merfin-histogram.C:
    105-124)."""

    def __init__(self, max_idx: int, nbins: int):
        super().__init__(
            f"k* histogram bin {max_idx} exceeds nbins={nbins}")
        self.max_idx = int(max_idx)


@dataclasses.dataclass
class SeqStats:
    kasm: int = 0
    kmissing: int = 0
    kover_cpy: float = 0.0


def zero_hist_state(nbins: int, amax: int, vmaxp: int, device):
    """(kasm, kmissing, kover_fb, undr, over, max_idx, overflow,
    bin_fallbacks, kover_C, kover_N, kover_R, kover_fbc) on ``device``."""
    i64 = dict(dtype=torch.int64, device=device)
    return [torch.zeros((), **i64), torch.zeros((), **i64),
            torch.zeros((), dtype=torch.float64, device=device),
            torch.zeros(nbins, **i64), torch.zeros(nbins, **i64),
            torch.zeros((), **i64), torch.zeros((), **i64),
            torch.zeros((), **i64),
            torch.zeros(vmaxp * (amax + 1), **i64),
            torch.zeros(amax + 1, **i64), torch.zeros(amax + 1, **i64),
            torch.zeros((), **i64)]


def fold_hist_state(state, out) -> None:
    """Fold one hist-step output into the running state, in place."""
    for i, x in enumerate(out):
        if i == 5:
            torch.maximum(state[5], x.to(torch.int64), out=state[5])
        else:
            state[i] += x


def pack_group(seqs, k: int, chunk: int, rows: int, capacity: int):
    """Pack small sequences into batch rows with a segment-id plane:
    codes with k-1 separators, seg id per window start (SEG_MAX = none),
    chunked into [rows, chunk + k - 1].  Returns (codes_b, seg_b, starts)
    where starts[i] is sequence i's stream offset."""
    assert len(seqs) <= SEG_MAX

    total = sum(c.shape[0] + k - 1 for c in seqs)
    stream = np.full(total, PAD_CODE, dtype=np.uint8)
    n_pos = max(0, total - k + 1)
    seg_win = np.full(n_pos, SEG_MAX, dtype=np.int32)
    starts = []
    pos = 0
    for i, c in enumerate(seqs):
        stream[pos: pos + c.shape[0]] = c
        starts.append(pos)
        nwin = c.shape[0] - k + 1
        if nwin > 0:
            seg_win[pos: pos + nwin] = i
        pos += c.shape[0] + k - 1
    assert n_pos <= capacity

    codes_b = np.full((rows, chunk + k - 1), PAD_CODE, dtype=np.uint8)
    seg_b = np.full((rows, chunk), SEG_MAX, dtype=np.int32)
    for row, start in enumerate(range(0, n_pos, chunk)):
        piece = stream[start: start + chunk + k - 1]
        codes_b[row, : piece.shape[0]] = piece
        sw = seg_win[start: start + chunk]
        seg_b[row, : sw.shape[0]] = sw
    return codes_b, seg_b, starts


def pack_group_transfer(seqs, k: int, chunk: int, rows: int, capacity: int):
    """pack_group + transfer packing: (planes, vbits, marks_bits, base,
    starts) — 2-bit code planes + validity bits, and the seg plane as a
    boundary-mark bitmask + per-row mark offsets (seg_from_marks
    rebuilds it on the device)."""
    codes_b, _, starts = pack_group(seqs, k, chunk, rows, capacity)
    planes, vbits = pack_transfer_np(codes_b)
    flat = np.zeros(rows * chunk, np.uint8)
    idx = np.asarray(starts, dtype=np.int64)
    flat[idx[idx < flat.shape[0]]] = 1
    marks = flat.reshape(rows, chunk)
    base = np.zeros(rows, np.int64)
    base[1:] = np.cumsum(marks.sum(axis=1, dtype=np.int64))[:-1]
    marks_bits = np.packbits(marks, axis=-1, bitorder="little")
    return planes, vbits, marks_bits, base.astype(np.int32), starts


def counts_by_sort(comp: torch.Tensor, domain: int) -> torch.Tensor:
    """Value histogram of ``comp`` (ints in [0, domain)): one int32 sort
    + a searchsorted of every boundary.  Exact integer counts."""
    s = torch.sort(comp.reshape(-1).to(torch.int32)).values
    bounds = torch.searchsorted(
        s, torch.arange(domain, dtype=torch.int32, device=s.device))
    end = torch.full((1,), s.shape[0], dtype=bounds.dtype, device=s.device)
    return torch.diff(bounds, append=end)


def two_hist_by_sort(undr_idx, over_idx, is_undr, is_over, nbins: int):
    """Both k* histograms from ONE sort over the composite index space
    [0, 2*nbins] (windows are undr XOR over XOR neither)."""
    comp = torch.where(
        is_undr, undr_idx.clamp(0, nbins - 1),
        torch.where(is_over, nbins + over_idx.clamp(0, nbins - 1),
                    torch.full_like(undr_idx, 2 * nbins)))
    counts = counts_by_sort(comp, 2 * nbins + 1)
    return counts[:nbins], counts[nbins: 2 * nbins]


def seg_counts_by_sort(seg, valid, missing):
    """Per-slot (kasm, kmissing) via one composite sort."""
    S = SEG_MAX + 1
    seg = seg.to(torch.int32)
    comp = torch.where(missing, S + seg,
                       torch.where(valid, seg, torch.full_like(seg, 2 * S)))
    c = counts_by_sort(comp, 2 * S + 1)
    kmis_seg = c[S: S + SEG_MAX]
    kasm_seg = c[:SEG_MAX] + kmis_seg
    return kasm_seg, kmis_seg


class KstarEngine:
    """-hist and -dump engine.

    read_lookup/asm_lookup: ``DeviceLookup``s (the ``build_lookup(...)``)
    on the engine's device, placed at the first gather step; the union
    route reads only their host rows (``keys_np``/``vals_np``)."""

    def __init__(self, read_lookup, asm_lookup, k: int, peak: float,
                 prob_table: ProbTable | None = None,
                 chunk: int = 1 << 19, batch: int | None = None,
                 max_value: int | None = None, sortjoin: bool = False,
                 exact_max: bool = False,
                 asm_max_value: int | None = None):
        self.device = read_lookup.device
        self.read_lookup = read_lookup
        self.asm_lookup = asm_lookup
        self.k = int(k)
        self.peak = float(peak)
        self.chunk = int(chunk)
        # the JAX package's batch rule: the gather route materializes
        # [windows, rows, window] temporaries, so its batch stays small
        if batch is None:
            batch = 2 if sortjoin else 4
        self.batch = int(batch)
        self.prob_table = prob_table
        # getK and the bins come from host-exact tables (copies of the
        # JAX package); the device only gathers from them
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.bin_table = BinTable()
        self.kover_vmaxp = kover_vmaxp(prob_table)
        self._kover_rmax = self.value_map.readk_bound()
        self._kover_amax = (asm_max_value * (2 if k % 2 == 0 else 1)
                            if asm_max_value is not None else None)
        self.overflow_values = 0
        self.bin_fallbacks = 0
        self.kover_fallbacks = 0

        self.sortjoin = bool(sortjoin)
        self.table = UnionTable.from_dbs(
            read_lookup.keys_np, read_lookup.vals_np,
            asm_lookup.keys_np, asm_lookup.vals_np, self.device) \
            if self.sortjoin else None
        self._vm = convert.value_map_tensors(self.value_map, self.device)
        self._bins = convert.bin_table_tensors(self.bin_table, self.device)
        self.nbins = NBINS
        self.group_capacity = self.batch * self.chunk
        # a packed -dump group rides the gather tables whatever the
        # route: its rows are capped on their own
        self.dump_batch = min(self.batch, 4)
        self.dump_group_capacity = self.dump_batch * self.chunk

    def grow_bins(self, min_bins: int) -> None:
        """Grow the k* bin count to a power of two >= min_bins."""
        self.nbins = max(self.nbins * 2, 1 << (min_bins - 1).bit_length())

    # ---- device step ----

    def _lookup_kvals(self, codes, seg=None):
        """The gather route: codes uint8 [B, C + k - 1] -> flat
        window-order (readK, asmK, prob, valid, overflow, raw read value,
        seg) from two positional probes of the gather tables."""
        fmer, rmer, valid = kmer_windows(codes, self.k)
        canon, mult = canonical_and_mult(fmer.reshape(-1), rmer.reshape(-1))
        read_v = self.read_lookup.lookup(canon) * mult
        asm_v = self.asm_lookup.lookup(canon) * mult
        read_k, prob, overflow = vm_ops.lookup(self.value_map, read_v,
                                               self._vm)
        valid = valid.reshape(-1)
        zero = torch.zeros((), dtype=torch.float64, device=valid.device)
        read_k = torch.where(valid, read_k, zero)
        asm_k = torch.where(valid, asm_v.to(torch.float64), zero)
        seg = seg.reshape(-1) if seg is not None else None
        return read_k, asm_k, prob, valid, overflow, read_v, seg

    def _lookup_kvals_sorted(self, codes, seg=None):
        """The union route: codes uint8 [B, C + k - 1] -> sorted-order
        (readK, asmK, prob, valid, overflow, raw read value, seg)."""
        fmer, rmer, valid = kmer_windows(codes, self.k)
        canon = torch.where(valid, umin(fmer, rmer),
                            torch.full_like(fmer, U64_MAX))
        keys_s, order = torch.sort(bias(canon.reshape(-1)))
        qs = bias(keys_s)
        valid_s = qs != U64_MAX
        r, a = self.table.lookup2_sorted(qs)
        read_v = u32_to_int64(r)
        asm_v = u32_to_int64(a)
        if self.k % 2 == 0:
            mult = 1 + (fmer == rmer).reshape(-1)[order].to(torch.int64)
            read_v = read_v * mult
            asm_v = asm_v * mult
        seg_s = seg.reshape(-1)[order] if seg is not None else None
        read_k, prob, overflow = vm_ops.lookup(self.value_map, read_v,
                                               self._vm)
        zero = torch.zeros((), dtype=torch.float64, device=qs.device)
        read_k = torch.where(valid_s, read_k, zero)
        asm_k = torch.where(valid_s, asm_v.to(torch.float64), zero)
        return read_k, asm_k, prob, valid_s, overflow, read_v, seg_s

    def _hist_chunk(self, codes, seg=None):
        """One -hist step (processHistogram, merfin-histogram.C:36-92):
        invalid windows skipped, missing (readK == 0) counted, undr
        windows binned by trunc((asmK/readK - 1 + 0.1)/0.2) and feeding
        the QV* excess, everything else binned in over[].  With ``seg``
        (the packed-group path) kasm/kmissing come back per slot."""
        kvals = self._lookup_kvals_sorted if self.sortjoin \
            else self._lookup_kvals
        (read_k, asm_k, prob, valid, overflow, read_v,
         seg_s) = kvals(codes, seg)
        missing = valid & (read_k == 0)
        is_undr = valid & (read_k > 0) & (asm_k > read_k)
        is_over = valid & (read_k > 0) & ~is_undr

        if seg_s is None:
            kasm, kmissing = valid.sum(), missing.sum()
        else:
            kasm, kmissing = seg_counts_by_sort(seg_s, valid, missing)
        kc, kn, kr, kover_fb, kfbc = kover_parts(
            read_v, read_k, asm_k, prob, is_undr, self.kover_vmaxp,
            self.bin_table.amax, r_max=self._kover_rmax,
            a_max=self._kover_amax)

        undr_idx, over_idx, bin_exact = bin_ops.lookup(
            self.bin_table, read_k, asm_k, self._bins)
        fallbacks = ((is_undr | is_over) & ~bin_exact).sum()
        zero = torch.zeros((), dtype=undr_idx.dtype, device=undr_idx.device)
        max_idx = torch.maximum(torch.where(is_undr, undr_idx, zero).max(),
                                torch.where(is_over, over_idx, zero).max())
        undr_hist, over_hist = two_hist_by_sort(
            undr_idx, over_idx, is_undr, is_over, self.nbins)
        return [kasm, kmissing, kover_fb, undr_hist, over_hist, max_idx,
                overflow, fallbacks, kc, kn, kr, kfbc]

    def _fetch32(self) -> bool:
        """True when readK/asmK provably fit u32 (``ValueMap.fits_u32``):
        the positional fetch then rides as u32 bit patterns, half the
        bytes of f64, with the same values."""
        return self.value_map.fits_u32(self.k)

    def _dump_chunk(self, codes, seg=None):
        """One -dump step (processDump, merfin-dump.C:21-68) on the
        gather route: readK and asmK in window order, with
        kasm/kmissing, per slot given ``seg``.  K* is computed on the
        host from the fetched values."""
        (read_k, asm_k, _, valid, overflow, _,
         seg_s) = self._lookup_kvals(codes, seg)
        missing = valid & (read_k == 0)
        if seg_s is None:
            kasm, kmissing = valid.sum(), missing.sum()
        else:
            kasm, kmissing = seg_counts_by_sort(seg_s, valid, missing)
        if self._fetch32():   # integers < 2^32: u32 bit patterns in int32
            read_k = read_k.to(torch.int64).to(torch.int32)
            asm_k = asm_k.to(torch.int64).to(torch.int32)
        return read_k, asm_k, kasm, kmissing, overflow

    def _fetch_f64(self, x: torch.Tensor) -> np.ndarray:
        """A positional readK/asmK fetch as host f64 (exact)."""
        x = x.cpu().numpy()
        if x.dtype == np.int32:
            x = x.view(np.uint32)
        return x.astype(np.float64, copy=False)

    def _to_device(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for x in arrays]

    def _unpack(self, planes, vbits):
        return unpack_transfer(planes, vbits, self.chunk + self.k - 1)

    def _finish_kover(self, kover_fb, kc, kn, kr, kfbc) -> float:
        """Exact host finish of the device integer kover parts."""
        self.kover_fallbacks += int(kfbc)
        return finish_kover(kc.cpu().numpy(), kn.cpu().numpy(),
                            kr.cpu().numpy(), float(kover_fb),
                            self.prob_table, self.kover_vmaxp,
                            self.bin_table.amax)

    # ---- packed groups of small sequences ----

    def hist_group_dispatch(self, seqs):
        """Launch one packed-group step; returns a handle of in-flight
        device results (with its dispatch-time nbins: grow_bins() may run
        between dispatch and finalize while 2 groups are in flight)."""
        planes, vbits, marks, base, _ = pack_group_transfer(
            seqs, self.k, self.chunk, self.batch, self.group_capacity)
        planes, vbits, marks, base = self._to_device(planes, vbits, marks,
                                                     base)
        out = self._hist_chunk(self._unpack(planes, vbits),
                               seg_from_marks(marks, base, self.chunk))
        return len(seqs), self.nbins, out

    def hist_group_finalize(self, handle):
        """Fetch one group's results: (stats_list, undr, over, kover)."""
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
        return stats, uh.cpu().numpy(), oh.cpu().numpy(), float(kover)

    def hist_group(self, seqs):
        return self.hist_group_finalize(self.hist_group_dispatch(seqs))

    def dump_group(self, seqs):
        """-dump for a packed group of small sequences (one step): per
        sequence (readK, asmK, K*, kasm, kmissing), host f64 arrays over
        its windows.  Same packing contract as hist_group, at
        ``dump_group_capacity``."""
        planes, vbits, marks, base, starts = pack_group_transfer(
            seqs, self.k, self.chunk, self.dump_batch,
            self.dump_group_capacity)
        planes, vbits, marks, base = self._to_device(planes, vbits, marks,
                                                     base)
        rk, ak, kasm_seg, kmis_seg, overflow = self._dump_chunk(
            self._unpack(planes, vbits),
            seg_from_marks(marks, base, self.chunk))
        self.overflow_values += int(overflow)
        # row-major [rows, C] flattening maps stream window p to index p
        rk = self._fetch_f64(rk).reshape(-1)
        ak = self._fetch_f64(ak).reshape(-1)
        kasm_seg = kasm_seg.cpu().numpy()
        kmis_seg = kmis_seg.cpu().numpy()
        out = []
        for i, c in enumerate(seqs):
            nwin = max(0, c.shape[0] - self.k + 1)
            r = rk[starts[i]: starts[i] + nwin]
            a = ak[starts[i]: starts[i] + nwin]
            out.append((r, a, k_metric_np(r, a), int(kasm_seg[i]),
                        int(kmis_seg[i])))
        return out

    # ---- one long sequence ----

    def chunks_of(self, codes: np.ndarray):
        """Yield (start, padded_chunk[C + k - 1]) covering every window."""
        C, k = self.chunk, self.k
        n_pos = max(0, codes.shape[0] - k + 1)
        for start in range(0, max(n_pos, 1), C):
            buf = np.full(C + k - 1, PAD_CODE, dtype=np.uint8)
            piece = codes[start: start + C + k - 1]
            buf[: piece.shape[0]] = piece
            yield start, buf

    def hist_sequence(self, codes: np.ndarray):
        """Full -hist stats for one sequence: (SeqStats, undr, over).

        Batches fold into a device-resident state; the host fetches once
        per sequence.  Packing and the host->device copy run 2 batches
        ahead on a prefetch thread."""
        stats = SeqStats()
        undr = np.zeros(self.nbins, dtype=np.int64)
        over = np.zeros(self.nbins, dtype=np.int64)
        if codes.shape[0] < self.k:
            return stats, undr, over

        def packed_batches():
            buf = []
            for _, chunk in self.chunks_of(codes):
                buf.append(chunk)
                if len(buf) == self.batch:
                    yield self._to_device(*pack_transfer_np(np.stack(buf)))
                    buf = []
            if buf:
                # pad with all-invalid rows to keep one batch shape
                while len(buf) < self.batch:
                    buf.append(np.full(self.chunk + self.k - 1, PAD_CODE,
                                       np.uint8))
                yield self._to_device(*pack_transfer_np(np.stack(buf)))

        state = zero_hist_state(self.nbins, self.bin_table.amax,
                                self.kover_vmaxp, self.device)
        for planes, vbits in prefetch_iter(packed_batches(), depth=2):
            fold_hist_state(state, self._hist_chunk(self._unpack(planes,
                                                                 vbits)))

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

    def dump_sequence(self, codes: np.ndarray):
        """Yield (start, readK, asmK, K*, kasm, kmissing) per chunk, with
        2 steps in flight: chunk i+1's copy and compute overlap chunk i's
        fetch."""
        if codes.shape[0] < self.k:
            return
        n_pos = codes.shape[0] - self.k + 1

        def finalize(start, out):
            rk, ak, kasm, kmis, overflow = out
            self.overflow_values += int(overflow)
            n = min(self.chunk, n_pos - start)
            rk = self._fetch_f64(rk)[:n]
            ak = self._fetch_f64(ak)[:n]
            return start, rk, ak, k_metric_np(rk, ak), int(kasm), int(kmis)

        pending: deque = deque()
        for start, buf in self.chunks_of(codes):
            planes, vbits = self._to_device(*pack_transfer_np(buf[None]))
            pending.append((start, self._dump_chunk(self._unpack(planes,
                                                                 vbits))))
            if len(pending) > 2:
                yield finalize(*pending.popleft())
        while pending:
            yield finalize(*pending.popleft())
