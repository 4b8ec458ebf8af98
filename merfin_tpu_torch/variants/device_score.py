"""Fused variant-path scoring on the device (port of
``merfin_tpu/variants/device_score.py``).

One device program per span of the packed candidate-path stream:
unpack the 2-bit transfer planes, k-mer windows, canonical mer, the two
DB values in window order, the even-k palindrome multiplier, getK and
the K*/delta math (``_stream_math``) and the per-path reduction to
(num_m, totdk) (``_boundary_reduce``, ``ops/path_sum.py``).  Only those
two numbers per path come back; the selectors stay on the host.

The DB values come from one of two probes, as in the JAX scorer
(``sortjoin``; auto: the union join on a card, the gather tables on the
CPU): the union sorted join (invalid windows, the k-1 separators between
paths included, become u64::MAX sentinels; ONE sort, one probe for both
values, a scatter back to window order), or two positional probes of
the gather tables (``table/lookup.py:DeviceLookup``), with no sort.

Exactness: num_m is an exact integer prefix difference.  Without a
-prob table (``ValueMap.int_scorer_ok``) the delta sums are int64 and
exact in any order, and are fetched as int64.  On the f64 path each
path's deltas are added in path order, one at a time from 0.0
(``ops/path_sum.py``: a CUDA kernel on a card, plain torch on the CPU),
which is merfin's getTotdK bit for bit; the per-window deltas are
separate roundings (|readK-asmK|*prob, |readK-asmK'|*prob, then the
difference), never a fused multiply-add.  So the f64 totdk equals the
host scorer's and merfin's to the last bit, on which -polish's int
ordering and its equality test for het records depend.

Three deliberate divergences from the JAX scorer: the f64 totdk is the
in-order sum, not the JAX package's two-level prefix difference
(512-wide rows, then the row totals); the integer totdk is fetched as
int64, not cast to f64 first; and every span's overflow count is added
once, by the one fetch path (there is no fallback fetch).

``ShardedScorer`` is the same program over the sharded tables of a
``-mesh`` (``parallel/sharded.py:dual_probe_local``, positional).
"""

from __future__ import annotations

import numpy as np
import torch

from merfin_tpu_torch import convert
from merfin_tpu_torch.kcore.pack import pack_transfer_np
from merfin_tpu_torch.ops import path_sum
from merfin_tpu_torch.ops.kmer_ops import (U64_MAX, bias,
                                          canonical_and_mult, kmer_windows,
                                          umin, unpack_transfer)
from merfin_tpu_torch.ops.union_join import UnionTable, u32_to_int64
from merfin_tpu_torch.parallel.sharded import dual_probe_local
from merfin_tpu_torch.score import value_map as vm_ops
from merfin_tpu_torch.score.kstar import ProbTable
from merfin_tpu_torch.score.value_map import ValueMap
from merfin_tpu_torch.utils.spans import carry, span


def _planes_from_bits(adj_bits, mark_bits, n: int, need_start: bool):
    """(adjust bool [n], path_start int64 [n] | None) from the 1-bit
    adjust and path-start-mark planes; path_start[i] is the window index
    of i's path start, built only when a -prob table needs the fill."""
    bsh = torch.arange(8, dtype=torch.uint8, device=adj_bits.device)
    adjust = ((adj_bits[:, None] >> bsh) & 1).reshape(-1)[:n].to(torch.bool)
    if not need_start:
        return adjust, None
    mk = ((mark_bits[:, None] >> bsh) & 1).reshape(-1)[:n]
    midx = torch.arange(n, dtype=torch.int64, device=mk.device)
    path_start = torch.cummax(torch.where(mk == 1, midx, -1), dim=0).values
    return adjust, path_start


def _stream_math(value_map: ValueMap, vm, read_v, asm_v, valid, adjust,
                 path_start):
    """getK + K*/delta math on the window axis -> (missing bool, dkstr,
    overflow count).  read_v/asm_v: int64 raw values (multiplier applied).

    Integer path (vm[0] is the int32 readK map): missing and
    |readK-asmK| - |readK-asmK'| in int64, the host scorer's values.
    Otherwise f64, with the stale-prob forward fill reset at path starts
    (varMer.C:60,84 semantics; see variants/score.py:_flat_math)."""
    rk_map = vm[0]
    zero = torch.zeros((), dtype=torch.int64, device=read_v.device)
    if not rk_map.dtype.is_floating_point:
        idx = read_v.clamp(max=value_map.vcap)
        read_i = torch.where(valid, rk_map[idx].to(torch.int64), zero)
        asm_i = torch.where(valid, asm_v, zero)
        missing = read_i == 0
        o_delta = (read_i - asm_i).abs()
        n_delta = (read_i - asm_i - adjust.to(torch.int64)).abs()
        return missing, o_delta - n_delta, zero

    read_k, prob, overflow = vm_ops.lookup(value_map, read_v, vm)
    fzero = torch.zeros((), dtype=torch.float64, device=read_v.device)
    read_k = torch.where(valid, read_k, fzero)
    asm_k = torch.where(valid, asm_v.to(torch.float64), fzero)
    if value_map.has_prob:
        n = read_k.shape[0]
        idx = torch.arange(n, dtype=torch.int64, device=read_v.device)
        last = torch.cummax(torch.where(valid, idx, -1), dim=0).values
        prob_f = torch.where(last >= path_start, prob[last.clamp(min=0)],
                             1.0)
    else:
        prob_f = 1.0
    missing = read_k == 0
    o_delta = (read_k - asm_k).abs() * prob_f
    asm_adj = asm_k + adjust.to(torch.float64)
    n_delta = (read_k - asm_adj).abs() * prob_f
    return missing, o_delta - n_delta, overflow


_RED = 512   # row width of the two-level integer prefix reduction


def _prefix(x, acc_dtype):
    """``at(pos)``: the sum of x[:pos] (int64 window indexes), from a
    two-level prefix as in the JAX package: a cumsum within 512-wide
    rows, then over the row totals; the stream length is a multiple of
    512.  Exact for integers only."""
    x2 = x.reshape(-1, _RED).to(acc_dtype)
    rcs = torch.cumsum(x2, dim=1)
    crow = torch.nn.functional.pad(torch.cumsum(rcs[:, -1], dim=0), (1, 0))
    rows = x2.shape[0]
    zero = torch.zeros((), dtype=acc_dtype, device=x.device)

    def at(pos):
        r = torch.clamp(pos // _RED, max=rows - 1)
        c = pos - r * _RED   # == _RED at the clamped stream end
        within = torch.where(c > 0, rcs[r, (c - 1).clamp(min=0)], zero)
        return crow[r] + within

    return at


def _boundary_reduce(missing, dkstr, b_start, b_end):
    """Per-path (missing count int32, dkstr sum) over the path
    boundaries ``b_start``/``b_end`` (int64 window indexes): the counts
    and integer sums as prefix differences, an f64 dkstr summed in path
    order by ``path_sum.path_sums`` (span ``scorer.path_sum``, counting
    the path slots and the stream's windows of the launch)."""
    m_at = _prefix(missing, torch.int32)
    num_m = m_at(b_end) - m_at(b_start)
    if not dkstr.dtype.is_floating_point:
        d_at = _prefix(dkstr, torch.int64)
        return num_m, d_at(b_end) - d_at(b_start)
    with span("scorer.path_sum") as h:
        h.count("paths", b_start.shape[0])
        h.count("windows", dkstr.shape[0])
        return num_m, path_sum.path_sums(dkstr, b_start, b_end)


def _pack_inputs(codes: np.ndarray, adjust: np.ndarray,
                 starts: np.ndarray, nis: np.ndarray, k: int):
    """Host-side transfer packing of one span (the JAX package's, as it
    is): pad the stream to a power of two, 2-bit code planes + validity
    bits, 1-bit adjust/path-start-mark planes, and the padded [p_seg]
    path-boundary index arrays."""
    with span("scorer.pack"):
        return _pack(codes, adjust, starts, nis, k)


def _pack(codes, adjust, starts, nis, k: int):
    n = max(0, codes.shape[0] - k + 1)
    p = max(4096, 1 << (n - 1).bit_length())
    codes_p = np.full(p + k - 1, 4, dtype=np.uint8)
    codes_p[: codes.shape[0]] = codes
    planes, vbits = pack_transfer_np(codes_p)
    adj_p = np.zeros(p, dtype=bool)
    adj_p[:n] = adjust[:n]
    marks = np.zeros(p, dtype=bool)
    s = starts[:-1]
    marks[s[s < n]] = True
    P = nis.shape[0]
    p_seg = max(64, 1 << (P - 1).bit_length()) if P else 64
    b_start = np.zeros(p_seg, dtype=np.int32)
    b_end = np.zeros(p_seg, dtype=np.int32)
    b_start[:P] = starts[:-1]
    b_end[:P] = starts[:-1] + nis
    return (p, n, planes, vbits,
            np.packbits(adj_p, bitorder="little"),
            np.packbits(marks, bitorder="little"),
            b_start, b_end)


def split_spans(starts: np.ndarray, P: int, max_windows: int):
    """[(i, j, a, b)]: paths i..j-1 in one span of windows [a, b), cut at
    path boundaries so that a span holds at most ``max_windows`` windows
    (or one path)."""
    spans = []
    i = 0
    while i < P:
        j = i + 1
        while j < P and starts[j + 1] - starts[i] <= max_windows:
            j += 1
        spans.append((i, j, int(starts[i]), int(starts[j])))
        i = j
    return spans


class DeviceScorer:
    """Scores packed candidate-path streams on the lookups' device.

    ``dispatch_paths`` packs every span (numpy, on two threads when
    there are several) and launches its program from the calling thread,
    in span order; ``fetch_paths`` brings back every span's (num_m,
    totdk, overflow) in ONE transfer.  Spans split at path boundaries at
    ``MAX_WINDOWS`` windows (2^23 on the union join, 2^21 on the gather
    tables, whose [windows, rows, window] temporaries grow with it);
    paths are independent, so per-span results stitch exactly.

    ``read_lookup``/``asm_lookup``: ``DeviceLookup``s; the union route
    builds its union table from their host rows and never places them."""

    MAX_WINDOWS = 1 << 21

    def __init__(self, read_lookup, asm_lookup, k: int, peak: float,
                 prob_table: ProbTable | None, max_value: int | None = None,
                 exact_max: bool = False, sortjoin: bool | None = None):
        self.k = int(k)
        self.read_lookup = read_lookup
        self.asm_lookup = asm_lookup
        self.device = read_lookup.device
        if sortjoin is None:
            sortjoin = self.device.type != "cpu"
        self.sortjoin = bool(sortjoin)
        self.table = None
        if self.sortjoin:
            self.MAX_WINDOWS = 1 << 23
            self.table = UnionTable.from_dbs(
                read_lookup.keys_np, read_lookup.vals_np,
                asm_lookup.keys_np, asm_lookup.vals_np, self.device)
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.int_path = self.value_map.int_scorer_ok()
        self._vm = convert.value_map_scorer_tensors(self.value_map,
                                                    self.device)
        self.overflow_values = 0
        self._pack_ex = None

    def _packer(self):
        if self._pack_ex is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pack_ex = ThreadPoolExecutor(max_workers=2)
        return self._pack_ex

    def close(self) -> None:
        """Stop the packing threads (started at the first multi-span
        dispatch)."""
        if self._pack_ex is not None:
            self._pack_ex.shutdown()
            self._pack_ex = None

    def _score_stream(self, p: int, planes, vbits, adj_bits, mark_bits,
                      b_start, b_end):
        """One span's device program -> (num_m [p_seg] int32, totdk
        [p_seg] int64 or f64, overflow int64)."""
        k = self.k
        codes = unpack_transfer(planes, vbits, p + k - 1)
        adjust, path_start = _planes_from_bits(adj_bits, mark_bits, p,
                                               self.value_map.has_prob)
        fmer, rmer, valid = kmer_windows(codes, k)
        read_v, asm_v = self._probe(fmer, rmer, valid)
        missing, dkstr, overflow = _stream_math(
            self.value_map, self._vm, read_v, asm_v, valid, adjust,
            path_start)
        num_m, totdk = _boundary_reduce(missing, dkstr,
                                        b_start.to(torch.int64),
                                        b_end.to(torch.int64))
        return num_m, totdk, overflow

    def _probe(self, fmer, rmer, valid):
        """(read, asm) int64 values in window order, the even-k
        palindrome multiplier applied: two gather probes, or ONE sort,
        the union join and a scatter back to window order."""
        if not self.sortjoin:
            canon, mult = canonical_and_mult(fmer, rmer)
            return (self.read_lookup.lookup(canon) * mult,
                    self.asm_lookup.lookup(canon) * mult)
        canon = torch.where(valid, umin(fmer, rmer),
                            torch.full_like(fmer, U64_MAX))
        keys_s, order = torch.sort(bias(canon))
        read_s, asm_s = self.table.lookup2_sorted(bias(keys_s))
        vals = []
        for x in (read_s, asm_s):       # back to window order
            out = torch.empty_like(x)
            out[order] = x
            vals.append(u32_to_int64(out))
        read_v, asm_v = vals
        if self.k % 2 == 0:             # fmer + rmer lookups of palindromes
            mult = 1 + (fmer == rmer).to(torch.int64)
            read_v = read_v * mult
            asm_v = asm_v * mult
        return read_v, asm_v

    def _launch(self, packed):
        p, _, *arrays = packed
        return self._score_stream(p, *(
            torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            for x in arrays))

    def dispatch_paths(self, codes: np.ndarray, adjust: np.ndarray,
                       starts: np.ndarray, nis: np.ndarray):
        """Launch every span's program; returns the token for
        fetch_paths: (P, [(i, j, (num_m, totdk, overflow))])."""
        with span("scorer.dispatch") as h:
            h.count("f64", 0 if self.int_path else 1)
            P = nis.shape[0]
            n = max(0, codes.shape[0] - self.k + 1)
            if n == 0 or P == 0:
                return (P, [])
            h.count("windows", n)
            spans = split_spans(starts, P, self.MAX_WINDOWS)
            args = [(codes[a:b], adjust[a:b], starts[i: j + 1] - a,
                     nis[i:j], self.k) for i, j, a, b in spans]
            if len(spans) > 1:
                ex = self._packer()
                packs = [ex.submit(carry(_pack_inputs), *a) for a in args]
                packed = (f.result() for f in packs)
            else:
                packed = (_pack_inputs(*a) for a in args)
            cuda = self.device.type == "cuda"
            out = []
            for (i, j, _, _), pk in zip(spans, packed):
                out.append((i, j, self._launch(pk)))
                h.count("bytes", sum(x.nbytes for x in pk[2:]) if cuda
                        else 0)
            return (P, out)

    def fetch_paths(self, token):
        """Blocking half: (num_m int64 [P], totdk [P]); totdk is int64 on
        the integer path and f64 otherwise.  One device-to-host copy for
        all spans."""
        with span("scorer.fetch"):
            return self._fetch(*token)

    def _fetch(self, P: int, handles):
        num_m = np.zeros(P, np.int64)
        totdk = np.zeros(P, np.int64 if self.int_path else np.float64)
        if not handles:
            return num_m, totdk
        parts = []
        for _, _, (nm, td, ov) in handles:
            if td.dtype.is_floating_point:
                td = td.contiguous().view(torch.int64)
            parts += [nm.to(torch.int64), td, ov.to(torch.int64).reshape(1)]
        flat = torch.cat(parts).cpu().numpy()
        off = 0
        for i, j, (nm, td, _) in handles:
            w = nm.shape[0]
            num_m[i:j] = flat[off: off + j - i]
            seg = flat[off + w: off + w + j - i]
            totdk[i:j] = seg.view(np.float64) if td.dtype.is_floating_point \
                else seg
            self.overflow_values += int(flat[off + 2 * w])
            off += 2 * w + 1
        return num_m, totdk

    def score_paths(self, codes: np.ndarray, adjust: np.ndarray,
                    starts: np.ndarray, nis: np.ndarray):
        """Numpy in, numpy out: (num_m int64 [P], totdk [P])."""
        return self.fetch_paths(self.dispatch_paths(codes, adjust, starts,
                                                    nis))


class ShardedScorer(DeviceScorer):
    """Fused scoring over mesh-sharded lookup tables (-devscore -mesh).

    The span program runs on d-row 0's device and probes every t-shard
    of that row (``dual_probe_local(..., positional=True,
    replicated=True)``: every process of a host-spanning mesh gets the
    values): the query stream is the whole span, and the "d" axis adds
    table headroom, not variant throughput, as in the spans design where
    every process evaluates every cluster (``modes/variants.py``)."""

    MAX_WINDOWS = 1 << 23

    def __init__(self, mesh, read_sharded, asm_sharded, k: int, peak: float,
                 prob_table: ProbTable | None, max_value: int | None = None,
                 exact_max: bool = False):
        self.mesh = mesh
        self.read_sharded = read_sharded
        self.asm_sharded = asm_sharded
        self.k = int(k)
        self.device = mesh.row_device(0)
        self.value_map = ValueMap(peak, prob_table, max_value or (1 << 19),
                                  exact_max=exact_max)
        self.int_path = self.value_map.int_scorer_ok()
        self._vm = convert.value_map_scorer_tensors(self.value_map,
                                                    self.device)
        self.overflow_values = 0
        self._pack_ex = None

    def _probe(self, fmer, rmer, valid):
        read_v, asm_v, _ = dual_probe_local(
            self.read_sharded, self.asm_sharded, 0, fmer, rmer, valid,
            self.k, positional=True, replicated=True)
        return read_v, asm_v
