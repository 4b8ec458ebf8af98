"""k-mer counting — the `meryl count` replacement (a port of
``merfin_tpu/count/counter.py``).

merfin shells out `meryl count k=K <fasta> output <db>` to build the
assembly database when -seqmers is missing (merfin-globals.C:166-189).
Here counting is a batched tensor program: chunked 2-bit k-merization on
the device, canonicalization, one sort and a run-length pass per chunk,
sorted collapses of the per-chunk runs on the device, and sorted merges
on the host for what leaves the card.

The host half (``_merge_sorted``, ``_Accumulator``, ``_packed_chunks``,
``pack_stream``, ``_chunk_canonical_counts_np``) is a copy of the JAX
package's; the device half is plain PyTorch (the JAX counter has no
Pallas kernel).  It runs on ``device.get_device()`` and has no fallback:
a device fault raises.  The numpy counter is reached only through an
explicit ``use_device=False``.

The result is an MKDB (canonical, sorted, 64-way prefix-partitioned),
byte-identical to the JAX package's for the same input.
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np
import torch

from merfin_tpu_torch.device import get_device
from merfin_tpu_torch.io.fasta import SeqFile, Sequence
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.kcore.pack import kmers_from_codes_np, pack_transfer_np
from merfin_tpu_torch.ops.kmer_ops import (U64_MAX, bias, kmer_windows, umin,
                                           unpack_transfer)


def _merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Merge two sorted unique (key, val) arrays, summing duplicates.

    Native path: one linear two-pointer C pass (mt_merge_counts) — the
    O(n log n) argsort merge was the counter's host wall (r4 verdict
    item 7); numpy fallback keeps the pure-python install working."""
    from merfin_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "mt_merge_counts"):
        import ctypes

        na, nb = int(a_keys.size), int(b_keys.size)
        ak = np.ascontiguousarray(a_keys, np.uint64)
        av = np.ascontiguousarray(a_vals, np.uint64)
        bk = np.ascontiguousarray(b_keys, np.uint64)
        bv = np.ascontiguousarray(b_vals, np.uint64)
        ok = np.empty(na + nb, np.uint64)
        ov = np.empty(na + nb, np.uint64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        m = lib.mt_merge_counts(
            ak.ctypes.data_as(u64p), av.ctypes.data_as(u64p), na,
            bk.ctypes.data_as(u64p), bv.ctypes.data_as(u64p), nb,
            ok.ctypes.data_as(u64p), ov.ctypes.data_as(u64p))
        return ok[:m], ov[:m]

    keys = np.concatenate([a_keys, b_keys])
    vals = np.concatenate([a_vals, b_vals])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    if keys.size == 0:
        return keys, vals
    boundary = np.empty(keys.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(vals, starts)
    return keys[starts], sums


class _Accumulator:
    """Hierarchical merger; spills sorted runs to disk past a byte budget.

    Without a budget all distinct k-mers stay in host RAM (binary-counter
    merging).  With one, whenever the resident levels exceed it they merge
    into a single sorted run written to a SpillStore — the out-of-core
    property meryl's counter has (SURVEY.md §2.2) — and the final database
    is produced by a slice-by-slice merge (spill.merge_to_mkdb).
    """

    def __init__(self, k: int | None = None, budget_bytes: int | None = None,
                 spill_dir: str | None = None):
        self.levels: list[tuple[np.ndarray, np.ndarray] | None] = []
        self.total = 0
        self.k = k
        self.budget = budget_bytes
        self.spill_dir = spill_dir
        self.store = None

    def add(self, keys: np.ndarray, vals: np.ndarray) -> None:
        self.total += int(vals.sum())
        cur = (keys, vals.astype(np.uint64))
        # binary-counter merging: level i holds ~2^i chunks worth
        i = 0
        while i < len(self.levels) and self.levels[i] is not None:
            cur = _merge_sorted(*self.levels[i], *cur)
            self.levels[i] = None
            i += 1
        if i == len(self.levels):
            self.levels.append(None)
        self.levels[i] = cur
        if self.budget is not None and self._resident_bytes() > self.budget:
            self._spill()

    def _resident_bytes(self) -> int:
        return sum(lv[0].size * 16 for lv in self.levels if lv is not None)

    def _spill(self) -> None:
        from merfin_tpu_torch.count.spill import SpillStore

        keys = np.zeros(0, np.uint64)
        vals = np.zeros(0, np.uint64)
        for lv in self.levels:
            if lv is not None:
                keys, vals = _merge_sorted(keys, vals, *lv)
        if self.store is None:
            assert self.k is not None, "spilling needs k for slice offsets"
            self.store = SpillStore(self.spill_dir, self.k)
        self.store.spill(keys, vals)
        self.levels = []

    def mem_parts(self) -> list[tuple[np.ndarray, np.ndarray]]:
        return [lv for lv in self.levels if lv is not None]

    def result(self) -> tuple[np.ndarray, np.ndarray, int]:
        assert self.store is None, "spilled accumulator: merge via spill.merge_to_mkdb"
        keys = np.zeros(0, np.uint64)
        vals = np.zeros(0, np.uint64)
        for lv in self.levels:
            if lv is not None:
                keys, vals = _merge_sorted(keys, vals, *lv)
        return keys, vals, self.total


def _runlength(sk: torch.Tensor):
    """Sorted keys [W] (u64 bit patterns in unsigned order) -> (unique
    keys padded with U64_MAX, bp, nxt): bp holds the run starts in
    order, then W; the count of run j is nxt[j] - bp[j], 0 on the pads.

    Fixed shape and no host sync (the JAX counter sorts the boundary
    positions to the front; here each run start scatters to its rank, a
    cumsum of the boundary flags, and every other position to a slot
    past W that is cut off, so no two writes meet)."""
    W = sk.shape[0]
    dev = sk.device
    pos = torch.arange(W, dtype=torch.int64, device=dev)
    b = torch.ones(W, dtype=torch.bool, device=dev)
    b[1:] = sk[1:] != sk[:-1]
    slot = torch.where(b, torch.cumsum(b, 0) - 1, pos + W)
    bp = torch.full((2 * W,), W, dtype=torch.int64, device=dev)
    bp.scatter_(0, slot, pos)
    bp = bp[:W]
    nxt = torch.cat([bp[1:], bp.new_full((1,), W)])
    keys = torch.where(bp < W, sk[bp.clamp(max=W - 1)], U64_MAX)
    return keys, bp, nxt


class _DeviceCountAcc:
    """Device-RESIDENT count accumulation (the JAX package's design).

    Each chunk reduces to sorted (unique key, count) runs on the device
    in fixed shapes (u64::MAX / count 0 padding); every ``collapse_runs``
    same-capacity runs merge in one device sort whose output COMPACTS to
    the next power of two above its live uniques (collapse sorts never
    re-pay input padding); and only the FINAL unique set crosses to the
    host, as int64 keys and counts — bytes scale with distinct k-mers,
    not bases.  Counts sum in int64 (exact below 2^63; ``count_files``
    refuses a count past u32).

    The host syncs once per collapse (its live count, for the
    compaction) and once in ``drain``; the valid-window total stays a
    device scalar until then.  Chunks reach the card as the packed wire
    of ``pack_transfer_np`` (3 bits a base) through a ring of pinned
    host buffers: each copy is asynchronous, and the host waits on a
    buffer's last copy only when it comes round again.
    """

    _MIN_CAP = 1 << 18
    _RING = 3          # pinned upload buffers

    def __init__(self, k: int, chunk: int, collapse_runs: int = 8):
        self.k = k
        self.R = collapse_runs
        self.device = get_device()
        # capacity-keyed buckets: buckets[cap] holds < R runs of ``cap``
        # padded entries; R same-cap runs collapse into one compacted run
        self.buckets: dict[int, list] = {}
        # runs whose collapse would exceed max_entries are fetched and
        # merged on the host instead (keeps device memory bounded on huge
        # inputs: a 2^27-entry collapse takes ~13 GB of sort operands and
        # scratch)
        self.max_entries = 1 << 27
        self._host_keys = np.zeros(0, np.uint64)
        self._host_vals = np.zeros(0, np.uint64)
        self._total = torch.zeros((), dtype=torch.int64, device=self.device)
        self._L = chunk + k - 1
        self._p4 = (self._L + 3) // 4
        self._ring: list = []           # (pinned buffer, copy-done event)
        self._turn = 0

    def _upload(self, planes: np.ndarray, vbits: np.ndarray) -> torch.Tensor:
        """The chunk's wire [1, p4 + p8] on the device."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.concatenate([planes, vbits], axis=1))
        if len(self._ring) < self._RING:
            buf = torch.empty((1, planes.shape[1] + vbits.shape[1]),
                              dtype=torch.uint8, pin_memory=True)
            self._ring.append((buf, torch.cuda.Event()))
        buf, done = self._ring[self._turn]
        self._turn = (self._turn + 1) % self._RING
        done.synchronize()              # its previous copy has left
        np.concatenate([planes, vbits], axis=1, out=buf.numpy())
        wire = buf.to(self.device, non_blocking=True)
        done.record()
        return wire

    def _chunk_count(self, wire: torch.Tensor):
        codes = unpack_transfer(wire[:, : self._p4], wire[:, self._p4:],
                                self._L)[0]
        fmer, rmer, valid = kmer_windows(codes, self.k)
        canon = umin(fmer, rmer).masked_fill_(~valid, U64_MAX)
        sk = bias(torch.sort(bias(canon)).values)
        keys, bp, nxt = _runlength(sk)
        counts = (nxt - bp).masked_fill_(keys == U64_MAX, 0)
        return keys, counts, valid.sum()

    def add_codes(self, buf: np.ndarray) -> None:
        """Dispatch one packed chunk (codes u8 [chunk + k - 1], code 4
        separators/pads); returns without waiting for the device."""
        planes, vbits = pack_transfer_np(buf.reshape(1, -1))
        keys, vals, n_valid = self._chunk_count(self._upload(planes, vbits))
        self._total += n_valid
        self._push((keys, vals))

    def _push(self, run) -> None:
        cap = int(run[0].shape[0])
        bucket = self.buckets.setdefault(cap, [])
        bucket.append(run)
        if len(bucket) >= self.R:
            self.buckets[cap] = []
            self._collapse(bucket)

    def _collapse(self, runs) -> None:
        cap = int(runs[0][0].shape[0])
        if len(runs) * cap > self.max_entries:
            # device-memory bound: overflow these (already deduped) runs
            # to the host accumulator via the native linear merge
            for r in runs:
                rk, rv = self._fetch_run(*r)
                self._host_keys, self._host_vals = _merge_sorted(
                    self._host_keys, self._host_vals, rk, rv)
            return
        k2 = torch.cat([r[0] for r in runs])
        v2 = torch.cat([r[1] for r in runs])
        del runs
        order = torch.sort(bias(k2))
        sk = bias(order.values)
        sv = v2[order.indices]
        del k2, v2, order
        keys, bp, nxt = _runlength(sk)
        cv = torch.cat([sv.new_zeros(1), torch.cumsum(sv, 0)])
        vals = cv[nxt] - cv[bp]
        del sk, sv, bp, nxt, cv
        # compact: uniques sit at the front; capacity = pow2 above the
        # live count so later collapse sorts never re-pay this padding
        n = int((keys != U64_MAX).sum())
        full = int(keys.shape[0])
        new_cap = max(self._MIN_CAP, 1 << max(0, (n - 1).bit_length()))
        if new_cap < full:
            keys, vals = keys[:new_cap].clone(), vals[:new_cap].clone()
        self._push((keys, vals))

    def _fetch_run(self, keys: torch.Tensor, vals: torch.Tensor):
        """One padded run's live prefix on the host (u64 keys, counts)."""
        n = int((keys != U64_MAX).sum())
        return (keys[:n].cpu().numpy().view(np.uint64),
                vals[:n].cpu().numpy().astype(np.uint64))

    def drain(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Device-collapse leftover same-capacity runs, then fetch +
        host-merge what remains (native linear merge)."""
        for cap in sorted(self.buckets):
            runs = self.buckets[cap]
            if len(runs) >= 2 and len(runs) * cap <= self.max_entries:
                self.buckets[cap] = []
                self._collapse(runs)   # re-pushed compacted (maybe new cap)
        keys, vals = self._host_keys, self._host_vals
        for cap in sorted(self.buckets, reverse=True):
            for r in self.buckets[cap]:
                rk, rv = self._fetch_run(*r)
                keys, vals = _merge_sorted(keys, vals, rk, rv)
        total = int(self._total)
        self.buckets = {}
        self._total.zero_()
        self._host_keys = np.zeros(0, np.uint64)
        self._host_vals = np.zeros(0, np.uint64)
        return keys, vals, total


def _chunk_canonical_counts_np(codes: np.ndarray, k: int):
    fmer, rmer, valid = kmers_from_codes_np(codes, k)
    canon = np.minimum(fmer, rmer)[valid]
    if canon.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    keys, counts = np.unique(canon, return_counts=True)
    return keys.astype(np.uint64), counts.astype(np.uint64)


def _chunk_canonical_counts_device(codes: np.ndarray, k: int, step):
    """Device path: canonicalize + sort on the device, reduce on the
    host (the valid prefix of the sorted windows is fetched)."""
    canon_sorted, valid_count = step(codes)
    canon = canon_sorted[: int(valid_count)].cpu().numpy().view(np.uint64)
    if canon.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    boundary = np.empty(canon.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = canon[1:] != canon[:-1]
    starts = np.flatnonzero(boundary)
    counts = np.diff(np.append(starts, canon.size)).astype(np.uint64)
    return canon[starts], counts


def _make_device_step(k: int):
    """codes u8 [L] (numpy) -> (the windows' canonical mers sorted in
    unsigned order, invalid windows last as u64::MAX; the valid count),
    both on the device."""
    device = get_device()

    def step(codes: np.ndarray):
        fmer, rmer, valid = kmer_windows(
            torch.from_numpy(codes).to(device), k)
        canon = umin(fmer, rmer).masked_fill_(~valid, U64_MAX)
        return bias(torch.sort(bias(canon)).values), valid.sum()

    return step


def _packed_chunks(seqs: Iterable[Sequence], k: int, chunk: int):
    """Pack sequences into fixed-size chunks with k-1 invalid separators
    so that windows never span two sequences — one device dispatch per
    full chunk regardless of read length (a per-read dispatch would be
    10^6 host round-trips for a read set).  Yields u8 [chunk + k - 1]
    buffers padded with code 4; a sequence split across chunks carries a
    k-1 overlap so every window is counted exactly once."""

    def fresh():
        return np.full(chunk + k - 1, 4, dtype=np.uint8)

    buf = fresh()
    fill = 0
    for seq in seqs:
        codes = seq.codes()
        n = codes.shape[0]
        if n < k:
            continue
        pos = 0
        while pos < n:
            if fill >= chunk:   # keep >= k codes of space before writing
                yield buf
                buf, fill = fresh(), 0
            space = chunk + k - 1 - fill
            take = min(n - pos, space)
            buf[fill : fill + take] = codes[pos : pos + take]
            fill += take
            if pos + take >= n:
                # end of sequence: leave a k-1 separator gap
                fill = min(fill + k - 1, chunk + k - 1)
                break
            # continue the same sequence in the next chunk with k-1 overlap
            yield buf
            buf, fill = fresh(), 0
            pos += take - (k - 1)
    if fill:
        yield buf


def count_sequences(
    seqs: Iterable[Sequence],
    k: int,
    chunk: int = 1 << 22,
    use_device: bool = True,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Count canonical k-mers; returns (sorted keys, values, total).

    Device path: fully device-resident accumulation (_DeviceCountAcc) —
    per-chunk sort+reduce and run collapses stay on the card; only the
    final unique set is fetched.  ``use_device=False``: the numpy
    counter."""
    if use_device:
        dacc = _DeviceCountAcc(k, chunk)
        for buf in _packed_chunks(seqs, k, chunk):
            dacc.add_codes(buf)
        return dacc.drain()
    acc = _Accumulator()
    _count_into(acc, seqs, k, chunk, use_device=False)
    return acc.result()


def _count_into(
    acc: _Accumulator,
    seqs: Iterable[Sequence],
    k: int,
    chunk: int = 1 << 22,
    use_device: bool = True,
) -> None:
    """Feed chunked canonical-count batches into a HOST accumulator
    (the spill/out-of-core path; the in-RAM path uses _DeviceCountAcc)."""
    step = _make_device_step(k) if use_device else None
    for buf in _packed_chunks(seqs, k, chunk):
        if step is not None:
            keys, vals = _chunk_canonical_counts_device(buf, k, step)
        else:
            keys, vals = _chunk_canonical_counts_np(buf, k)
        acc.add(keys, vals)


def pack_stream(codes: np.ndarray, offsets: np.ndarray, k: int) -> np.ndarray:
    """Concatenate per-sequence code ranges with k-1 invalid separators —
    fully vectorized (one fancy-index copy instead of a python loop per
    read; a 30x-coverage read set is tens of millions of sequences)."""
    n_seq = offsets.shape[0] - 1
    total = int(offsets[-1])
    out = np.full(total + (n_seq + 1) * (k - 1), 4, dtype=np.uint8)
    lengths = np.diff(offsets)
    seq_of_base = np.repeat(np.arange(n_seq, dtype=np.int64), lengths)
    idx_out = np.arange(total, dtype=np.int64) + (k - 1) * seq_of_base
    out[idx_out] = codes[:total]
    return out


def _create(out_db: str, k: int, keys: np.ndarray, vals: np.ndarray,
            total: int) -> KmerDB:
    if keys.size and int(vals.max()) > 0xFFFFFFFF:
        raise ValueError("k-mer count exceeds uint32 (unsupported)")
    return KmerDB.create(out_db, k, keys, vals.astype(np.uint32), total=total)


def count_files(
    paths: list[str],
    k: int,
    out_db: str,
    chunk: int = 1 << 22,
    use_device: bool = True,
    log=None,
    window: int | None = None,
    memory_gb: float | None = None,
    spill_dir: str | None = None,
) -> KmerDB:
    """Count k-mers of FASTA/FASTQ files into a new MKDB (one process).

    Streaming host data plane: each input file flows through fixed byte
    windows (SeqFile.iter_packed), so a 100+ GB FASTQ.gz counts in
    O(window + accumulator budget) memory — the whole file is never
    materialized (the reference streams too, merfin.C:30-53).  Without
    ``memory_gb`` the counts accumulate on the device; with it the
    accumulator is the host's, which spills sorted runs to disk when the
    distinct-kmer set exceeds the budget, and the database is produced
    by a 64-slice out-of-core merge (meryl's out-of-core counting role,
    SURVEY.md §2.2).  ``log``: where the spill merge is announced
    (default: the current sys.stderr).
    """
    from merfin_tpu_torch.utils.prefetch import prefetch_iter

    log = sys.stderr if log is None else log

    def all_blocks():
        for p in paths:
            # packed blocks: records joined with k-1 separators + window
            # overlap; each block counts as an independent sequence
            yield from SeqFile(p).iter_packed(k, window=window)

    # the prefetch thread parses and packs the next window while the
    # device counts this one
    seqs = prefetch_iter(all_blocks())
    budget = int(memory_gb * 1024**3) if memory_gb is not None else None
    if budget is None and use_device:
        dacc = _DeviceCountAcc(k, chunk)
        for buf in _packed_chunks(seqs, k, chunk):
            dacc.add_codes(buf)
        return _create(out_db, k, *dacc.drain())

    acc = _Accumulator(k=k, budget_bytes=budget, spill_dir=spill_dir)
    _count_into(acc, seqs, k, chunk=chunk, use_device=use_device)
    if acc.store is not None:
        from merfin_tpu_torch.count.spill import merge_to_mkdb

        print(f"count: merging {len(acc.store.runs)} spilled runs", file=log)
        return merge_to_mkdb(out_db, k, acc.store, acc.mem_parts(), acc.total)
    return _create(out_db, k, *acc.result())
