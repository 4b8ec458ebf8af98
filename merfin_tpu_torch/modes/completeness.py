"""-completeness mode: k-mer completeness from the two databases (port
of ``merfin_tpu/modes/completeness.py``).

The reference merge-joins the two DBs' sorted k-mer streams 64 ways
(merfin-completeness.C:49-143).  Here the read DB's slices, already
globally sorted on disk, stream in blocks of (key, readK) through the
single-value sorted join against the device-resident assembly table;
asm-only k-mers are skipped exactly as in the reference
(merfin-completeness.C:100-109).  readK comes from the host-exact
value map on the host.

One block is one device program: the join, ``und = readK - asmK`` where
readK > asmK, and the split of both sums at the 64 slice boundaries
(512-wide row sums, a row cumsum and a boundary-row correction, as the
JAX package does it).  Blocks stream from host memory two ahead on the
prefetch thread; results stay in flight in a bounded deque and are
fetched once per block.  Output lines are the JAX package's.
"""

from __future__ import annotations

import sys
from collections import deque

import numpy as np
import torch

from merfin_tpu_torch.io.mkdb import SLICES, KmerDB
from merfin_tpu_torch.score.kstar import ProbTable
from merfin_tpu_torch.score.value_map import ValueMap
from merfin_tpu_torch.utils.prefetch import prefetch_iter
from merfin_tpu_torch.device import get_device
from merfin_tpu_torch.ops.kmer_ops import bias
from merfin_tpu_torch.ops.union_join import u32_to_int64
from merfin_tpu_torch.parallel import multihost as mh

_MAX_INFLIGHT = 8
_RED = 512   # two-level reduction row width


def build_asm_table(asm_db: KmerDB, k: int, block: int, device=None):
    """The device-resident sorted-join table over the FULL assembly DB
    (slices are contiguous, so the concatenation is globally sorted).
    The read stream covers the whole key space, so the JAX package pins
    v4's flat-scaling search over the ratio rule."""
    from merfin_tpu_torch.ops.sortjoin import build_sortjoin_table

    return build_sortjoin_table(asm_db.keys, asm_db.vals, k, block,
                                prefer="v4", device=device)


def _slice_bounds(k: int) -> np.ndarray:
    """The 65 prefix-boundary keys: slice i holds bounds[i] <= key <
    bounds[i+1] (io/mkdb.py's top-6-bit partition)."""
    shift = max(0, 2 * k - 6)
    return (np.arange(SLICES + 1, dtype=np.uint64) << np.uint64(shift))


def _per_slice(x, bpos):
    """Sums of ``x`` (int64 or f64) over the 64 runs [bpos[i],
    bpos[i+1]): 512-wide row sums, their cumsum and a masked sum of each
    boundary row (f64 sums depend on this order)."""
    x2 = torch.nn.functional.pad(x, (0, -x.shape[0] % _RED)).reshape(-1, _RED)
    rows = x2.shape[0]
    crow = torch.nn.functional.pad(torch.cumsum(x2.sum(1), 0), (1, 0))
    r_idx = torch.clamp(bpos // _RED, max=rows - 1)
    c_idx = bpos - r_idx * _RED       # == _RED when bpos hits the end
    lane = torch.arange(_RED, device=x.device)
    in_row = torch.where(lane[None, :] < c_idx[:, None], x2[r_idx],
                         torch.zeros((), dtype=x.dtype,
                                     device=x.device)).sum(1)
    prefix = crow[r_idx] + in_row
    return prefix[1:] - prefix[:-1]


def block_stats(table, bounds_b, q_keys, q_readk):
    """One read-stream block (sorted keys; readK int64, or f64 on the
    exotic-value-map fallback) -> per-slice (total readK, undr copies)
    [64] pairs of readK's dtype.  ``bounds_b`` is ``bias`` of the 65
    slice bounds on the device."""
    asm_v = u32_to_int64(table.lookup_sorted(q_keys))
    if q_readk.is_floating_point():
        asm_v = asm_v.to(torch.float64)
    und = torch.where(q_readk > asm_v, q_readk - asm_v,
                      torch.zeros((), dtype=q_readk.dtype,
                                  device=q_readk.device))
    bpos = torch.searchsorted(bias(q_keys), bounds_b)
    return _per_slice(q_readk, bpos), _per_slice(und, bpos)


def run_completeness(read_db: KmerDB, asm_db: KmerDB, peak: float,
                     prob_table: ProbTable | None = None, log=sys.stderr,
                     block: int = 1 << 22, asm_table=None, device=None,
                     mesh=None):
    """-completeness driver.  ``asm_table`` reuses a prebuilt
    build_asm_table result; the device is ``asm_table``'s, else
    ``device``, else MERFIN_PLATFORM's.  With ``mesh`` the assembly
    table shards over "t" and read-DB row batches ride "d" (the
    reference's 64-way OpenMP merge-join, merfin-completeness.C:65).
    Under a multi-process launch each rank streams its slice stripe and
    rank 0 reports the merged sums."""
    max_v = int(np.asarray(read_db.vals).max()) if read_db.distinct else 1
    # max_v is the scanned TRUE maximum, and completeness feeds raw DB
    # values (never palindrome-doubled), so the map needs no fallback
    vmap = ValueMap(peak, prob_table, max_v, exact_max=True)

    if mesh is not None:
        return _run_completeness_mesh(read_db, asm_db, vmap, mesh, log=log,
                                      block=block)

    multi = mh.is_active()
    pid, pcount = mh.process_info() if multi else (0, 1)

    if asm_table is None:
        device = get_device() if device is None else torch.device(device)
        asm_table = build_asm_table(asm_db, read_db.k, block, device)
    device = asm_table.device
    bounds_b = bias(torch.from_numpy(
        _slice_bounds(read_db.k).view(np.int64)).to(device))

    # readK on the HOST: one numpy gather per block from the exact map.
    # It is integer-valued and < 2^32 whenever peak > 0, so the device
    # sums are exact int64; otherwise (e.g. peak 0) it stays f64.
    rk_host = vmap.read_k_host
    int_ok = bool(np.isfinite(rk_host).all()) and float(rk_host.max()) < 2**32
    rk_map = rk_host.astype(np.int64) if int_ok else rk_host
    cap = np.uint32(min(vmap.vcap, 2**32 - 1))

    # contiguous row ranges to stream: the whole DB, or under a
    # multi-process launch the rank's slice stripe (the reference's
    # OpenMP dynamic schedule over 64 slices)
    offs = read_db.slice_offsets
    owned = [ii for ii in range(SLICES) if ii % pcount == pid]
    ranges = []
    for ii in owned:
        a, b = int(offs[ii]), int(offs[ii + 1])
        if ranges and ranges[-1][1] == a:
            ranges[-1][1] = b
        else:
            ranges.append([a, b])

    def blocks():
        """Read rows -> device (keys int64, readK) blocks; runs on the
        prefetch thread, so the copy of block i+1 overlaps block i."""
        for a, b in ranges:
            for lo in range(a, b, block):
                hi = min(lo + block, b)
                # a copy: torch takes no read-only (memmapped) array
                kk = np.array(read_db.keys[lo: hi], np.uint64)
                rv = np.asarray(read_db.vals[lo: hi])
                qk = rk_map[np.minimum(rv, cap)]
                yield (torch.from_numpy(kk.view(np.int64)).to(device),
                       torch.from_numpy(qk).to(device))

    compl_total = np.zeros(SLICES, dtype=np.float64)
    compl_undrc = np.zeros(SLICES, dtype=np.float64)

    def fetch(handle):
        t, u = handle
        compl_total[:] += t.cpu().numpy()
        compl_undrc[:] += u.cpu().numpy()

    inflight: deque = deque()
    for q_keys, q_readk in prefetch_iter(blocks(), depth=2):
        inflight.append(block_stats(asm_table, bounds_b, q_keys, q_readk))
        if len(inflight) > _MAX_INFLIGHT:
            fetch(inflight.popleft())
    while inflight:
        fetch(inflight.popleft())

    for ii in owned:
        _slice_line(ii, compl_total, compl_undrc, log)
    if multi:
        compl_total = mh.merge_array_across_hosts(compl_total)
        compl_undrc = mh.merge_array_across_hosts(compl_undrc)
    return _report(compl_total, compl_undrc, log if pid == 0 else None)


def _slice_line(ii: int, compl_total, compl_undrc, log) -> None:
    # python-float division: inf/inf -> nan without numpy warnings
    c = (1.0 - float(compl_undrc[ii]) / float(compl_total[ii])
         if compl_total[ii] else float("nan"))
    print(f"thread {ii:2d} total {compl_total[ii]:12.2f} underc "
          f"{compl_undrc[ii]:15.5f} completeness {c:0.8f}", file=log)


def _report(compl_total: np.ndarray, compl_undrc: np.ndarray, log):
    total = float(np.sum(compl_total))
    undrc = float(np.sum(compl_undrc))
    completeness = 1.0 - undrc / total if total else float("nan")

    if log is not None:   # rank 0 only under a multi-process launch
        print("", file=log)
        print(f"TOTAL readK:   {total:15.2f}", file=log)
        print(f"TOTAL undrcpy:    {undrc:15.5f}", file=log)
        print(f"COMPLETENESS:             {completeness:0.5f}", file=log)

    return {"total": total, "undrc": undrc, "completeness": completeness}


def _run_completeness_mesh(read_db: KmerDB, asm_db: KmerDB, vmap, mesh,
                           log=sys.stderr, block: int = 1 << 22):
    """-completeness on a mesh: each slice streams in [D, block] row
    batches (keys padded with u64::MAX, so every row stays sorted for
    the sorted-join probe; padding is masked out of the sums) against
    the t-sharded asm table, one per-slice line each.  On a
    host-spanning mesh every process drives the same slices and only
    rank 0 reports."""
    from merfin_tpu_torch.parallel.multichip import make_completeness_step
    from merfin_tpu_torch.parallel.sharded import ShardedLookup, put_global

    pid = mesh.rank if mesh.spans_hosts else 0
    asm_sharded = ShardedLookup.build(asm_db, mesh)
    step = make_completeness_step(mesh, asm_sharded, vmap)
    D = mesh.shape["d"]

    # one block size: per-device rows sized to the largest slice (pow2,
    # floor 4096), so small databases don't stream 64 padded full blocks
    max_slice = int(np.max(np.diff(read_db.slice_offsets))) \
        if read_db.distinct else 0
    per_dev = (max_slice + D - 1) // D
    if per_dev:
        block = min(block, max(4096, 1 << (per_dev - 1).bit_length()))

    compl_total = np.zeros(SLICES, dtype=np.float64)
    compl_undrc = np.zeros(SLICES, dtype=np.float64)
    for ii in range(SLICES):
        r_keys, r_vals = read_db.slice(ii)
        for lo in range(0, r_keys.shape[0], D * block):
            rk = np.full((D, block), -1, dtype=np.int64)   # u64::MAX
            rv = np.zeros((D, block), dtype=np.int64)
            mask = np.zeros((D, block), dtype=bool)
            piece_k = np.asarray(r_keys[lo: lo + D * block], np.uint64)
            n = piece_k.size
            rk.reshape(-1)[:n] = piece_k.view(np.int64)
            rv.reshape(-1)[:n] = r_vals[lo: lo + D * block]
            mask.reshape(-1)[:n] = True
            t, u = step(put_global(rk, mesh), put_global(rv, mesh),
                        put_global(mask, mesh))
            compl_total[ii] += float(t)
            compl_undrc[ii] += float(u)
        if pid == 0:
            _slice_line(ii, compl_total, compl_undrc, log)
    return _report(compl_total, compl_undrc, log if pid == 0 else None)
