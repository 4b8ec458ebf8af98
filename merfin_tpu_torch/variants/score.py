"""Candidate-path k-mer scoring — varMer::score semantics (varMer.C:49-145).

For every candidate window sequence, walk its k-mers and compute:
  * numM   — count of k-mer positions with readK == 0 (invalid windows,
             i.e. windows containing non-ACGT bases, count as missing:
             readK stays 0 at varMer.C:78-90),
  * kstr   — per-kmer |K*| with -1 for missing (varMer.C:115-124),
  * dkstr  — per-kmer delta multiplicity oDeltak - nDeltak, where each
             delta is |readK - asmK| * prob, and nDeltak uses asmK
             incremented by 1 for k-mers spanning an applied ALT
             (the "new kmer" adjustment, varMer.C:98-132).

The ALT-span test reproduces the reference's uint32 arithmetic: the lower
bound `idxPath + 1 - merSize <= idx` underflows when idxPath + 1 < k,
making the condition false for that variant (varMer.C:108).

Layout: ALL candidate paths (across clusters) are packed into ONE flat
code stream with k-1 separators; lookups, getK and the K*/delta math run
over the flat window axis (vectorized numpy on the host, or one fused
device dispatch via a DeviceScorer/ShardedScorer), and per-path results
are cut back out as views.  A heavy multiallelic cluster (comb=15 ->
2^15 paths) is one array program instead of 32768 python-level scoring
calls — that is the whole point of the TPU design.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from merfin_tpu_torch.kcore.pack import encode_bases, kmers_from_codes_np
from merfin_tpu_torch.score.kstar import ProbTable, get_k_np
from merfin_tpu_torch.variants.enumerate import VarPath


@dataclasses.dataclass
class PathScore:
    num_m: int
    kstr: np.ndarray     # float64 [num_kmer_positions]; empty in filter mode
    dkstr: np.ndarray    # float64 [num_kmer_positions]; empty in filter mode
    # getTotdK (varMer.C:648-659) when reduced on DEVICE (fused scorer):
    # the per-window arrays never leave the chip then, and select.tot_dk
    # uses this scalar.  None on the host path (lazy np.sum of dkstr).
    totdk: float | None = None


def _pack_stream(all_paths: list[VarPath], k: int):
    """Pack every path's bases into ONE code stream with k-1 separators.

    Returns (stream u8, starts int64 [P+1]) where starts[i] is path i's
    first window index in the flat window axis (and its code offset).
    One join + one encode pass: a per-path encode_bases call costs
    ~30-60us of numpy overhead, which dominated the host side at 32768
    paths per comb=15 cluster."""
    P = len(all_paths)
    if P == 0:
        return np.zeros(0, np.uint8), np.zeros(1, dtype=np.int64)
    sep = "N" * (k - 1)
    stream = encode_bases("".join(p.seq + sep for p in all_paths))
    lens = np.fromiter((len(p.seq) for p in all_paths), np.int64, count=P)
    starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens + (k - 1), out=starts[1:])
    return stream, starts


@dataclasses.dataclass
class PathBlock:
    """Array-native candidate set of a run of clusters (fused-scorer
    path).

    Replaces list[VarPath] everywhere downstream of enumeration when a
    device scorer reduces per-path results on chip: a comb=15 cluster is
    a few arrays instead of 165k Python objects — built inside the
    worker process, pickled as numpy buffers, selected from directly
    (select.select_block, on ``cluster(i)``)."""

    stream: np.ndarray   # u8 codes; every path followed by k-1 separators
    starts: np.ndarray   # int64 [P+1] path code/window offsets; [-1] = len
    nis: np.ndarray      # int64 [P] k-mer windows per path
    lens: np.ndarray     # int64 [P] sequence length per path
    gtp: np.ndarray      # int16 [P, n_var] allele index per variant
    adjust: np.ndarray   # bool [n_win] new-kmer asmK+1 plane
    # cluster i's paths are rows cl_off[i]:cl_off[i + 1], its variants
    # gtp's first n_var[i] columns
    cl_off: np.ndarray   # int64 [clusters + 1]
    n_var: np.ndarray    # int64 [clusters]

    def rows(self, i: int) -> slice:
        """Cluster i's paths (rows of nis, lens, gtp and the scores)."""
        return slice(int(self.cl_off[i]), int(self.cl_off[i + 1]))

    def cluster(self, i: int) -> "PathBlock":
        """Cluster i's own block (a run of one), as views."""
        r = self.rows(i)
        a, b = r.start, r.stop
        s0, s1 = int(self.starts[a]), int(self.starts[b])
        # every path ends with k - 1 separators
        sep = int(self.starts[a + 1] - s0 - self.lens[a]) if b > a else 0
        n_win = max(0, s1 - s0 - sep)
        return PathBlock(self.stream[s0:s1], self.starts[a: b + 1] - s0,
                         self.nis[r], self.lens[r],
                         self.gtp[r, : int(self.n_var[i])],
                         self.adjust[s0: s0 + n_win],
                         np.asarray([0, b - a], np.int64), self.n_var[i:i + 1])


def build_path_block(paths: list[VarPath], k: int) -> PathBlock:
    """Pack one cluster's enumerated paths into a PathBlock (a run of
    one)."""
    stream, starts = _pack_stream(paths, k)
    n_win = max(0, stream.shape[0] - k + 1)
    adjust, _ = _flat_planes(paths, starts, n_win, k, need_start=False)
    P = len(paths)
    lens = np.fromiter((len(p.seq) for p in paths), np.int64, count=P)
    nis = np.maximum(0, lens - k + 1)
    n_var = max((len(p.gt_path) for p in paths), default=0)
    gtp = np.zeros((P, n_var), np.int16)
    for i, p in enumerate(paths):     # gt_path is always n_var long; the
        gtp[i, : len(p.gt_path)] = p.gt_path   # pad is belt-and-braces
    return PathBlock(stream, starts, nis, lens, gtp, adjust,
                     np.asarray([0, P], np.int64),
                     np.asarray([n_var], np.int64))


def dispatch_blocks(blocks, scorer, k: int):
    """ASYNC-dispatch many clusters' PathBlocks as ONE packed stream;
    returns a token for fetch_blocks.

    Streams concatenate exactly (every block already ends with k-1
    separators); adjust planes land at each block's code offset — the
    k-1 windows spanning a block boundary contain separator bases, are
    invalid, and never consume their adjust value."""
    live = [b for b in blocks if b is not None and b.nis.shape[0]]
    if not live:
        return (blocks, None)
    total_len = int(sum(b.stream.shape[0] for b in live))
    stream = np.concatenate([b.stream for b in live])
    n_win = max(0, total_len - k + 1)
    adjust = np.zeros(n_win, bool)
    starts_parts = []
    off = 0
    for b in live:
        bw = min(b.adjust.shape[0], n_win - off)
        adjust[off: off + bw] = b.adjust[:bw]
        starts_parts.append(b.starts[:-1] + off)
        off += int(b.starts[-1])
    starts = np.concatenate(starts_parts + [np.asarray([off], np.int64)])
    nis = np.concatenate([b.nis for b in live])
    return (blocks, scorer.dispatch_paths(stream, adjust, starts, nis))


def fetch_blocks(token, scorer):
    """Blocking half: per-cluster (num_m int64 [P], totdk f64 [P])."""
    blocks, paths_token = token
    out_empty = (np.zeros(0, np.int64), np.zeros(0))
    if paths_token is None:
        return [out_empty for _ in blocks]
    num_m, totdk = scorer.fetch_paths(paths_token)
    res = []
    i = 0
    for b in blocks:
        if b is None or not b.nis.shape[0]:
            res.append(out_empty)
            continue
        P = b.nis.shape[0]
        res.append((num_m[i: i + P], totdk[i: i + P]))
        i += P
    return res


def score_blocks(blocks, scorer, k: int):
    """Synchronous wrapper: dispatch + fetch one batch of PathBlocks."""
    return fetch_blocks(dispatch_blocks(blocks, scorer, k), scorer)


def _flat_planes(all_paths: list[VarPath], starts: np.ndarray, n_win: int,
                 k: int, need_start: bool = True):
    """(adjust bool [n_win], path_start int64 [n_win]) for the packed
    stream: adjust marks windows spanning an applied ALT (the new-kmer
    asmK+1 adjustment, varMer.C:103-112, incl. the uint32-underflow
    quirk); path_start[i] is the first window index of i's path (prob
    forward-fill reset boundary)."""
    if n_win == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64)
    if need_start:
        # per-window owning-path start: scatter each start then running
        # max (np.repeat over 100k+ variable-width segments is several
        # times slower at heavy-cluster scale)
        path_start = np.zeros(n_win, dtype=np.int64)
        own = starts[:-1][(starts[:-1] > 0) & (starts[:-1] < n_win)]
        path_start[own] = own
        np.maximum.accumulate(path_start, out=path_start)
    else:
        # fused-scorer blocks derive path starts from the 1-bit marks on
        # device (_planes_from_bits); skip the host scan
        path_start = None

    # adjustment intervals -> one difference plane (vectorized per
    # cluster would need ragged [P, n_var] handling across clusters;
    # per-path batches of equal n_var are built below)
    lo_ev: list[np.ndarray] = []
    hi_ev: list[np.ndarray] = []
    i = 0
    P = len(all_paths)
    while i < P:
        n_var = len(all_paths[i].gt_path)
        j = i
        while j < P and len(all_paths[j].gt_path) == n_var:
            j += 1
        if n_var:
            block = all_paths[i:j]
            cnt = (j - i) * n_var
            # np.fromiter over a flat generator beats np.asarray on a
            # nested list-of-lists ~10x at 100k+ paths per cluster
            idxp = np.fromiter((x for p in block for x in p.idx_path),
                               np.int64, count=cnt).reshape(j - i, n_var)
            lenp = np.fromiter((x for p in block for x in p.len_path),
                               np.int64, count=cnt).reshape(j - i, n_var)
            gtp = np.fromiter((x for p in block for x in p.gt_path),
                              np.int64, count=cnt).reshape(j - i, n_var)
            a = starts[i:j, None]
            ni = np.maximum(
                0, np.fromiter((len(p.seq) for p in block), np.int64,
                               count=j - i) - k + 1)[:, None]
            ok = (gtp > 0) & (idxp + 1 >= k)    # uint32 underflow quirk
            lo = a + np.maximum(0, idxp + 1 - k)
            hi = a + np.minimum(ni, idxp + lenp + k)
            ok &= lo < hi
            lo_ev.append(lo[ok])
            hi_ev.append(hi[ok])
        i = j
    lo_all = np.concatenate(lo_ev) if lo_ev else np.zeros(0, np.int64)
    if lo_all.size:
        hi_all = np.concatenate(hi_ev)
        # Interval union -> bool plane via merged runs + an int8
        # difference array.  The obvious bincount(int64, minlength=n_win)
        # x2 + int64 cumsum allocates ~5x 8B/window of fresh pages and is
        # page-fault-bound (~2.5 s per 30M-window comb=15 cluster); the
        # merged-run form writes one int8 plane instead (~0.3 s).
        if np.any(lo_all[1:] < lo_all[:-1]):
            order = np.argsort(lo_all, kind="stable")
            lo_all = lo_all[order]
            hi_all = hi_all[order]
        run_hi = np.maximum.accumulate(hi_all)
        new = np.empty(lo_all.size, bool)
        new[0] = True
        np.greater(lo_all[1:], run_hi[:-1], out=new[1:])
        run_lo = lo_all[new]
        idx_new = np.flatnonzero(new)
        run_end = np.empty(run_lo.size, np.int64)
        run_end[:-1] = run_hi[idx_new[1:] - 1]
        run_end[-1] = run_hi[-1]
        # merged runs are disjoint and non-empty (lo < hi), so run_lo and
        # run_end index distinct cells: plain assignment, no ufunc.at
        d8 = np.zeros(n_win + 1, np.int8)
        d8[run_lo] = 1
        d8[run_end] -= 1
        adjust = np.cumsum(d8[:n_win], dtype=np.int8) > 0
    else:
        adjust = np.zeros(n_win, bool)
    return adjust, path_start


def _flat_math(read_v, asm_v, valid, adjust, path_start, base, peak,
               prob_table, filter_mode):
    """Per-window getK + K*/delta math over a flat (chunk of the) window
    axis.  ``base`` is the chunk's global offset (chunks split only at
    path starts, so the prob forward fill never needs earlier chunks —
    a previous path's value is rejected by `last >= path_start` anyway).
    Returns (missing bool, kstr f64 | None, dkstr f64 | None)."""
    read_k, asm_k, prob = get_k_np(read_v, asm_v, peak, prob_table)
    read_k = np.where(valid, read_k, 0.0)
    missing = read_k == 0
    if filter_mode:
        return missing, None, None
    asm_k = np.where(valid, asm_k, 0.0)

    # The reference's `prob` local is only written by getK on VALID kmers
    # (varMer.C:60,84); invalid positions see the previous valid kmer's
    # prob within the same path (uninitialized before the first valid
    # one — we use 1.0 there).  Without a -prob table prob is identically
    # 1.0 and the fill is skipped.
    if prob_table is not None and len(prob_table) > 0:
        n = read_k.shape[0]
        idx = np.arange(base, base + n, dtype=np.int64)
        vi = np.where(valid, idx, -1)
        last = np.maximum.accumulate(vi)
        prob = np.where(last >= path_start,
                        prob[np.clip(last - base, 0, None)], 1.0)
        o_delta = np.abs(read_k - asm_k) * prob
    else:
        prob = 1.0
        o_delta = np.abs(read_k - asm_k)

    asm_adj = asm_k + adjust
    with np.errstate(divide="ignore", invalid="ignore"):
        over = read_k / asm_adj - 1.0
        under = asm_adj / read_k - 1.0
    kstr = np.where(missing, -1.0, np.where(read_k > asm_adj, over, under))
    n_delta = np.abs(read_k - asm_adj) * prob
    return missing, kstr, o_delta - n_delta


def _score_stream_host(stream, starts, adjust, path_start, k, lookup_read,
                       lookup_asm, peak, prob_table, filter_mode, threads):
    """Host flat scorer: batched (deduped) table lookups + vectorized
    numpy math over the whole packed stream.  Returns
    (missing, kstr | None, dkstr | None) planes on the window axis."""
    fmer, rmer, s_valid = kmers_from_codes_np(stream, k)
    canon = np.minimum(fmer, rmer)
    mult = np.where(fmer == rmer, 2, 1).astype(np.uint64)
    # Candidate paths overlap heavily (REF/ALT rewrites of the same
    # window share every k-mer away from the edit), so dedup the query
    # stream before the device dispatch: the table probes and the
    # host->device transfer shrink by the redundancy factor (2-10x
    # typical; 2^n-path multiallelic clusters 1000x).
    if canon.size > 4096:
        # manual sort-based dedup: np.unique(return_inverse=True) pays a
        # stable argsort plus extra passes (~5x slower at 20M+ windows)
        order = np.argsort(canon)
        sc = canon[order]
        newg = np.empty(sc.size, dtype=bool)
        newg[0] = True
        np.not_equal(sc[1:], sc[:-1], out=newg[1:])
        uq = sc[newg]
        inv = np.empty(sc.size, dtype=np.int64)
        inv[order] = np.cumsum(newg) - 1
        read_all = np.asarray(lookup_read(uq), dtype=np.uint64)[inv] * mult
        asm_all = np.asarray(lookup_asm(uq), dtype=np.uint64)[inv] * mult
    else:
        read_all = np.asarray(lookup_read(canon), dtype=np.uint64) * mult
        asm_all = np.asarray(lookup_asm(canon), dtype=np.uint64) * mult
    read_v = np.where(s_valid, read_all, 0)
    asm_v = np.where(s_valid, asm_all, 0)

    n_win = read_v.shape[0]
    if threads > 1 and n_win >= (1 << 18) and len(starts) > threads:
        # contiguous blocks split at path starts; the flat numpy kernels
        # release the GIL, so this scales on real cores
        from concurrent.futures import ThreadPoolExecutor

        P = len(starts) - 1
        bounds = sorted({int(starts[min(P, P * t // threads)])
                         for t in range(threads + 1)} | {0, n_win})
        bounds = [b for b in bounds if b <= n_win]
        if bounds[-1] != n_win:
            bounds.append(n_win)
        with ThreadPoolExecutor(threads) as ex:
            futs = [
                ex.submit(_flat_math, read_v[a:b], asm_v[a:b], s_valid[a:b],
                          adjust[a:b], path_start[a:b], a, peak, prob_table,
                          filter_mode)
                for a, b in zip(bounds, bounds[1:]) if b > a
            ]
            parts = [f.result() for f in futs]
        missing = np.concatenate([p[0] for p in parts])
        if filter_mode:
            return missing, None, None
        kstr = np.concatenate([p[1] for p in parts])
        dkstr = np.concatenate([p[2] for p in parts])
        return missing, kstr, dkstr
    return _flat_math(read_v, asm_v, s_valid, adjust, path_start, 0,
                      peak, prob_table, filter_mode)


def score_path_groups(
    groups: list[list[VarPath]],
    k: int,
    lookup_read,
    lookup_asm,
    peak: float,
    prob_table: ProbTable | None,
    filter_mode: bool = False,
    threads: int = 1,
    scorer=None,
) -> list[list[PathScore]]:
    """Score paths of many clusters with ONE batched lookup dispatch.

    lookup_* map a uint64 canonical-mer numpy array -> uint64 value array
    (0 for absent); they may run on device (DeviceLookup) or host.
    ``threads`` parallelizes the post-lookup flat math across cores.
    ``scorer`` (variants.device_score.DeviceScorer or ShardedScorer)
    replaces the whole lookup + host-math pipeline with one fused device
    dispatch.
    """
    all_paths: list[VarPath] = [p for paths in groups for p in paths]
    if not all_paths:
        return [[] for _ in groups]

    stream, starts = _pack_stream(all_paths, k)
    n_win = max(0, stream.shape[0] - k + 1)
    adjust, path_start = _flat_planes(all_paths, starts, n_win, k)
    empty = np.zeros(0)

    if scorer is not None:
        # fused + device-reduced: two scalars per path come back
        nis = np.asarray([max(0, len(p.seq) - k + 1) for p in all_paths],
                         dtype=np.int64)
        num_m_arr, totdk_arr = scorer.score_paths(stream, adjust, starts, nis)
        flat_scores = [
            PathScore(int(num_m_arr[i]), empty, empty,
                      totdk=0.0 if filter_mode else float(totdk_arr[i]))
            for i in range(len(all_paths))
        ]
    else:
        missing, kstr, dkstr = _score_stream_host(
            stream, starts, adjust, path_start, k, lookup_read, lookup_asm,
            peak, prob_table, filter_mode, threads)

        # per-path extraction: num_m via one cumsum, kstr/dkstr as views
        csum = np.zeros(n_win + 1, dtype=np.int64)
        np.cumsum(missing, out=csum[1:])
        flat_scores = []
        for i, p in enumerate(all_paths):
            a = int(starts[i])
            ni = max(0, len(p.seq) - k + 1)
            num_m = int(csum[a + ni] - csum[a])
            if filter_mode or kstr is None:
                flat_scores.append(PathScore(num_m, empty, empty))
            else:
                flat_scores.append(
                    PathScore(num_m, kstr[a: a + ni], dkstr[a: a + ni]))

    out: list[list[PathScore]] = []
    qi = 0
    for paths in groups:
        out.append(flat_scores[qi: qi + len(paths)])
        qi += len(paths)
    return out


def score_paths_np(
    paths: list[VarPath],
    k: int,
    lookup_read,
    lookup_asm,
    peak: float,
    prob_table: ProbTable | None,
    filter_mode: bool = False,
) -> list[PathScore]:
    """Single-cluster convenience wrapper."""
    return score_path_groups([paths], k, lookup_read, lookup_asm, peak,
                             prob_table, filter_mode)[0]
