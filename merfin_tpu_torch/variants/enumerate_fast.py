"""Array-native cluster enumeration — traverse() as numpy, no per-path
Python objects.

The recursive reference enumeration (merfin-variants.C:22-126, mirrored
scalar in enumerate.py) reduces to closed forms over the ORIGINAL window
coordinates:

  * skip structure: applying variant v force-skips the contiguous range
    (v, e_v] of later variants whose start lies inside v's REF span
    (original-coordinate comparison — the running index shifts cancel on
    both sides of the reference's test);
  * valid paths = gt vectors where every variant inside an applied
    span is 0, in DFS order = lexicographic gt order;
  * recorded idx_path[i] = orig_idx[i] + sum of deltas of applied
    variants v with e_v < i (skipped variants keep unshifted positions,
    merfin-variants.C:83-96 — the reference's shift loop starts past
    them);
  * recorded len_path[i] = chosen allele length if applied else REF len;
  * the candidate string = template with the applied alleles substituted
    at their original spans (applied spans are disjoint by the skip
    rule), assembled here as a ragged piece table -> one gather;
  * first-seen dedup by STRING (varMer.C:38-45): exact — 2x64-bit
    weighted hashes + length screen duplicates, byte-compare confirms.

A comb=15 cluster (165,888 paths, ~24M windows) builds in ~0.3 s of
numpy instead of ~4.5 s of Python-object churn (docs/PERF.md r4); the
scalar enumerate.py remains the parity oracle (fuzz-tested equal) and
serves the host scorer / -debug path.
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.variants.score import PathBlock

_CODE_TAB = np.full(256, 4, np.uint8)
for _i, _ch in enumerate("ACGT"):
    _CODE_TAB[ord(_ch)] = _i
    _CODE_TAB[ord(_ch.lower())] = _i

_HASH_RNG = np.random.default_rng(0xC0FFEE)
_HASH_W: list[np.ndarray] = []   # lazily grown weight planes (2 draws)


def _hash_weights(n: int):
    if not _HASH_W or _HASH_W[0].size < n:
        m = max(1024, 1 << (n - 1).bit_length())
        _HASH_W.clear()
        _HASH_W.extend(_HASH_RNG.integers(1, 1 << 32, size=(2, m),
                                          dtype=np.uint32))
    return _HASH_W[0][:n], _HASH_W[1][:n]


def _ranges_from_counts(counts: np.ndarray) -> np.ndarray:
    """concat(arange(c) for c in counts) without a Python loop."""
    tot = int(counts.sum())
    if tot == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(tot, dtype=np.int64) - np.repeat(starts, counts)


def _intervals_to_plane(lo_all: np.ndarray, hi_all: np.ndarray,
                        n_win: int) -> np.ndarray:
    """Union of [lo, hi) intervals -> bool plane.  Native path: one C
    difference-array pass, NO sort (the numpy merged-run form below
    needs the intervals sorted — an argsort of 2.5M intervals per
    comb=15 cluster)."""
    if lo_all.size == 0 or n_win == 0:
        return np.zeros(n_win, bool)

    from merfin_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "mt_intervals_plane"):
        import ctypes

        out = np.empty(n_win, np.uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.mt_intervals_plane(
            np.ascontiguousarray(lo_all, np.int64).ctypes.data_as(i64p),
            np.ascontiguousarray(hi_all, np.int64).ctypes.data_as(i64p),
            lo_all.size, n_win, out.ctypes.data_as(u8p))
        return out.view(bool)
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
    d8 = np.zeros(n_win + 1, np.int8)
    d8[run_lo] = 1
    d8[run_end] -= 1
    return np.cumsum(d8[:n_win], dtype=np.int8) > 0


def _assemble(combined: np.ndarray, p_len: np.ndarray, p_src: np.ndarray,
              w1: np.ndarray, w2: np.ndarray):
    """Piece table [P, n_p] (int32 sources into ``combined``, lengths)
    -> (2-bit codes of every path's pieces in turn, per-path 2x32-bit
    position-weighted hashes of its bytes)."""
    from merfin_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "mt_assemble_paths"):
        # one C pass (native/fastio.cpp mt_assemble_paths; ~20x the
        # numpy multi-pass on this host, docs/PERF.md r4)
        import ctypes

        Pn, n_p = p_len.shape
        T = int(p_len.sum(dtype=np.int64))
        codes = np.empty(max(T, 1), np.uint8)
        hashes = np.empty(max(Pn, 1), np.uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mt_assemble_paths(
            combined.ctypes.data_as(u8p),
            np.ascontiguousarray(p_src).ctypes.data_as(i32p),
            np.ascontiguousarray(p_len).ctypes.data_as(i32p),
            Pn, n_p,
            w1.ctypes.data_as(u32p), w2.ctypes.data_as(u32p),
            codes.ctypes.data_as(u8p), hashes.ctypes.data_as(u64p))
        return codes[:T], hashes[:Pn]

    # fallback: src_idx[pos] = pos + (src - piece_start) repeated per
    # piece; one repeat + in-place add + one gather; same hashes
    flat_len = p_len.reshape(-1)
    flat_src = p_src.reshape(-1)
    T = int(flat_len.sum(dtype=np.int64))
    # i32 gather indices would silently wrap past 2^31 assembled bytes
    # (~10M-path clusters); widen on the rare huge block
    idt = np.int64 if T >= 2**31 else np.int32
    piece_start = (np.cumsum(flat_len, dtype=np.int64)
                   - flat_len).astype(idt)
    src_idx = np.repeat(flat_src.astype(idt) - piece_start, flat_len)
    src_idx += np.arange(T, dtype=idt)
    raw = combined[src_idx]
    plen = p_len.sum(axis=1)
    st = np.zeros(p_len.shape[0] + 1, np.int64)
    np.cumsum(plen, out=st[1:])
    rel = np.repeat((-st[:-1]).astype(idt), plen)
    rel += np.arange(T, dtype=idt)
    h1 = np.add.reduceat(w1[rel] * raw, st[:-1])
    h2 = np.add.reduceat(w2[rel] * raw, st[:-1])
    hashes = (h1.astype(np.uint64) << np.uint64(32)) | h2
    return _CODE_TAB[raw], hashes


def _first_seen(hashes: np.ndarray, seq_len: np.ndarray, group, combined,
                p_src: np.ndarray, p_len: np.ndarray):
    """First-seen dedup by string (varMer.C:38-45) among the paths of
    each ``group`` (a cluster id a path; None: one cluster): the keep
    mask, or None when every path stays.  The 64-bit hash with the
    length mixed in screens (equal strings map equal: sound; distinct
    keys imply distinct strings); a byte compare confirms inside
    key-equal runs, taken in path order (collisions keep both, equal
    bytes drop later)."""
    mixed = hashes + seq_len.astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    order = np.argsort(mixed, kind="stable") if group is None \
        else np.lexsort((mixed, group))
    km = mixed[order]
    same = km[1:] == km[:-1]
    if group is not None:
        kg = group[order]
        same &= kg[1:] == kg[:-1]
    if not same.any():
        return None

    def row_bytes(r):
        pieces = [combined[p_src[r, j]: p_src[r, j] + p_len[r, j]]
                  for j in range(p_len.shape[1])]
        return np.concatenate(pieces)[: int(seq_len[r])]

    keep = np.ones(seq_len.shape[0], bool)
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], same, [False])).astype(np.int8)))
    for a, b in edges.reshape(-1, 2):     # key-equal run order[a: b + 1]
        kept_bytes = []
        for r in order[a: b + 1]:
            by = row_bytes(r)
            if any(by.size == kb.size and np.array_equal(by, kb)
                   for kb in kept_bytes):
                keep[r] = False
            else:
                kept_bytes.append(by)
    return None if keep.all() else keep


def build_path_block_fast(template: str, ref_idx_list, ref_len_list,
                          haps, k: int) -> PathBlock:
    """enumerate_paths + build_path_block as one numpy pipeline."""
    V = len(ref_idx_list)
    empty = PathBlock(np.zeros(0, np.uint8), np.zeros(1, np.int64),
                      np.zeros(0, np.int64), np.zeros(0, np.int64),
                      np.zeros((0, V), np.int16), np.zeros(0, bool))
    if V == 0:
        return empty

    orig_idx = np.asarray(ref_idx_list, np.int64)
    orig_len = np.asarray(ref_len_list, np.int64)
    # a ./.-style record iterates zero alleles: its branches die in the
    # frontier expansion below — UNLESS it is force-skipped (the DFS
    # never iterates skipped variants), exactly like the reference
    n_alleles = np.asarray([len(h) for h in haps], np.int64)

    # skip end e[v]: last i > v with orig_idx[i] < orig_idx[v] + orig_len[v]
    span_end = orig_idx + orig_len
    e = np.searchsorted(orig_idx, span_end, side="left") - 1
    e = np.maximum(e, np.arange(V))

    # per-variant allele length tables (lens[v][0] = REF len)
    max_a = max(1, int(n_alleles.max()))
    lens_tab = np.zeros((V, max_a), np.int64)
    for v in range(V):
        lens_tab[v, 0] = orig_len[v]
        for a in range(1, len(haps[v])):
            lens_tab[v, a] = len(haps[v][a])

    # ---- frontier expansion: valid gt rows in DFS (lexicographic) order
    gtp = np.zeros((1, 0), np.int16)
    force = np.full(1, -1, np.int64)     # max skip-end of applied so far
    for v in range(V):
        forced = force >= v
        counts = np.where(forced, 1, n_alleles[v])
        rep = np.repeat(np.arange(gtp.shape[0]), counts)
        col = _ranges_from_counts(counts).astype(np.int16)
        gtp = np.concatenate([gtp[rep], col[:, None]], axis=1)
        force = force[rep]
        applied = col > 0
        force = np.where(applied, np.maximum(force, e[v]), force)
    P = gtp.shape[0]
    if P == 0:
        return empty

    gtp64 = gtp.astype(np.int64)
    chosen_len = lens_tab[np.arange(V)[None, :], gtp64]       # [P, V]
    applied = gtp > 0
    dv = np.where(applied, chosen_len - orig_len[None, :], 0)  # deltas

    # idx_path: shifts land past each applied variant's skip range
    M = np.zeros((P, V + 1), np.int64)
    for v in range(V):
        tgt = int(e[v]) + 1
        if tgt <= V:
            M[:, tgt] += dv[:, v]
    idx_path = orig_idx[None, :] + np.cumsum(M, axis=1)[:, :V]
    len_path = chosen_len

    tmpl_len = len(template)
    seq_len = tmpl_len + dv.sum(axis=1)

    # ---- string assembly: per path, pieces = for each APPLIED v a
    # template gap [prev_applied_end, orig_idx[v]) + the allele bytes,
    # then the template tail; separators (k-1 'N') close every path.
    tmpl_b = np.frombuffer(template.encode("ascii"), np.uint8)
    pool_parts = []
    pool_off = np.zeros((V, max_a), np.int64)
    off = 0
    for v in range(V):
        for a in range(len(haps[v])):
            s = haps[v][a]
            pool_off[v, a] = off
            pool_parts.append(s)
            off += len(s)
    pool_parts.append("N" * max(0, k - 1))
    sep_off, sep_len = off, max(0, k - 1)
    pool_b = np.frombuffer("".join(pool_parts).encode("ascii"), np.uint8)

    ends = np.where(applied, span_end[None, :], 0)
    prev_end = np.maximum.accumulate(
        np.concatenate([np.zeros((P, 1), np.int64), ends], axis=1),
        axis=1)                                   # [P, V+1]
    gap_src = prev_end[:, :V]
    gap_len = np.where(applied, orig_idx[None, :] - gap_src, 0)
    gap_src = np.where(applied, gap_src, 0)
    al_src = pool_off[np.arange(V)[None, :], gtp64]
    al_len = np.where(applied, chosen_len, 0)
    al_src = np.where(applied, al_src, 0)
    tail_src = prev_end[:, V]
    tail_len = tmpl_len - tail_src

    # piece table [P, 2V+2] row-major: gap0, al0, ..., tail, separator.
    # Pool sources bias by tmpl_len so ONE combined byte array serves
    # every gather; everything T-sized stays int32/uint8 (fresh int64
    # pages made the first cut page-fault-bound, ~4 s per cluster).
    combined = np.concatenate([tmpl_b, pool_b])
    n_p = 2 * V + 2
    p_len = np.empty((P, n_p), np.int32)
    p_src = np.empty((P, n_p), np.int32)
    p_len[:, 0:2 * V:2] = gap_len
    p_src[:, 0:2 * V:2] = gap_src
    p_len[:, 1:2 * V:2] = al_len
    p_src[:, 1:2 * V:2] = al_src + tmpl_len
    p_len[:, 2 * V] = tail_len
    p_src[:, 2 * V] = tail_src
    p_len[:, 2 * V + 1] = sep_len
    p_src[:, 2 * V + 1] = sep_off + tmpl_len

    w1, w2 = _hash_weights(int((seq_len + sep_len).max()))
    stream, hashes = _assemble(combined, p_len, p_src, w1, w2)
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(seq_len + sep_len, out=starts[1:])

    keep = _first_seen(hashes, seq_len, None, combined, p_src, p_len) \
        if P > 1 else None
    if keep is not None:
        # rare: rebuild the packed stream from the kept rows only
        sel = np.flatnonzero(keep)
        stream, _ = _assemble(combined, p_len[sel], p_src[sel], w1, w2)
        gtp = gtp[sel]
        gtp64 = gtp64[sel]
        idx_path = idx_path[sel]
        len_path = len_path[sel]
        seq_len = seq_len[sel]
        P = sel.size
        starts = np.zeros(P + 1, np.int64)
        np.cumsum(seq_len + sep_len, out=starts[1:])
    lens = seq_len
    nis = np.maximum(0, lens - k + 1)
    adjust = _adjust_plane(stream, starts, nis, gtp64, idx_path, len_path,
                           k)
    return PathBlock(stream, starts, nis, lens,
                     gtp.astype(np.int16), adjust)


def _adjust_plane(stream, starts, nis, gtp64, idx_path, len_path,
                  k: int) -> np.ndarray:
    """The new-kmer plane over the stream's windows: score._flat_planes
    semantics, incl. the uint32-underflow quirk idxp + 1 >= k.  A path's
    intervals stay inside its own windows (hi <= its start + nis)."""
    n_win = max(0, stream.shape[0] - k + 1)
    ok = (gtp64 > 0) & (idx_path + 1 >= k)
    lo = starts[:-1, None] + np.maximum(0, idx_path + 1 - k)
    hi = starts[:-1, None] + np.minimum(nis[:, None],
                                        idx_path + len_path + k)
    ok &= lo < hi
    return _intervals_to_plane(lo[ok], hi[ok], n_win)


def build_path_blocks_batch(args_list, k: int) -> PathBlock:
    """build_path_block_fast over a run of clusters as one array program.

    ``args_list`` holds each cluster's (template, ref_idx, ref_len,
    haps), or None for a cluster with no paths (a PANIC-skipped one).
    Cluster i's paths are rows ``cl_off[i]:cl_off[i + 1]``, in its own
    DFS order, and its variants the first ``n_var[i]`` columns of
    ``gtp``; ``block.cluster(i)`` equals build_path_block_fast's block of
    it array for array.  Clusters are padded to the run's most variants
    with variants no path applies (one allele, the REF), and each path
    carries its cluster id through the same closed forms; the stream is
    every cluster's in turn, so it concatenates as single blocks do."""
    C = len(args_list)
    live_c = [c for c, a in enumerate(args_list) if a is not None]
    live = [args_list[c] for c in live_c]
    n_var = np.zeros(C, np.int64)
    n_var[live_c] = [len(a[1]) for a in live]
    Vx = int(n_var.max()) if C else 0
    sep_len = max(0, k - 1)
    empty = PathBlock(np.zeros(0, np.uint8), np.zeros(1, np.int64),
                      np.zeros(0, np.int64), np.zeros(0, np.int64),
                      np.zeros((0, Vx), np.int16), np.zeros(0, bool),
                      np.zeros(C + 1, np.int64), n_var)
    if Vx == 0:
        return empty

    # flat per-variant and per-ALT tables (a variant's alleles: REF, then
    # the ALTs; only ALTs are ever applied)
    haps = [h for a in live for h in a[3]]
    nv = len(haps)
    idx_f = np.fromiter((i for a in live for i in a[1]), np.int64, count=nv)
    len_f = np.fromiter((n for a in live for n in a[2]), np.int64, count=nv)
    n_alleles = np.fromiter(map(len, haps), np.int64, count=nv)
    n_alts = np.maximum(n_alleles - 1, 0)
    alts = [s for h in haps for s in h[1:]]
    alt_len = np.zeros(len(alts) + 1, np.int64)   # + a pad for gathers
    alt_len[:-1] = np.fromiter(map(len, alts), np.int64, count=len(alts))

    # one byte array: every template, then every ALT, then a separator
    templates = [a[0] for a in live]
    t_len = np.fromiter(map(len, templates), np.int64, count=len(live))
    tmpl_len = np.zeros(C, np.int64)
    tmpl_len[live_c] = t_len
    tmpl_off = np.zeros(C, np.int64)
    tmpl_off[live_c] = np.cumsum(t_len) - t_len
    tmpl_all = "".join(templates)
    alt_all = "".join(alts)
    combined = np.frombuffer(
        (tmpl_all + alt_all + "N" * sep_len).encode("ascii"), np.uint8)
    alt_off = np.zeros(len(alts) + 1, np.int64)
    alt_off[:-1] = len(tmpl_all) + np.cumsum(alt_len[:-1]) - alt_len[:-1]
    sep_off = len(tmpl_all) + len(alt_all)

    # [C, Vx] tables; a pad variant: index 0, length 0, one allele (the
    # REF), skip end itself
    c_of = np.repeat(np.arange(C), n_var)          # cluster of a variant
    v_of = _ranges_from_counts(n_var)
    var_off = np.cumsum(n_var) - n_var

    def padded(flat, fill):
        t = np.empty((C, Vx), np.int64)
        t[:] = fill
        t[c_of, v_of] = flat
        return t

    orig_idx = padded(idx_f, 0)
    orig_len = padded(len_f, 0)
    n_al = padded(n_alleles, 1)
    a_base = padded(np.cumsum(n_alts) - n_alts, 0)

    # skip end e[v] as build_path_block_fast's searchsorted, every
    # cluster in one call over cluster-offset keys (each cluster's
    # orig_idx sorted, as a VCF's clusters are); else cluster by cluster
    span_f = idx_f + len_f
    stride = 1 << 34
    key = c_of * stride + idx_f
    if (idx_f.min() >= 0 and span_f.max() < stride
            and np.all(key[1:] >= key[:-1])):
        e_f = np.searchsorted(key, c_of * stride + span_f, side="left") \
            - 1 - var_off[c_of]
    else:
        e_f = np.concatenate([
            np.searchsorted(idx_f[o: o + n], span_f[o: o + n], side="left")
            - 1 for o, n in zip(var_off, n_var) if n])
    e = padded(np.maximum(e_f, v_of), np.arange(Vx))

    # ---- frontier expansion, every cluster's rows in cluster order
    cid = np.flatnonzero(n_var > 0)
    gtp = np.zeros((cid.size, 0), np.int16)
    force = np.full(cid.size, -1, np.int64)
    for v in range(Vx):
        counts = np.where(force >= v, 1, n_al[cid, v])
        rep = np.repeat(np.arange(gtp.shape[0]), counts)
        col = _ranges_from_counts(counts).astype(np.int16)
        gtp = np.concatenate([gtp[rep], col[:, None]], axis=1)
        force = force[rep]
        cid = cid[rep]
        force = np.where(col > 0, np.maximum(force, e[cid, v]), force)
    P = gtp.shape[0]
    if P == 0:
        return empty

    gtp64 = gtp.astype(np.int64)
    applied = gtp > 0
    alt_i = np.where(applied, a_base[cid] + gtp64 - 1, len(alts))
    o_idx, o_len = orig_idx[cid], orig_len[cid]
    chosen_len = np.where(applied, alt_len[alt_i], o_len)
    dv = np.where(applied, chosen_len - o_len, 0)

    # idx_path: shifts land past each applied variant's skip range
    M = np.zeros((P, Vx + 1), np.int64)
    rows = np.arange(P)
    e_r = e[cid] + 1
    for v in range(Vx):
        M[rows, e_r[:, v]] += dv[:, v]
    idx_path = o_idx + np.cumsum(M, axis=1)[:, :Vx]
    len_path = chosen_len
    t_len = tmpl_len[cid]
    seq_len = t_len + dv.sum(axis=1)

    # ---- piece table, as build_path_block_fast's, sources into combined
    ends = np.where(applied, o_idx + o_len, 0)
    prev_end = np.maximum.accumulate(
        np.concatenate([np.zeros((P, 1), np.int64), ends], axis=1), axis=1)
    gap_src = prev_end[:, :Vx]
    t_off = tmpl_off[cid][:, None]
    n_p = 2 * Vx + 2
    p_len = np.empty((P, n_p), np.int32)
    p_src = np.empty((P, n_p), np.int32)
    p_len[:, 0:2 * Vx:2] = np.where(applied, o_idx - gap_src, 0)
    p_src[:, 0:2 * Vx:2] = np.where(applied, gap_src + t_off, 0)
    p_len[:, 1:2 * Vx:2] = np.where(applied, chosen_len, 0)
    p_src[:, 1:2 * Vx:2] = np.where(applied, alt_off[alt_i], 0)
    p_len[:, 2 * Vx] = t_len - prev_end[:, Vx]
    p_src[:, 2 * Vx] = prev_end[:, Vx] + t_off[:, 0]
    p_len[:, 2 * Vx + 1] = sep_len
    p_src[:, 2 * Vx + 1] = sep_off

    w1, w2 = _hash_weights(int((seq_len + sep_len).max()))
    stream, hashes = _assemble(combined, p_len, p_src, w1, w2)
    keep = _first_seen(hashes, seq_len, cid, combined, p_src, p_len) \
        if P > 1 else None
    if keep is not None:
        sel = np.flatnonzero(keep)
        stream, _ = _assemble(combined, p_len[sel], p_src[sel], w1, w2)
        gtp, gtp64, cid = gtp[sel], gtp64[sel], cid[sel]
        idx_path, len_path, seq_len = idx_path[sel], len_path[sel], \
            seq_len[sel]
        P = sel.size
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(seq_len + sep_len, out=starts[1:])
    cl_off = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(cid, minlength=C), out=cl_off[1:])
    nis = np.maximum(0, seq_len - k + 1)
    adjust = _adjust_plane(stream, starts, nis, gtp64, idx_path, len_path,
                           k)
    return PathBlock(stream, starts, nis, seq_len, gtp.astype(np.int16),
                     adjust, cl_off, n_var)
