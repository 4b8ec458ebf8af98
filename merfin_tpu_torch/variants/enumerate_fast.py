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

build_path_blocks builds a run of clusters as one array program, and a
heavy cluster as a run of one: a comb=15 cluster (165,888 paths, ~24M
windows) in well under a second of numpy instead of seconds of
Python-object churn.  The scalar enumerate.py serves the host scorer /
-debug path.
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
    each ``group`` (a cluster id a path, nondecreasing in path order):
    the keep mask, or None when every path stays.  The 64-bit hash with
    the length mixed in screens (equal strings map equal: sound; distinct
    keys imply distinct strings); a byte compare confirms inside
    key-equal runs of one group, taken in path order (collisions keep
    both, equal bytes drop later).  The stable sort keeps each key-equal
    run in path order, so a group's paths in it sit together."""
    mixed = hashes + seq_len.astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    order = np.argsort(mixed, kind="stable")
    km = mixed[order]
    kg = group[order]
    same = (km[1:] == km[:-1]) & (kg[1:] == kg[:-1])
    if not same.any():
        return None

    cb = combined.tobytes()

    def row_bytes(r):
        return b"".join(cb[s: s + n] for s, n in zip(
            p_src[r].tolist(), p_len[r].tolist()))[: int(seq_len[r])]

    keep = np.ones(seq_len.shape[0], bool)
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], same, [False])).astype(np.int8)))
    for a, b in edges.reshape(-1, 2):     # key-equal run order[a: b + 1]
        kept = set()
        for r in order[a: b + 1]:
            by = row_bytes(r)
            if by in kept:
                keep[r] = False
            else:
                kept.add(by)
    return None if keep.all() else keep


def build_path_blocks(args_list, k: int) -> PathBlock:
    """enumerate_paths + build_path_block over a run of clusters as one
    numpy pipeline.

    ``args_list`` holds each cluster's (template, ref_idx, ref_len,
    haps), or None for a cluster with no paths (a PANIC-skipped one); a
    heavy cluster is a run of one.  Cluster i's paths are rows
    ``cl_off[i]:cl_off[i + 1]``, in its own DFS order, and its variants
    the first ``n_var[i]`` columns of ``gtp``; the stream is every
    cluster's in turn, so it concatenates as blocks do.  Clusters are
    padded to the run's most variants with a variant no path applies.
    Every allele of the run has a slot in flat tables (a variant with no
    alleles keeps one, its REF's; the pads share one), and each path
    carries its slot at each variant, so the closed forms gather from
    those tables and no path pays for its cluster's."""
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

    # flat per-variant tables, every live cluster's variants in turn
    haps = [h for a in live for h in a[3]]
    nv = len(haps)
    idx_f = np.fromiter((i for a in live for i in a[1]), np.int64, count=nv)
    len_f = np.fromiter((n for a in live for n in a[2]), np.int64, count=nv)
    # a ./.-style record iterates zero alleles: its branches die in the
    # frontier expansion below -- UNLESS it is force-skipped (the DFS
    # never iterates skipped variants), exactly like the reference
    n_alleles = np.fromiter(map(len, haps), np.int64, count=nv)
    alts = [s for h in haps for s in h[1:]]

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
    sep_off = len(tmpl_all) + len(alt_all)

    # skip end e[v]: last i > v with orig_idx[i] < orig_idx[v] +
    # orig_len[v], every cluster in one searchsorted over cluster-offset
    # keys (each cluster's orig_idx sorted, as a VCF's clusters are);
    # else cluster by cluster
    c_of = np.repeat(np.arange(C), n_var)          # cluster of a variant
    v_of = _ranges_from_counts(n_var)
    var_off = np.cumsum(n_var) - n_var
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
    e_f = np.maximum(e_f, v_of)

    # allele slots: variant j's REF at base_f[j], its ALTs after it in
    # the order of ``alts``; the last slot is the pads'.  Per slot: the
    # allele index, the variant's start, the chosen length, its delta,
    # the applied span's end, the allele piece (length, source), the
    # column its delta lands in (past the variant's skip range; a REF's
    # in column Vx, which no path reads) and the skip end it forces
    slots = np.maximum(n_alleles, 1)
    base_f = np.cumsum(slots) - slots
    pad = int(slots.sum())
    s_var = np.repeat(np.arange(nv), slots)
    s_al = np.zeros(pad + 1, np.int16)
    s_al[:pad] = _ranges_from_counts(slots)
    alt = np.flatnonzero(s_al > 0)
    a_var = s_var[alt]
    alt_len = np.fromiter(map(len, alts), np.int64, count=alt.size)

    def table(at_alt=None, fill=0, ref=None):
        """``at_alt`` at the ALT slots; elsewhere the variant's ``ref``
        value, or ``fill``."""
        t = np.full(pad + 1, fill, np.int64)
        if ref is not None:
            t[:pad] = ref[s_var]
        if at_alt is not None:
            t[alt] = at_alt
        return t

    s_idx = table(ref=idx_f)
    s_len = table(alt_len, ref=len_f)
    s_dv = table(alt_len - len_f[a_var])
    s_end = table(span_f[a_var])
    s_plen = table(alt_len)
    s_src = table(len(tmpl_all) + np.cumsum(alt_len) - alt_len)
    s_col = table(e_f[a_var] + 1, Vx)
    s_force = table(e_f[a_var], -1)

    # [Vx, C] tables: a variant's alleles and REF slot; the pads one
    # allele, the pad slot
    n_al = np.ones((Vx, C), np.int64)
    n_al[v_of, c_of] = n_alleles
    base = np.full((Vx, C), pad, np.int64)
    base[v_of, c_of] = base_f

    # ---- frontier expansion: each path's slot at each variant, every
    # cluster's rows in cluster order, in DFS (lexicographic) order
    cid = np.flatnonzero(n_var > 0)
    g = np.zeros((cid.size, 0), np.intp)
    force = np.full(cid.size, -1, np.int64)   # max skip end applied so far
    for v in range(Vx):
        counts = np.where(force >= v, 1, n_al[v][cid])
        rep = np.repeat(np.arange(g.shape[0]), counts)
        cid = cid[rep]
        col = base[v][cid] + _ranges_from_counts(counts)
        g = np.concatenate([g[rep], col[:, None]], axis=1)
        force = np.maximum(force[rep], s_force[col])
    P = g.shape[0]
    if P == 0:
        return empty

    gtp = s_al[g]
    o_idx = s_idx[g]
    len_path = s_len[g]
    dv = s_dv[g]
    # a path's next applied variant starts past the last one's skip
    # range, so its applied deltas land in distinct columns: a scatter,
    # not an add (the rest land, as 0, in column Vx)
    M = np.zeros((P, Vx + 1), np.int64)
    M.reshape(-1)[(np.arange(P) * (Vx + 1))[:, None] + s_col[g]] = dv
    idx_path = o_idx + np.cumsum(M, axis=1)[:, :Vx]
    t_len = tmpl_len[cid]
    seq_len = t_len + dv.sum(axis=1)

    # ---- string assembly: per path, pieces = for each APPLIED v a
    # template gap [prev_applied_end, orig_idx[v]) + the allele bytes,
    # then the template tail; separators (k-1 'N') close every path.
    # Piece table [P, 2Vx+2] row-major: gap0, al0, ..., tail, separator,
    # sources into ``combined``; everything T-sized stays int32/uint8
    # (fresh int64 pages made the first cut page-fault-bound).  A piece
    # of length 0 reads nothing, so its source is left as it falls.
    prev_end = np.zeros((P, Vx + 1), np.int64)
    np.maximum.accumulate(s_end[g], axis=1, out=prev_end[:, 1:])
    np.maximum(prev_end[:, 1:], 0, out=prev_end[:, 1:])
    gap_src = prev_end[:, :Vx]
    t_off = tmpl_off[cid]
    n_p = 2 * Vx + 2
    p_len = np.empty((P, n_p), np.int32)
    p_src = np.empty((P, n_p), np.int32)
    p_len[:, 0:2 * Vx:2] = np.where(gtp > 0, o_idx - gap_src, 0)
    p_src[:, 0:2 * Vx:2] = gap_src + t_off[:, None]
    p_len[:, 1:2 * Vx:2] = s_plen[g]
    p_src[:, 1:2 * Vx:2] = s_src[g]
    p_len[:, 2 * Vx] = t_len - prev_end[:, Vx]
    p_src[:, 2 * Vx] = prev_end[:, Vx] + t_off
    p_len[:, 2 * Vx + 1] = sep_len
    p_src[:, 2 * Vx + 1] = sep_off

    w1, w2 = _hash_weights(int((seq_len + sep_len).max()))
    stream, hashes = _assemble(combined, p_len, p_src, w1, w2)
    keep = _first_seen(hashes, seq_len, cid, combined, p_src, p_len) \
        if P > 1 else None
    if keep is not None:
        # rare: rebuild the packed stream from the kept rows only
        sel = np.flatnonzero(keep)
        stream, _ = _assemble(combined, p_len[sel], p_src[sel], w1, w2)
        gtp, cid = gtp[sel], cid[sel]
        idx_path, len_path, seq_len = idx_path[sel], len_path[sel], \
            seq_len[sel]
        P = sel.size
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(seq_len + sep_len, out=starts[1:])
    cl_off = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(cid, minlength=C), out=cl_off[1:])
    nis = np.maximum(0, seq_len - k + 1)
    adjust = _adjust_plane(stream, starts, nis, gtp, idx_path, len_path, k)
    return PathBlock(stream, starts, nis, seq_len, gtp, adjust, cl_off,
                     n_var)


def _adjust_plane(stream, starts, nis, gtp, idx_path, len_path,
                  k: int) -> np.ndarray:
    """The new-kmer plane over the stream's windows: score._flat_planes
    semantics, incl. the uint32-underflow quirk idxp + 1 >= k.  A path's
    intervals stay inside its own windows (hi <= its start + nis)."""
    n_win = max(0, stream.shape[0] - k + 1)
    ok = (gtp > 0) & (idx_path + 1 >= k)
    lo = starts[:-1, None] + np.maximum(0, idx_path + 1 - k)
    hi = starts[:-1, None] + np.minimum(nis[:, None],
                                        idx_path + len_path + k)
    ok &= lo < hi
    return _intervals_to_plane(lo[ok], hi[ok], n_win)
