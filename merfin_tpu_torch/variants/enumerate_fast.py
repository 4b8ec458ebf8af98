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

    def assemble_native(lib, p_len32, p_src32):
        """One C pass: pieces -> 2-bit codes + per-path hashes
        (native/fastio.cpp mt_assemble_paths; ~20x the numpy
        multi-pass on this host, docs/PERF.md r4)."""
        import ctypes

        Pn = p_len32.shape[0]
        T = int(p_len32.sum(dtype=np.int64))
        codes = np.empty(max(T, 1), np.uint8)
        hashes = np.empty(max(Pn, 1), np.uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mt_assemble_paths(
            combined.ctypes.data_as(u8p),
            np.ascontiguousarray(p_src32).ctypes.data_as(i32p),
            np.ascontiguousarray(p_len32).ctypes.data_as(i32p),
            Pn, n_p,
            w1.ctypes.data_as(u32p), w2.ctypes.data_as(u32p),
            codes.ctypes.data_as(u8p), hashes.ctypes.data_as(u64p))
        return codes[:T], hashes[:Pn]

    def assemble_numpy(p_len32, p_src32):
        """Fallback: src_idx[pos] = pos + (src - piece_start) repeated
        per piece; one repeat + in-place add + one gather; same hashes."""
        flat_len = p_len32.reshape(-1)
        flat_src = p_src32.reshape(-1)
        T = int(flat_len.sum(dtype=np.int64))
        # i32 gather indices would silently wrap past 2^31 assembled
        # bytes (~10M-path clusters); widen on the rare huge block
        idt = np.int64 if T >= 2**31 else np.int32
        piece_start = (np.cumsum(flat_len, dtype=np.int64)
                       - flat_len).astype(idt)
        src_idx = np.repeat(flat_src.astype(idt) - piece_start, flat_len)
        src_idx += np.arange(T, dtype=idt)
        raw = combined[src_idx]
        plen = p_len32.sum(axis=1)
        st = np.zeros(p_len32.shape[0] + 1, np.int64)
        np.cumsum(plen, out=st[1:])
        rel = np.repeat((-st[:-1]).astype(idt), plen)
        rel += np.arange(T, dtype=idt)
        h1 = np.add.reduceat(w1[rel] * raw, st[:-1])
        h2 = np.add.reduceat(w2[rel] * raw, st[:-1])
        hashes = (h1.astype(np.uint64) << np.uint64(32)) | h2
        return _CODE_TAB[raw], hashes

    from merfin_tpu_torch.native import get_lib

    lib = get_lib()
    native = lib is not None and hasattr(lib, "mt_assemble_paths")
    assemble = (lambda pl, ps: assemble_native(lib, pl, ps)) if native \
        else assemble_numpy

    stream, hashes = assemble(p_len, p_src)
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(seq_len + sep_len, out=starts[1:])

    # ---- first-seen dedup by string (varMer.C:38-45): 2x32-bit
    # position-weighted wrap-around hashes + length screen; byte-compare
    # confirms inside hash-equal groups (collisions keep both; equal
    # bytes drop later) — sound: distinct hashes imply distinct strings.
    keep = None
    if P > 1:
        # mix the length into the 64-bit hash: equal strings still map
        # equal (sound); a 1-D unique beats the axis=0 structured path
        mixed = hashes + seq_len.astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        _, inv, cnt = np.unique(mixed, return_inverse=True,
                                return_counts=True)
        if np.any(cnt > 1):
            def row_bytes(r):
                pieces = [combined[p_src[r, j]: p_src[r, j] + p_len[r, j]]
                          for j in range(n_p)]
                return np.concatenate(pieces)[: int(seq_len[r])]

            keep = np.ones(P, bool)
            order = np.argsort(inv, kind="stable")
            pos = np.cumsum(cnt) - cnt
            for g in np.flatnonzero(cnt > 1):
                rows = order[pos[g]: pos[g] + cnt[g]]
                kept_bytes = []
                for r in rows:
                    b = row_bytes(r)
                    dup = any(b.size == kb.size and np.array_equal(b, kb)
                              for kb in kept_bytes)
                    if dup:
                        keep[r] = False
                    else:
                        kept_bytes.append(b)

    if keep is not None and not keep.all():
        # rare: rebuild the packed stream from the kept rows only
        sel = np.flatnonzero(keep)
        stream, _ = assemble(p_len[sel], p_src[sel])
        gtp = gtp[sel]
        gtp64 = gtp64[sel]
        idx_path = idx_path[sel]
        len_path = len_path[sel]
        seq_len = seq_len[sel]
        P = sel.size
        starts = np.zeros(P + 1, np.int64)
        np.cumsum(seq_len + sep_len, out=starts[1:])
    n_win = max(0, stream.shape[0] - k + 1)
    lens = seq_len
    nis = np.maximum(0, lens - k + 1)

    # adjust plane intervals (score._flat_planes semantics, incl. the
    # uint32-underflow quirk idxp + 1 >= k)
    ok = (gtp64 > 0) & (idx_path + 1 >= k)
    lo = starts[:-1, None] + np.maximum(0, idx_path + 1 - k)
    hi = starts[:-1, None] + np.minimum(nis[:, None],
                                        idx_path + len_path + k)
    ok &= lo < hi
    adjust = _intervals_to_plane(lo[ok], hi[ok], n_win)

    return PathBlock(stream, starts, nis, lens,
                     gtp.astype(np.int16), adjust)
