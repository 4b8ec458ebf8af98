"""Variant report modes: -filter / -polish / -better / -strict / -loose
(port of ``merfin_tpu/modes/variants.py:run_variants``, single process).

Driver shape as in processVariants/outputVariants
(merfin-variants.C:131-345): for each sequence with clusters, window
math and PANIC checks, REF/ALT path enumeration, scoring, selection by
mode, in cluster order.  Output naming keeps the reference quirk:
``<out>.polish.vcf`` for -polish only, ``<out>.filter.vcf`` for every
other mode; the output opens at the first sequence and replays the input
headers.

Two scoring paths:
  * the fused device scorer (``variants/device_score.py``): array-native
    PathBlocks built up to four clusters ahead on a thread (heavy clusters on a
    spawned process pool), budgeted batches dispatched as they fill, up
    to ``_MAX_INFLIGHT`` batches in flight, selection as each batch is
    fetched;
  * the host scorer (shared ``merfin_tpu.variants.score``), whose table
    lookups come from the caller (the CLI gives it the union join):
    VarPath lists, budgeted batches, -debug.

The host helpers (cluster preparation, the enumeration and selection
tasks, the debug writer) are the JAX package's, which import no JAX.
Not ported: the multi-host branches (striped part files, spans).
"""

from __future__ import annotations

import collections
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from merfin_tpu.io.fasta import SeqFile
from merfin_tpu.io.vcf import VcfFile
from merfin_tpu.modes.variants import (_POOL_MIN_PATHS, DebugWriter,
                                       _enumerate_block_task,
                                       _enumerate_task, _est_paths,
                                       _select_block_task, _select_task,
                                       prepare_cluster_args)
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.utils.checkpoint import Checkpoint, truncate_to
from merfin_tpu.variants.score import (dispatch_blocks, fetch_blocks,
                                       score_path_groups)

MODES = ("filter", "polish", "better", "strict", "loose")
_LOOKAHEAD = 4       # clusters built ahead of the fused pipeline
_MAX_INFLIGHT = 8    # dispatched batches not yet fetched


def _score_fused(mode, prepared, task_args, heavy, get_pool, scorer, k,
                 query_budget):
    """Fused path for one sequence -> (blocks, scores, selected results)."""
    heavy_set = set(heavy)
    heavy_iter = iter(get_pool().imap(
        _enumerate_block_task, [task_args[i] for i in heavy])) \
        if heavy else None
    blocks: list = [None] * len(prepared)
    scores: list = [None] * len(prepared)
    selected: dict[int, tuple[str, str]] = {}
    futs: collections.deque = collections.deque()
    nxt = 0
    build_ex = ThreadPoolExecutor(max_workers=1)

    def submit_more():
        nonlocal nxt
        while nxt < len(prepared) and len(futs) < _LOOKAHEAD:
            futs.append(None if nxt in heavy_set else build_ex.submit(
                _enumerate_block_task, task_args[nxt]))
            nxt += 1

    def next_block():
        submit_more()
        f = futs.popleft()
        b = next(heavy_iter) if f is None else f.result()
        submit_more()
        return b

    def finish(a, b, tok):
        scores[a:b] = fetch_blocks(tok, scorer)
        for idx in range(a, b):
            if prepared[idx] is not None:
                selected[idx] = _select_block_task(
                    (mode, blocks[idx], scores[idx], prepared[idx][0], k))

    pending: collections.deque = collections.deque()
    try:
        i = 0
        while i < len(prepared):
            j = i
            budget = 0
            while j < len(prepared) and (budget == 0 or budget < query_budget):
                blocks[j] = next_block()
                if blocks[j] is not None:
                    budget += int(blocks[j].nis.sum())
                j += 1
            pending.append((i, j, dispatch_blocks(blocks[i:j], scorer, k)))
            if len(pending) > _MAX_INFLIGHT:
                finish(*pending.popleft())
            i = j
        while pending:
            finish(*pending.popleft())
    finally:
        # drop lookahead work if the device or selection step raised
        build_ex.shutdown(wait=False, cancel_futures=True)
    return blocks, scores, [selected[idx] for idx, e in enumerate(prepared)
                            if e is not None]


def _score_host(mode, prepared, task_args, heavy, get_pool, k, lookup_read,
                lookup_asm, peak, prob_table, threads, query_budget):
    """Host-scorer path for one sequence -> (paths, scores, selected)."""
    if heavy:
        heavy_set = set(heavy)
        async_res = get_pool().map_async(_enumerate_task,
                                         [task_args[i] for i in heavy])
        paths_list = [None if i in heavy_set else _enumerate_task(a)
                      for i, a in enumerate(task_args)]
        for i, r in zip(heavy, async_res.get()):
            paths_list[i] = r
    else:
        paths_list = [_enumerate_task(a) for a in task_args]

    scores: list = [None] * len(prepared)
    i = 0
    while i < len(prepared):
        j = i
        budget = 0
        groups: list = []
        while j < len(prepared) and (budget == 0 or budget < query_budget):
            pb = paths_list[j] or []
            budget += sum(max(0, len(p.seq) - k + 1) for p in pb)
            groups.append(pb)
            j += 1
        scores[i:j] = score_path_groups(
            groups, k, lookup_read, lookup_asm, peak, prob_table,
            mode == "filter", threads=max(1, threads))
        i = j
    selected = [_select_task((mode, paths_list[idx], scores[idx], e[0], k))
                for idx, e in enumerate(prepared) if e is not None]
    return paths_list, scores, selected


def run_variants(mode: str, seq_file: SeqFile, vcf: VcfFile, k: int,
                 lookup_read, lookup_asm, peak: float,
                 prob_table: ProbTable | None, out_name: str, comb: int = 15,
                 debug: bool = False, log=sys.stderr,
                 query_budget: int = 1 << 23, resume: bool = False,
                 threads: int = 1, scorer=None):
    """Variant-mode driver.  ``scorer`` (a DeviceScorer) takes the fused
    path; without it, ``lookup_read``/``lookup_asm`` (numpy u64 -> u64)
    feed the host scorer.  ``threads`` > 1 (0 = all cores) enumerates
    heavy clusters on a spawned process pool; output order never
    depends on it.  Returns {"records": n}."""
    assert mode in MODES
    if debug and scorer is not None:
        raise ValueError("-debug needs per-window K* stats; "
                         "it cannot run with the device scorer (-devscore)")
    if not threads:
        threads = os.cpu_count() or 1

    pool = None

    def get_pool():
        """The worker pool, spawned at the first heavy cluster.  spawn,
        not fork: the parent holds CUDA state, and the workers run only
        the numpy/native enumeration."""
        nonlocal pool
        if pool is None:
            import multiprocessing as mp

            pool = mp.get_context("spawn").Pool(threads)
        return pool

    out_path = f"{out_name}.{'polish' if mode == 'polish' else 'filter'}.vcf"
    out = None
    dbg = DebugWriter(out_name, 0) if debug else None

    # checkpoint/resume at the sequence boundary (not with -debug: the
    # debug gz stream is not offset-restartable)
    ckpt = Checkpoint(out_name, f"variants-{mode}",
                      enabled=resume and not debug)
    skip = 0
    n_selected = 0
    if resume and not debug and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        n_selected = st["accum"].get("records", 0)
        truncate_to(out_path, st["output_offset"])
        if skip:
            print(f"-- Resuming after {skip} sequences.", file=log)

    # the fused path's array-native enumeration is ~6x faster than the
    # scalar one, so its pool pays off only from 3 workers
    min_workers = 3 if scorer is not None else 2
    ok = False
    try:
        for seq_idx, seq in enumerate(seq_file, 1):
            if seq_idx <= skip:
                continue
            # the reference opens the output (headers included) at the
            # first sequence, variants or not (merfin-variants.C:313-341)
            if out is None:
                out = open(out_path, "ab" if skip else "wb")
                if not skip:
                    out.write("".join(h + "\n"
                                      for h in vcf.headers).encode())
            clusters = vcf.by_chrom.get(seq.ident)
            if clusters is None:
                ckpt.save(seq_idx, out.tell(), {"records": n_selected})
                continue
            print(f"Processing sequence {seq.ident} for variants", file=log)

            prepared = []
            for pos_gt in clusters:
                r = prepare_cluster_args(seq, pos_gt, k, comb, log=log)
                prepared.append(None if r is None
                                else (pos_gt, r[0], r[1], r[2]))
            enum_args = [p[3] if p is not None else None for p in prepared]
            # only combinatorially heavy clusters go to the pool: for
            # small ones the pickle round trip costs more than the work
            heavy = [i for i, a in enumerate(enum_args)
                     if a is not None
                     and _est_paths(a[3]) >= _POOL_MIN_PATHS] \
                if threads >= min_workers else []

            if scorer is not None:
                task_args = [(a, k) if a is not None else None
                             for a in enum_args]
                paths_list, all_scores, selected = _score_fused(
                    mode, prepared, task_args, heavy, get_pool, scorer, k,
                    query_budget)
            else:
                paths_list, all_scores, selected = _score_host(
                    mode, prepared, enum_args, heavy, get_pool, k,
                    lookup_read, lookup_asm, peak, prob_table, threads,
                    query_budget)

            parts: list[str] = []
            si = 0
            for idx, entry in enumerate(prepared):
                if entry is None:
                    continue
                pos_gt, r_start, r_end, _ = entry
                if dbg is not None:
                    dbg.emit(seq.ident, r_start, r_end, pos_gt,
                             paths_list[idx], all_scores[idx])
                res, warn = selected[si]
                si += 1
                if warn:
                    log.write(warn)
                parts.append(res)
            text = "".join(parts)
            n_selected += text.count("\n")
            out.write(text.encode())
            out.flush()
            ckpt.save(seq_idx, out.tell(), {"records": n_selected})
        ok = True
    finally:
        if pool is not None:
            if ok:
                pool.close()
            else:
                pool.terminate()
            pool.join()
        if out is not None:
            out.close()
        if dbg is not None:
            dbg.close()
    ckpt.done()
    return {"records": n_selected}
