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
  * the host scorer (``merfin_tpu_torch/variants/score.py``), whose table
    lookups come from the caller (the CLI gives it the union join):
    VarPath lists, budgeted batches, -debug.

The host helpers (cluster preparation, the enumeration and selection
tasks, the debug writer) are copies of the JAX package's
(``merfin_tpu/modes/variants.py``).  Under a multi-process launch each
rank writes a part file of its sequence stripe (merged by rank 0), or,
on a host-spanning mesh, every rank evaluates every cluster and rank 0
writes.  This module imports no torch: the spawned enumeration workers
import it to run their tasks.
"""

from __future__ import annotations

import collections
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from merfin_tpu_torch.io.compressed import open_write_text
from merfin_tpu_torch.io.fasta import SeqFile, Sequence
from merfin_tpu_torch.io.vcf import PosGT, VcfFile
from merfin_tpu_torch.score.kstar import ProbTable
from merfin_tpu_torch.utils.checkpoint import Checkpoint, truncate_to
from merfin_tpu_torch.variants import select
from merfin_tpu_torch.variants.enumerate import VarPath, enumerate_paths
from merfin_tpu_torch.variants.score import (PathScore, dispatch_blocks,
                                             fetch_blocks, score_path_groups)

MODES = ("filter", "polish", "better", "strict", "loose")
_LOOKAHEAD = 4       # clusters built ahead of the fused pipeline
_MAX_INFLIGHT = 8    # dispatched batches not yet fetched
_U32 = 1 << 32


def cluster_window(pos_gt: PosGT, k: int, seq_len: int) -> tuple[int, int]:
    """Padded window coordinates (merfin-variants.C:166-176), with the
    reference's uint32 arithmetic at the boundaries."""
    k_padd = k - 1
    r_start = pos_gt.r_start
    r_end = pos_gt.r_end
    if r_start > k_padd:
        r_start -= k_padd
    else:
        r_start = 0
    # uint32: seq_len - k_padd underflows for seq_len < k_padd
    limit = (seq_len - k_padd) % _U32
    if r_end < limit:
        r_end += k_padd
    else:
        r_end = seq_len
    return r_start, r_end


def prepare_cluster_args(
    seq: Sequence, pos_gt: PosGT, k: int, comb: int, log=sys.stderr
) -> tuple[int, int, tuple] | None:
    """Window math + PANIC checks for one cluster; returns
    (r_start, r_end, enumerate_paths args) or None on PANIC-skip.  The
    (CPU-heavy) enumeration itself runs separately so -threads can fan it
    out over worker processes."""
    r_start, r_end = cluster_window(pos_gt, k, seq.length)

    ref_idx = [(gt.pos - r_start) % _U32 for gt in pos_gt.gts]
    ref_len = [gt.ref_len for gt in pos_gt.gts]
    haps = [gt.alleles for gt in pos_gt.gts]

    template = seq.copy_region(r_start, r_end)
    if template is None:
        print(f"PANIC : Invalid region specified: {seq.ident} : {r_start} - {r_end}",
              file=log)
        return None

    if len(ref_idx) > comb:
        print(f"PANIC : Combination {seq.ident}:{r_start}-{r_end} has too many "
              f"variants ( found {len(pos_gt.gts)} > {comb} ) to evaluate. "
              f"Consider filtering the vcf upfront. Skipping...", file=log)
        return None

    return r_start, r_end, (template.decode("ascii"), ref_idx, ref_len, haps)


def prepare_cluster(
    seq: Sequence, pos_gt: PosGT, k: int, comb: int, log=sys.stderr
) -> tuple[int, int, list[VarPath]] | None:
    """Enumerate one cluster; None on PANIC-skip."""
    r = prepare_cluster_args(seq, pos_gt, k, comb, log=log)
    if r is None:
        return None
    return r[0], r[1], _enumerate_task(r[2])


_POOL_MIN_PATHS = 64   # ship a cluster to a worker only past this size


def _est_paths(haps) -> int:
    """Upper bound on enumerated paths for a cluster (product of allele
    counts, capped)."""
    est = 1
    for h in haps:
        est *= max(1, len(h))
        if est >= 1 << 20:
            break
    return est


def _enumerate_task(args):
    """Worker task: REF/ALT path enumeration (merfin-variants.C:22-126)."""
    if args is None:
        return None
    template, ref_idx, ref_len, haps = args
    return enumerate_paths(template, ref_idx, ref_len, haps)


def _enumerate_block_task(args):
    """Worker task for the fused-scorer path: the array-native
    enumeration (variants/enumerate_fast.py — no per-path Python
    objects; ~15x the scalar traverse at comb=15 scale) builds the
    PathBlock directly, so the stream assembly and adjust-plane build
    parallelize across clusters and the result pickles as numpy
    buffers."""
    if args is None:
        return None
    enum_args, k = args
    from merfin_tpu_torch.variants.enumerate_fast import build_path_block_fast

    return build_path_block_fast(*enum_args, k)


def _select_block_task(args):
    """Array-native twin of _select_task over a PathBlock + its device-
    reduced (num_m, totdk) arrays."""
    import io as _io

    mode, block, scores, pos_gt, k = args
    nm, td = scores
    warn = _io.StringIO()
    res = select.select_block(mode, nm, td, block.lens, block.gtp,
                              pos_gt, k, log=warn)
    if isinstance(res, list):     # filter mode returns records
        res = "".join(r.save() for r in res)
    return res, warn.getvalue()


def _select_task(args):
    """Worker task: per-cluster mode selection -> (result text, warnings).

    Pure function of the scored paths; loose-mode warnings come back as
    text so the parent prints them in deterministic order.
    """
    import io as _io

    mode, paths, scores, pos_gt, k = args
    warn = _io.StringIO()
    if mode == "polish":
        res = select.best_variant(paths, scores, pos_gt, k)
    elif mode == "better":
        res = select.better_variant(paths, scores, pos_gt, k)
    elif mode == "strict":
        res = select.strict_polish(paths, scores, pos_gt, k)
    elif mode == "loose":
        res = select.loose_polish(paths, scores, pos_gt, k, log=warn)
    else:
        recs = select.best_filter(paths, scores, pos_gt, k)
        res = "".join(r.save() for r in recs)
    return res, warn.getvalue()


class DebugWriter:
    """Per-path debug log (merfin-variants.C:240-276).

    The reference writes one gz per worker thread with thread-local
    sequential varMerIds; here the analog writer unit is the process:
    single-host runs land everything in `<out>.00.debug.gz`, multi-host
    striped runs write `<out>.<RANK>.debug.gz` per rank (each covering
    that rank's sequence stripe, rank-local sequential ids — exactly the
    reference's per-thread split).
    """

    def __init__(self, out_name: str, writer_id: int = 0):
        self.file = open_write_text(f"{out_name}.{writer_id:02d}.debug.gz")
        self.var_mer_id = 0

    def emit(self, ident: str, r_start: int, r_end: int, pos_gt: PosGT,
             paths: list[VarPath], scores: list[PathScore]) -> None:
        for p, s in zip(paths, scores):
            parts = [
                f"{self.var_mer_id}\t{ident}:{r_start}-{r_end}\t{p.seq}\t{s.num_m}\t"
                f"{select.min_abs_k(s):.5f}\t{select.max_abs_k(s):.5f}\t"
                f"{select.med_abs_k(s):.5f}\t{select.avg_abs_k(s):.5f}\t"
                f"{select.tot_dk(s):.5f}\t"
            ]
            self.var_mer_id += 1
            for i, alt_idx in enumerate(p.gt_path):
                if alt_idx > 0:
                    gt = pos_gt.gts[i]
                    parts.append(f"{pos_gt.chrom} {gt.pos + 1} . "
                                 f"{gt.alleles[0]} {gt.alleles[alt_idx]} . PASS . GT 1/1  ")
            parts.append("\n")
            self.file.write("".join(parts))

    def close(self) -> None:
        self.file.close()


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
                 threads: int = 1, spans: bool = False, scorer=None):
    """Variant-mode driver.  ``scorer`` (a DeviceScorer) takes the fused
    path; without it, ``lookup_read``/``lookup_asm`` (numpy u64 -> u64)
    feed the host scorer.  ``threads`` > 1 (0 = all cores) enumerates
    heavy clusters on a spawned process pool; output order never
    depends on it.  ``spans``: the lookups ride a mesh over several
    processes.  Returns {"records": n}."""
    # the parent only: the spawned workers never import torch
    from merfin_tpu_torch.parallel import multihost as mh
    from merfin_tpu_torch.utils.partmerge import (PartWriter,
                                                  can_resume_part,
                                                  merge_parts)

    assert mode in MODES
    if debug and scorer is not None:
        raise ValueError("-debug needs per-window K* stats; "
                         "it cannot run with the device scorer (-devscore)")
    if not threads:
        threads = os.cpu_count() or 1

    pool = None

    def get_pool():
        """The worker pool, spawned at the first heavy cluster.  spawn,
        not fork: the parent holds CUDA state (and the process group),
        and the workers run only the numpy/native enumeration."""
        nonlocal pool
        if pool is None:
            import multiprocessing as mp

            pool = mp.get_context("spawn").Pool(threads)
        return pool

    out_path = f"{out_name}.{'polish' if mode == 'polish' else 'filter'}.vcf"
    out = None

    # Multi-process, two shapes:
    #  * striped: sequence stripes -> per-process part files (no
    #    headers) -> ordered merge with the headers by rank 0;
    #  * ``spans`` (host-spanning mesh lookups): the sharded table needs
    #    every process in each probe, so all ranks evaluate every
    #    cluster and only rank 0 writes.
    multi = mh.is_active()
    part = None
    pid, pcount = mh.process_info() if multi else (0, 1)
    striped = multi and not spans

    # Debug writers follow the reference's per-thread split (one gz per
    # writer unit): per rank for striped runs; in spans mode every rank
    # evaluates identically, so only rank 0 writes.
    dbg = DebugWriter(out_name, pid if striped else 0) \
        if debug and (not multi or striped or pid == 0) else None

    # checkpoint/resume at the sequence boundary (not with -debug: the
    # debug gz stream is not offset-restartable).  Striped ranks keep
    # per-rank checkpoints and resumable part files (no collective runs
    # inside the striped loop); spans ranks share rank 0's checkpoint,
    # which only rank 0 writes.
    ckpt = Checkpoint(f"{out_name}.rank{pid}" if striped else out_name,
                      f"variants-{mode}", enabled=resume and not debug,
                      writer=striped or (not multi) or pid == 0)
    skip = 0
    part_resume = None
    n_selected = 0
    if resume and not debug and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        n_selected = st["accum"].get("records", 0)
        if striped:
            part_resume = (st["accum"].get("n_extents", 0),
                           st["output_offset"])
            if not can_resume_part(out_path, pid, *part_resume):
                # torn part/idx state on disk: restart this rank's stripe
                # rather than dropping the checkpointed rows
                print("-- Part file state unusable; restarting this "
                      "rank's stripe fresh.", file=log)
                skip = 0
                part_resume = None
                n_selected = 0
        elif not multi or pid == 0:
            truncate_to(out_path, st["output_offset"])
        if skip:
            print(f"-- Resuming after {skip} sequences.", file=log)
    if striped:
        part = PartWriter(out_path, pid, resume_state=part_resume)

    # the fused path's array-native enumeration is ~6x faster than the
    # scalar one, so its pool pays off only from 3 workers
    min_workers = 3 if scorer is not None else 2
    ok = False
    try:
        for seq_idx, seq in enumerate(seq_file, 1):
            if seq_idx <= skip:
                continue
            if striped and (seq_idx - 1) % pcount != pid:
                continue
            # the reference opens the output (headers included) at the
            # first sequence, variants or not (merfin-variants.C:313-341)
            if out is None and (not multi or (spans and pid == 0)):
                out = open(out_path, "ab" if skip else "wb")
                if not skip:
                    out.write("".join(h + "\n"
                                      for h in vcf.headers).encode())
            clusters = vcf.by_chrom.get(seq.ident)
            if clusters is None:
                if out is not None:
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
            if part is not None:
                part.write_seq(seq_idx, text.encode())
                if ckpt.enabled:
                    part.flush_idx()
                    ckpt.save(seq_idx, part.offset,
                              {"n_extents": len(part.extents),
                               "records": n_selected})
            elif out is not None:
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
        if part is not None:
            part.close()
    if multi and spans:
        mh.barrier("variants-spans-done")   # ranks computed identically
    elif multi:
        n_selected = int(mh.merge_scalar_across_hosts(n_selected))
        mh.barrier("variants-parts")
        # drop per-rank checkpoints BEFORE the merge consumes the parts: a
        # crash inside the merge re-runs from scratch instead of resuming
        # against missing part files
        ckpt.done()
        mh.barrier("variants-ckpt-clear")
        if pid == 0:
            header = "".join(h + "\n" for h in vcf.headers).encode()
            merge_parts(out_path, pcount, header=header)
        mh.barrier("variants-merged")
    if dbg is not None:
        dbg.close()
    ckpt.done()
    return {"records": n_selected}
