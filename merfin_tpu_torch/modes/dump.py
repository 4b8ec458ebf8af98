"""The -dump mode (port of ``merfin_tpu/modes/dump.py:run_dump``):
per-base readK/asmK/K* rows, on one device, a mesh or a multi-process
launch (part files merged by rank 0).

Parity targets (merfin-dump.C:72-104):
  * rows "ident\\tpos\\treadK\\tasmK\\tk*" with %.2f floats, skipping
    positions where all three are 0.0,
  * with -skipMissing no output file is opened at all,
  * per-sequence stderr line "ident\\tmissing\\tcum_missing\\tcum_kasm"
    (the last two columns are CUMULATIVE, unlike -hist),
  * sequences emit in input order (merfin.C:384).

Rows are formatted by the native formatter on a thread pool (it
and gzip release the GIL), so chunk i formats while chunk i+1 computes;
for .gz outputs each chunk is its own gzip member.  Small sequences pack
into one group step, as in run_hist.  -resume restarts at a sequence
boundary through the checkpoint.
"""

from __future__ import annotations

import gzip
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from merfin_tpu_torch import native
from merfin_tpu_torch.io.fasta import SeqFile
from merfin_tpu_torch.modes.engine import SEG_MAX, KstarEngine
from merfin_tpu_torch.parallel import multihost as mh
from merfin_tpu_torch.utils.checkpoint import Checkpoint, truncate_to
from merfin_tpu_torch.utils.partmerge import (PartWriter, can_resume_part,
                                              merge_parts)
from merfin_tpu_torch.utils.prefetch import prefetch_iter


def format_rows(ident, start, rk, ak, km) -> bytes:
    """%.2f rows of the windows where any of readK, asmK, K* is non-zero."""
    block = native.format_dump_rows(ident, start, rk, ak, km)
    if block is None:           # no native library: pure Python
        parts = []
        for off in range(rk.shape[0]):
            r, a, m = rk[off], ak[off], km[off]
            if r != 0.0 or a != 0.0 or m != 0.0:
                parts.append(
                    f"{ident}\t{start + off}\t{r:.2f}\t{a:.2f}\t{m:.2f}\n")
        block = "".join(parts).encode("ascii")
    return block


def run_dump(engine: KstarEngine, seq_file: SeqFile, out_name: str,
             skip_missing: bool = False, log=sys.stderr,
             resume: bool = False):
    g_missing = 0
    g_kasm = 0
    out = None
    is_gz = out_name is not None and out_name.endswith(".gz")

    # Multi-process, two shapes (cf. run_hist): striped, each process
    # takes its sequence stripe; or a host-spanning mesh
    # (engine.spans_hosts), every process drives the same sequences and
    # emits the chunk rows it owns, keyed by global chunk ordinal.  Each
    # rank writes a part file; rank 0 merges them back into the single
    # in-order output (merfin.C:384).
    multi = mh.is_active()
    spans = bool(getattr(engine, "spans_hosts", False))
    part = None
    pid, pcount = mh.process_info() if multi else (0, 1)

    # Resume: every rank keeps its own checkpoint and resumable part
    # file.  A spans loop runs collectives per sequence, so its ranks
    # must resume in lockstep: if their checkpoints disagree (killed
    # between a collective and the save), the mode restarts fresh.
    ckpt = Checkpoint(f"{out_name}.rank{pid}" if multi else out_name,
                      "dump", enabled=resume)
    skip = 0
    part_resume = None
    restored_chunk_base = 0
    if resume and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        g_missing = st["accum"]["missing"]
        g_kasm = st["accum"]["kasm"]
        restored_chunk_base = st["accum"].get("chunk_base", 0)
        if multi:
            part_resume = (st["accum"].get("n_extents", 0),
                           st["output_offset"])
            if not skip_missing and not can_resume_part(
                    out_name, pid, *part_resume):
                # torn part/idx state: restart this rank fresh rather
                # than resuming a skip whose rows are gone (in spans
                # mode the consensus below then restarts every rank)
                print("-- Part file state unusable; restarting fresh.",
                      file=log)
                skip = 0
                part_resume = None
                restored_chunk_base = 0
                g_missing = 0
                g_kasm = 0
        elif not skip_missing:
            truncate_to(out_name, st["output_offset"])
        if skip:
            print(f"-- Resuming after {skip} sequences.", file=log)
    if multi and spans and resume:
        skips = mh.allgather_scalar(float(skip))
        if not (skips == skips[0]).all():
            print("-- Rank checkpoints disagree; restarting -dump fresh.",
                  file=log)
            skip = 0
            part_resume = None
            restored_chunk_base = 0
            g_missing = 0
            g_kasm = 0
    if multi and not skip_missing:
        part = PartWriter(out_name, pid, resume_state=part_resume)

    def ckpt_accum() -> dict:
        a = {"missing": g_missing, "kasm": g_kasm}
        if part is not None:
            a["n_extents"] = len(part.extents)
        return a

    def format_and_zip(ident, start, rk, ak, km) -> bytes:
        data = format_rows(ident, start, rk, ak, km)
        return gzip.compress(data, compresslevel=1) if is_gz else data

    def write_seq(idx, blocks: list[bytes]) -> int:
        """Emit one sequence's rows; returns the output offset."""
        nonlocal out
        if skip_missing:
            return 0
        data = b"".join(blocks)
        if part is not None:
            part.write_seq(idx, data)
            if ckpt.enabled:
                part.flush_idx()
            return part.offset
        if out is None:
            out = open(out_name, "ab" if (resume and skip) else "wb")
        out.write(data)
        out.flush()
        return out.tell()

    # a mesh engine packs no groups (dump_group_capacity 0)
    cap = engine.dump_group_capacity
    group: list = []          # (seq_idx, seq)
    group_pos = 0

    def flush_group():
        nonlocal group, group_pos, g_kasm, g_missing
        if not group:
            return
        results = engine.dump_group([s.codes() for _, s in group])
        # with -skipMissing nothing is written: nothing to format
        futs = [None] * len(group) if skip_missing else [
            pool.submit(format_and_zip, s.ident, 0, rk, ak, km)
            for (_, s), (rk, ak, km, _, _) in zip(group, results)]
        offset = 0
        for (idx, s), (_, _, _, kasm, kmis), fut in zip(group, results,
                                                        futs):
            print(f"Processing sequence {s.ident} for dumping", file=log)
            print(f"Output sequence {s.ident}", file=log)
            offset = write_seq(idx, [fut.result()] if fut is not None else [])
            g_kasm += kasm
            g_missing += kmis
            print(f"{s.ident}\t{kmis}\t{g_missing}\t{g_kasm}", file=log)
        ckpt.save(group[-1][0], offset, ckpt_accum())
        group = []
        group_pos = 0

    def spans_sequence(seq_idx, seq) -> None:
        """One sequence on a host-spanning mesh: this rank's chunk rows
        to its part file by global ordinal, the counts summed over the
        ranks."""
        nonlocal chunk_base, g_kasm, g_missing
        print(f"Processing sequence {seq.ident} for dumping", file=log)
        kasm_l = mis_l = 0
        for ordinal, start, rk, ak, km, kasm, kmis in \
                engine.dump_sequence_local(seq.codes()):
            kasm_l += kasm
            mis_l += kmis
            if not skip_missing:
                part.write_seq(chunk_base + ordinal,
                               format_and_zip(seq.ident, start, rk, ak, km))
        n_pos = max(0, seq.length - engine.k + 1)
        chunk_base += -(-n_pos // engine.chunk)
        print(f"Output sequence {seq.ident}", file=log)
        merged = mh.merge_array_across_hosts(
            np.asarray([kasm_l, mis_l], dtype=np.int64))
        g_kasm += int(merged[0])
        seq_missing = int(merged[1])
        g_missing += seq_missing
        print(f"{seq.ident}\t{seq_missing}\t{g_missing}\t{g_kasm}",
              file=log)
        if ckpt.enabled:
            if part is not None:
                part.flush_idx()
            acc = ckpt_accum()
            acc["chunk_base"] = chunk_base
            ckpt.save(seq_idx, part.offset if part is not None else 0, acc)

    chunk_base = restored_chunk_base   # global chunk ordinal (spans keys)
    pool = ThreadPoolExecutor(max(2, min(8, os.cpu_count() or 2)))
    try:
        seq_idx = 0
        for seq in prefetch_iter(seq_file.iter_coded()):
            seq_idx += 1
            if seq_idx <= skip:
                continue
            if multi and not spans and (seq_idx - 1) % pcount != pid:
                continue
            if multi and spans:
                spans_sequence(seq_idx, seq)
                continue
            need = seq.length + engine.k - 1
            if need <= cap:
                if group_pos + need > cap or len(group) >= SEG_MAX:
                    flush_group()
                group.append((seq_idx, seq))
                group_pos += need
                continue
            flush_group()
            print(f"Processing sequence {seq.ident} for dumping", file=log)
            seq_missing = 0
            futs = []
            for start, rk, ak, km, kasm, kmis in engine.dump_sequence(
                    seq.codes()):
                g_kasm += kasm
                seq_missing += kmis
                if not skip_missing:
                    futs.append(pool.submit(format_and_zip, seq.ident, start,
                                            rk, ak, km))
            print(f"Output sequence {seq.ident}", file=log)
            offset = write_seq(seq_idx, [f.result() for f in futs])
            g_missing += seq_missing
            print(f"{seq.ident}\t{seq_missing}\t{g_missing}\t{g_kasm}",
                  file=log)
            ckpt.save(seq_idx, offset, ckpt_accum())
        flush_group()
    finally:
        pool.shutdown()
        if out is not None:
            out.close()
        if part is not None:
            part.close()

    if multi:
        if not spans:   # spans mode merged per sequence already
            g_missing = int(mh.merge_scalar_across_hosts(g_missing))
            g_kasm = int(mh.merge_scalar_across_hosts(g_kasm))
        mh.barrier("dump-parts")
        # the resume window closes here: a crash during the merge re-runs
        # the mode from scratch instead of resuming against consumed parts
        ckpt.done()
        mh.barrier("dump-ckpt-clear")
        if pid == 0 and not skip_missing:
            merge_parts(out_name, pcount)
        mh.barrier("dump-merged")

    ckpt.done()
    return {"missing": g_missing, "kasm": g_kasm}
