"""-dump mode driver (port of ``merfin_tpu/modes/dump.py:run_dump``,
single process): per-base readK/asmK/K* rows.

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

from merfin_tpu_torch import native
from merfin_tpu_torch.io.fasta import SeqFile
from merfin_tpu_torch.utils.checkpoint import Checkpoint, truncate_to
from merfin_tpu_torch.utils.prefetch import prefetch_iter
from merfin_tpu_torch.modes.engine import SEG_MAX, KstarEngine


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

    ckpt = Checkpoint(out_name, "dump", enabled=resume)
    skip = 0
    if resume and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        g_missing = st["accum"]["missing"]
        g_kasm = st["accum"]["kasm"]
        if not skip_missing:
            truncate_to(out_name, st["output_offset"])
        if skip:
            print(f"-- Resuming after {skip} sequences.", file=log)

    def format_and_zip(ident, start, rk, ak, km) -> bytes:
        data = format_rows(ident, start, rk, ak, km)
        return gzip.compress(data, compresslevel=1) if is_gz else data

    def write_seq(blocks: list[bytes]) -> int:
        """Emit one sequence's rows; returns the output offset."""
        nonlocal out
        if skip_missing:
            return 0
        if out is None:
            out = open(out_name, "ab" if (resume and skip) else "wb")
        out.write(b"".join(blocks))
        out.flush()
        return out.tell()

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
        for (_, s), (_, _, _, kasm, kmis), fut in zip(group, results, futs):
            print(f"Processing sequence {s.ident} for dumping", file=log)
            print(f"Output sequence {s.ident}", file=log)
            offset = write_seq([fut.result()] if fut is not None else [])
            g_kasm += kasm
            g_missing += kmis
            print(f"{s.ident}\t{kmis}\t{g_missing}\t{g_kasm}", file=log)
        ckpt.save(group[-1][0], offset, {"missing": g_missing, "kasm": g_kasm})
        group = []
        group_pos = 0

    pool = ThreadPoolExecutor(max(2, min(8, os.cpu_count() or 2)))
    try:
        seq_idx = 0
        for seq in prefetch_iter(seq_file.iter_coded()):
            seq_idx += 1
            if seq_idx <= skip:
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
            offset = write_seq([f.result() for f in futs])
            g_missing += seq_missing
            print(f"{seq.ident}\t{seq_missing}\t{g_missing}\t{g_kasm}",
                  file=log)
            ckpt.save(seq_idx, offset, {"missing": g_missing, "kasm": g_kasm})
        flush_group()
    finally:
        pool.shutdown()
        if out is not None:
            out.close()

    ckpt.done()
    return {"missing": g_missing, "kasm": g_kasm}
