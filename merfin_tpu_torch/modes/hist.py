"""The -hist mode (port of ``merfin_tpu/modes/hist.py:run_hist``):
per-sequence QV lines, the k* histogram file and the QV/QV* summary,
byte-identical to the JAX package, on one device, a mesh
(``parallel/engine.py``) or a multi-process launch.

Output parity targets:
  * per-sequence stderr line "ident\\tmissing\\tcum_missing\\tkasm\\tQV"
    (merfin-histogram.C:128-133),
  * histogram file: negative undr bins high->1, a combined 0.0 line, then
    positive over bins (merfin-histogram.C:149-163),
  * stderr summary with Missing QV / Merfin QV* (merfin-histogram.C:167-175).
"""

from __future__ import annotations

import sys
from collections import deque

import numpy as np

from merfin_tpu_torch.io.compressed import open_write_text
from merfin_tpu_torch.io.fasta import SeqFile
from merfin_tpu_torch.score.kstar import histo_qv
from merfin_tpu_torch.utils.checkpoint import Checkpoint
from merfin_tpu_torch.utils.prefetch import prefetch_iter
from merfin_tpu_torch.modes.engine import SEG_MAX, BinOverflow, KstarEngine
from merfin_tpu_torch.parallel import multihost as mh


def run_hist(engine: KstarEngine, seq_file: SeqFile, out_name: str,
             log=sys.stderr, resume: bool = False):
    k = engine.k
    g_missing = 0
    g_kasm = 0
    g_kover = 0.0
    g_undr = np.zeros(engine.nbins, dtype=np.int64)
    g_over = np.zeros(engine.nbins, dtype=np.int64)

    def grow(min_bins: int):
        """Grow the engine's bins and the global accumulators; the caller
        retries the failed sequence/group."""
        nonlocal g_undr, g_over
        engine.grow_bins(min_bins)
        print(f"-- Growing k* histogram to {engine.nbins} bins.", file=log)
        g_undr = np.pad(g_undr, (0, engine.nbins - g_undr.size))
        g_over = np.pad(g_over, (0, engine.nbins - g_over.size))

    # Multi-process, two shapes:
    #  * striped (one engine per process): every process takes its
    #    sequence stripe, the accumulators merge at the end;
    #  * a host-spanning mesh (engine.spans_hosts): every process drives
    #    the SAME sequences and gets the same results, no merge.
    # Rank 0 writes the outputs in both.
    multi = mh.is_active()
    spans = bool(getattr(engine, "spans_hosts", False))
    pid = mh.process_info()[0] if multi else 0

    # Resume: striped ranks checkpoint their own stripe's partial
    # accumulators (a per-rank sidecar); spans ranks share rank 0's
    # checkpoint, which only rank 0 writes.
    striped = multi and not spans
    ckpt = Checkpoint(f"{out_name}.rank{pid}" if striped else out_name,
                      "hist", enabled=resume,
                      writer=striped or (not multi) or pid == 0)
    skip = 0
    if resume and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        a = st["accum"]
        g_missing, g_kasm, g_kover = a["missing"], a["kasm"], a["kover"]
        need = max(len(a["undr"]), len(a["over"]))
        if need > g_undr.size:     # the interrupted run had grown bins
            grow(need)
        g_undr[: len(a["undr"])] = a["undr"]
        g_over[: len(a["over"])] = a["over"]
        print(f"-- Resuming after {skip} sequences.", file=log)

    def seq_line(seq, stats):
        nonlocal g_missing, g_kasm
        g_missing += stats.kmissing
        g_kasm += stats.kasm
        qv = histo_qv(stats.kmissing, stats.kasm, k)
        print(f"{seq.ident}\t{stats.kmissing}\t{g_missing}\t{stats.kasm}\t{qv:.2f}",
              file=log)

    def save_ckpt(idx):
        nz_u = int(np.max(np.nonzero(g_undr)[0])) + 1 if g_undr.any() else 0
        nz_o = int(np.max(np.nonzero(g_over)[0])) + 1 if g_over.any() else 0
        ckpt.save(idx, 0, {
            "missing": g_missing, "kasm": g_kasm, "kover": g_kover,
            "undr": g_undr[:nz_u].tolist(), "over": g_over[:nz_o].tolist(),
        })

    # Small sequences pack into one group dispatch; up to 2 groups stay in
    # flight so group i+1's packing and copy overlap group i's compute.
    cap = engine.group_capacity
    group: list = []             # (seq_idx, seq)
    group_pos = 0
    in_flight: deque = deque()   # (group, handle)

    def drain_one():
        nonlocal g_kover
        grp, handle = in_flight.popleft()
        while True:
            try:
                stats_list, uh, oh, kover_g = engine.hist_group_finalize(
                    handle)
                break
            except BinOverflow as e:
                grow(e.max_idx + 1)
                handle = engine.hist_group_dispatch(
                    [s.codes() for _, s in grp])
        g_undr[: uh.size] += uh
        g_over[: oh.size] += oh
        g_kover += kover_g
        for (_, s), st in zip(grp, stats_list):
            print(f"Processing sequence {s.ident} for histogram", file=log)
            print(f"Output sequence {s.ident}", file=log)
            seq_line(s, st)
        save_ckpt(grp[-1][0])

    def flush_group(drain: bool = False):
        nonlocal group, group_pos
        if group:
            in_flight.append(
                (group, engine.hist_group_dispatch(
                    [s.codes() for _, s in group])))
            group = []
            group_pos = 0
        while len(in_flight) > (0 if drain else 1):
            drain_one()

    seqs = seq_file.iter_coded()
    if striped:
        seqs = mh.host_sequences(seqs)

    seq_idx = 0
    for seq in prefetch_iter(seqs):
        seq_idx += 1
        if seq_idx <= skip:
            continue
        need = seq.length + k - 1
        if cap and need <= cap:
            if group_pos + need > cap or len(group) >= SEG_MAX:
                flush_group()
            group.append((seq_idx, seq))
            group_pos += need
            continue
        flush_group(drain=True)
        print(f"Processing sequence {seq.ident} for histogram", file=log)
        while True:
            try:
                stats, undr, over = engine.hist_sequence(seq.codes())
                break
            except BinOverflow as e:
                grow(e.max_idx + 1)
        print(f"Output sequence {seq.ident}", file=log)
        g_kover += stats.kover_cpy
        g_undr[: undr.size] += undr
        g_over[: over.size] += over
        seq_line(seq, stats)
        save_ckpt(seq_idx)
    flush_group(drain=True)

    if striped:
        g_missing = int(mh.merge_scalar_across_hosts(g_missing))
        g_kasm = int(mh.merge_scalar_across_hosts(g_kasm))
        g_kover = mh.merge_scalar_across_hosts(g_kover)
        # ranks may have grown their bins independently: pad to the
        # global max before the elementwise sum
        nb = int(mh.max_scalar_across_hosts(g_undr.size))
        g_undr = mh.merge_array_across_hosts(
            np.pad(g_undr, (0, nb - g_undr.size)))
        g_over = mh.merge_array_across_hosts(
            np.pad(g_over, (0, nb - g_over.size)))

    if pid == 0:
        # histogram file (reportHistogram, merfin-histogram.C:141-163)
        with open_write_text(out_name) as f:
            for ii in range(g_undr.size - 1, 0, -1):
                if g_undr[ii] > 0:
                    f.write(f"{ii * -0.2:.1f}\t{g_undr[ii]}\n")
            f.write(f"{0.0:.1f}\t{g_undr[0] + g_over[0]}\n")
            for ii in range(1, g_over.size):
                if g_over[ii] > 0:
                    f.write(f"{ii * 0.2:.1f}\t{g_over[ii]}\n")

        print("", file=log)
        print(f"K-mers not found in reads (missing) : {g_missing}", file=log)
        print(f"K-mers overly represented in assembly: {g_kover:.2f}", file=log)
        print(f"K-mers found in the assembly: {g_kasm}", file=log)
        print(f"Missing QV: {histo_qv(g_missing, g_kasm, k):.2f}", file=log)
        print(f"Merfin QV*: {histo_qv(g_missing + g_kover, g_kasm, k):.2f}", file=log)
        print("*** Note this QV is valid only if -seqmer was generated with -sequence ***\n", file=log)
        print("*** Missing QV only considers missing kmers as errors. Merfin QV* includes overrepresented kmers. ***\n", file=log)
        print("*** When the lookup table is provided, missing QV includes weighted low frequency kmers, otherwise it is identical to Merqury QV. ***\n", file=log)
    if multi:
        mh.barrier("hist-done")

    ckpt.done()
    return {
        "missing": g_missing,
        "kasm": g_kasm,
        "kover_cpy": g_kover,
        "qv_missing": histo_qv(g_missing, g_kasm, k),
        "qv_star": histo_qv(g_missing + g_kover, g_kasm, k),
    }
