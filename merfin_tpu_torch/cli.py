"""Command-line interface of the torch port.

`merfin-tpu-torch` accepts the JAX CLI's flag set (merfin_tpu/cli.py,
itself the reference merfin's, merfin.C:80-155) so a pipeline switches
by swapping the binary name:

    merfin-tpu-torch -hist -sequence asm.fasta -readmers read.mkdb \\
                     -seqmers asm.mkdb -peak 106.7 -output out.hist

-hist and -dump run on the union sorted join (``-sortjoin`` is accepted),
-completeness on the single-value sorted join.  What is not ported yet
(the variant modes, -mesh, -hist -nosortjoin, a multi-host launch,
building the sequence DB when -seqmers is absent, the database tools)
exits with code 1 and a one-line error.  The device comes from
MERFIN_PLATFORM: ``cuda`` (default) or ``cpu``.
"""

from __future__ import annotations

import os
import sys

from merfin_tpu.config import MerfinConfig

_DB_SUBCOMMANDS = {
    "count", "print", "statistics", "histogram", "intersect", "union-sum",
    "subtract", "divide-round", "import", "export",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _DB_SUBCOMMANDS:
        return _not_ported(f"the database tool '{argv[0]}'")
    return merfin_main(argv)


def _not_ported(what: str) -> int:
    print(f"ERROR: {what} is not yet ported to merfin-tpu-torch "
          f"(use merfin-tpu).", file=sys.stderr)
    return 1


def merfin_main(argv: list[str]) -> int:
    cfg = MerfinConfig()
    errs: list[str] = []

    i = 0

    def nextarg() -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise IndexError
        return argv[i]

    mode_flags = {
        "-filter": "filter", "-better": "better", "-strict": "strict",
        "-loose": "loose", "-polish": "polish", "-hist": "hist",
        "-dump": "dump", "-completeness": "completeness",
    }
    setters = {
        "-sequence": ("seq_name", str), "-seqmers": ("seq_db_name", str),
        "-readmers": ("read_db_name", str), "-peak": ("peak", float),
        "-prob": ("prob_table", str), "-vcf": ("vcf_name", str),
        "-output": ("out_name", str), "-min": ("min_v", int),
        "-max": ("max_v", int), "-threads": ("threads", int),
        "-memory": ("max_memory_gb", float), "-comb": ("comb", int),
        "-mesh": ("mesh", str),
    }
    switches = {
        "-nosplit": ("nosplit", True), "-skipMissing": ("skip_missing", True),
        "-debug": ("debug", True), "-resume": ("resume", True),
        "-sortjoin": ("sortjoin", True), "-nosortjoin": ("sortjoin", False),
        "-devscore": ("devscore", True), "-nodevscore": ("devscore", False),
    }

    try:
        while i < len(argv):
            a = argv[i]
            if a in setters:
                attr, conv = setters[a]
                setattr(cfg, attr, conv(nextarg()))
            elif a in switches:
                setattr(cfg, *switches[a])
            elif a in mode_flags:
                if a == "-loose":
                    print("*EXPERIMENTAL* Running in -loose mode",
                          file=sys.stderr)
                cfg.report_type = mode_flags[a]
            else:
                errs.append(f"Unknown option '{a}'.\n")
            i += 1
    except IndexError:
        errs.append(f"Option '{argv[-1]}' needs an argument.\n")

    # input validation (merfin.C:157-182), as the JAX CLI does it
    vcf_modes = ("filter", "polish", "better", "strict", "loose")
    if cfg.report_type != "completeness":
        if cfg.seq_name is None:
            errs.append("No input sequences (-sequence) supplied.\n")
        if cfg.out_name is None:
            errs.append("No output (-output) supplied.\n")
    if cfg.report_type in vcf_modes and cfg.vcf_name is None:
        errs.append("No variant call input (-vcf) supplied; mandatory for -filter or -polish.\n")
    if cfg.report_type != "filter" and cfg.peak == 0:
        errs.append("No haploid peak (-peak) supplied.\n")
    if cfg.report_type == "completeness" and cfg.seq_name is None and cfg.seq_db_name is None:
        errs.append("No sequence meryl database (-seqmers) nor sequence (-sequence) supplied.\n")
    if cfg.report_type is None:
        errs.append("No report type (-filter, -polish, -hist, -dump, -completeness) supplied.\n")
    if cfg.read_db_name is None:
        errs.append("No read meryl database (-readmers) supplied.\n")

    if errs:
        _usage()
        for e in errs:
            sys.stderr.write(e)
        return 1

    return run(cfg)


def _usage() -> None:
    sys.stderr.write(
        "usage: merfin-tpu-torch <report-type>      \\\n"
        "         -sequence <seq.fasta>     \\\n"
        "         -readmers <read.mkdb>     \\\n"
        "         -seqmers  <seq.mkdb>      \\\n"
        "         -peak     <haploid_peak>  \\\n"
        "         -prob     <lookup_table>  \\\n"
        "         -output   <output>        \n"
        "\n"
        "  The PyTorch/CUDA port of merfin-tpu.  It accepts merfin-tpu's flags;\n"
        "  -hist, -dump and -completeness run (on the sorted-join kernels;\n"
        "  -sortjoin is accepted), -resume restarts -hist and -dump at a\n"
        "  sequence boundary.  The variant modes (-filter, -polish, -better,\n"
        "  -strict, -loose), -mesh, -hist -nosortjoin, multi-host launches,\n"
        "  building <seq.mkdb> (-seqmers absent) and the database tools are not\n"
        "  yet ported: use merfin-tpu for them.\n"
        "\n"
        "  -hist\n"
        "   Generate a 0-centered k* histogram for sequences in <input.fasta>.\n"
        "   Required: -sequence, -readmers, -seqmers, -peak, and -output.\n"
        "   Optional: -prob <file>  use probabilities to adjust multiplicity to copy number (recommended)\n"
        "             -min m / -max m  ignore read kmers with value below / above m\n"
        "             -memory m        don't use more than m GB memory for loading mers\n"
        "   Output: k* <tab> frequency; QV at the end, in stderr.\n"
        "\n"
        "  -dump\n"
        "   Dump readK, asmK, and k* per bases (k-mers) in <input.fasta>.\n"
        "   Required: -sequence, -readmers, -seqmers, -peak, and -output.\n"
        "   Optional: -prob <file>, -min m / -max m, -memory m as for -hist\n"
        "             -skipMissing     skip the missing kmer sites to be printed\n"
        "   Output: seqName <tab> seqPos <tab> readK <tab> asmK <tab> k*\n"
        "           (a .gz output name writes gzip)\n"
        "\n"
        "  -completeness\n"
        "   Compute kmer completeness using expected copy numbers for all kmers.\n"
        "   Required: -readmers, -seqmers, and -peak.\n"
        "   Optional: -prob <file>\n"
        "   Output: per-slice lines, TOTAL readK, TOTAL undrcpy and\n"
        "           COMPLETENESS, in stderr.\n"
        "\n"
        "  Device: MERFIN_PLATFORM=cuda (default) or cpu.\n"
        "\n\n"
    )


def _db_max(db) -> int:
    import numpy as np

    return int(np.asarray(db.vals).max()) if db.distinct else 1


def _unported(cfg: MerfinConfig) -> str | None:
    if cfg.report_type not in ("hist", "dump", "completeness"):
        return f"-{cfg.report_type}"
    if cfg.mesh:
        return "-mesh"
    if cfg.report_type == "hist" and cfg.sortjoin is False:
        return "-nosortjoin (the gather lookup path)"
    if int(os.environ.get("MERFIN_NUM_PROCESSES", "1") or "1") > 1:
        return "a multi-host launch (MERFIN_NUM_PROCESSES > 1)"
    if cfg.seq_db_name is None:
        return "building the sequence database (-seqmers not given)"
    return None


def run(cfg: MerfinConfig) -> int:
    """Load DBs and run the report — the JAX CLI's run() for its ported
    part."""
    what = _unported(cfg)
    if what is not None:
        return _not_ported(what)

    import torch

    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.io.prob import load_prob_table
    from merfin_tpu.table.lookup import build_lookup
    from merfin_tpu_torch.device import get_device

    log = sys.stderr
    device = get_device()

    prob = load_prob_table(cfg.prob_table, log=log) if cfg.prob_table else None

    read_db = KmerDB(cfg.read_db_name)
    asm_db = KmerDB(cfg.seq_db_name)
    if read_db.k != asm_db.k:
        print(f"ERROR: k mismatch: read db k={read_db.k}, seq db k={asm_db.k}",
              file=log)
        return 1
    k = read_db.k

    # memory estimate + fail-fast (merfin-globals.C:134-153)
    req = read_db.estimate_memory_gb() + asm_db.estimate_memory_gb()
    print(f"-- Estimating required space for loading '{cfg.read_db_name}'", file=log)
    print(f"-- Estimating required space for loading '{cfg.seq_db_name}'", file=log)
    print("--", file=log)
    print(f"-- Memory needed: {req:.3f} GB", file=log)
    print(f"-- Memory limit:  {cfg.max_memory_gb:.3f} GB", file=log)
    print("--", file=log)
    if req > cfg.max_memory_gb:
        print("\nNot enough memory to load databases.  Increase -memory.\n", file=log)
        return 1

    # device-memory fail-fast: the tables must fit the card they go to
    # (as in the JAX CLI, not for -completeness, whose read DB streams)
    if device.type == "cuda" and cfg.report_type != "completeness":
        hbm_gb = torch.cuda.mem_get_info(device)[1] / 1024**3
        if req > 0.92 * hbm_gb:    # headroom for batches
            print(f"\nLookup tables need {req:.1f} GB per device but "
                  f"device HBM is {hbm_gb:.1f} GB.", file=log)
            return 1

    if cfg.report_type == "completeness":
        from merfin_tpu_torch.modes.completeness import run_completeness

        print("-- Compute completeness.", file=log)
        run_completeness(read_db, asm_db, cfg.peak, prob_table=prob, log=log,
                         device=device)
        print("Bye!", file=log)
        return 0

    print(f"-- Loading kmers from '{cfg.read_db_name}' into lookup table.", file=log)
    read_lookup = build_lookup(read_db, min_v=cfg.min_v, max_v=cfg.max_v,
                               host=True)
    print(f"-- Loading kmers from '{cfg.seq_db_name}' into lookup table.", file=log)
    asm_lookup = build_lookup(asm_db, host=True)

    seq_file = SeqFile(cfg.seq_name)

    from merfin_tpu_torch.modes.engine import KstarEngine

    def make_engine():
        return KstarEngine(read_lookup, asm_lookup, k, cfg.peak,
                           prob_table=prob, max_value=_db_max(read_db),
                           exact_max=True, asm_max_value=_db_max(asm_db),
                           device=device)

    if cfg.report_type == "hist":
        from merfin_tpu_torch.modes.hist import run_hist

        print(f"-- Generate histogram of the k* metric to '{cfg.out_name}'.", file=log)
        engine = make_engine()
        print("-- Using sorted-join lookup kernel for -hist.", file=log)
        run_hist(engine, seq_file, cfg.out_name, log=log, resume=cfg.resume)
    else:
        from merfin_tpu_torch.modes.dump import run_dump

        print(f"-- Dump per-base k* metric to '{cfg.out_name}'.", file=log)
        run_dump(make_engine(), seq_file, cfg.out_name,
                 skip_missing=cfg.skip_missing, log=log, resume=cfg.resume)
    print("Bye!", file=log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
