"""Command-line interface of the torch port.

`merfin-tpu-torch` accepts the JAX CLI's flag set (merfin_tpu/cli.py,
itself the reference merfin's, merfin.C:80-155) so a pipeline switches
by swapping the binary name:

    merfin-tpu-torch -hist -sequence asm.fasta -readmers read.mkdb \\
                     -seqmers asm.mkdb -peak 106.7 -output out.hist

-hist and -dump run on the union sorted join (``-sortjoin`` and
``-nosortjoin`` are accepted; the JAX package's gather table is not
ported, so -nosortjoin only drops the line that names the sorted join),
-completeness on the single-value sorted join.  The variant modes
(-filter, -polish, -better, -strict, -loose) score candidate paths with
the fused device scorer or, for -debug, -nodevscore and -polish with a
-prob table, with the host scorer; both probe the union join.  Without
-seqmers every mode first counts <seq.fasta> into <basename>.meryl on
the device.  The meryl-analog database tools (count / import / print /
export / statistics / histogram / intersect / union-sum / subtract /
divide-round) live under the same binary:

    merfin-tpu-torch count k=21 reads.fastq.gz output read.mkdb

What is not ported yet (-mesh, a multi-host launch) exits with code 1
and a one-line error.  The device comes from MERFIN_PLATFORM: ``cuda``
(default) or ``cpu``.
"""

from __future__ import annotations

import os
import sys

from merfin_tpu_torch.config import MerfinConfig

_DB_SUBCOMMANDS = {
    "count", "print", "statistics", "histogram", "intersect", "union-sum",
    "subtract", "divide-round", "import", "export",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _DB_SUBCOMMANDS:
        return db_tool_main(argv)
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
        "  -hist, -dump, -completeness and the variant modes run (on the\n"
        "  sorted-join kernels; -sortjoin and -nosortjoin are accepted), -resume\n"
        "  restarts -hist, -dump and the variant modes at a sequence boundary.\n"
        "  Without -seqmers, <seq.fasta>.meryl is counted from -sequence first.\n"
        "  -mesh and multi-host launches are not yet ported: use merfin-tpu for\n"
        "  them.\n"
        "\n"
        "  -filter / -better / -strict / -loose / -polish\n"
        "   Score the variant calls of <input.vcf> by the k-mers they create or\n"
        "   remove.  -filter keeps the records that reduce missing k-mers\n"
        "   (output <output>.filter.vcf); -polish writes the best path of each\n"
        "   cluster as 1/1 (or 0/1, 1/2) records (<output>.polish.vcf); -better\n"
        "   and -strict keep the best path only if it beats the reference, -loose\n"
        "   also when it ties (both <output>.filter.vcf).\n"
        "   Required: -sequence, -readmers, -seqmers, -peak (not for -filter),\n"
        "             -vcf, and -output.\n"
        "   Optional: -prob <file>, -min m / -max m, -memory m as for -hist\n"
        "             -comb N          evaluate up to N variants together (default 15)\n"
        "             -nosplit         do not split clusters of more than N variants\n"
        "             -threads N       enumerate heavy clusters on N processes (0 = all cores)\n"
        "             -debug           per-path scores to <output>.00.debug.gz\n"
        "             -devscore / -nodevscore   fused device scoring (default: on,\n"
        "                              except for -debug and for -polish with -prob)\n"
        "             -resume          restart at the last finished sequence\n"
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
        "  Databases are MKDB directories (build with: merfin-tpu-torch count k=21\n"
        "  in.fq output db; add memory=GB to bound the counter with disk spill);\n"
        "  import a meryl db via its text dump: merfin-tpu-torch import dump.txt\n"
        "  output=db.  Other db tools: print statistics histogram intersect\n"
        "  union-sum subtract divide-round export.\n"
        "\n"
        "  Device: MERFIN_PLATFORM=cuda (default) or cpu.\n"
        "\n\n"
    )


def _db_max(db) -> int:
    import numpy as np

    return int(np.asarray(db.vals).max()) if db.distinct else 1


_MULTI_HOST = "a multi-host launch (MERFIN_NUM_PROCESSES > 1)"


def _multi_host() -> bool:
    return int(os.environ.get("MERFIN_NUM_PROCESSES", "1") or "1") > 1


def _unported(cfg: MerfinConfig) -> str | None:
    if cfg.mesh:
        return "-mesh"
    if _multi_host():
        return _MULTI_HOST
    return None


def run(cfg: MerfinConfig) -> int:
    """Load DBs and run the report — the JAX CLI's run() for its ported
    part."""
    what = _unported(cfg)
    if what is not None:
        return _not_ported(what)

    import torch

    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.mkdb import KmerDB, is_mkdb
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.device import get_device

    log = sys.stderr
    device = get_device()

    prob = load_prob_table(cfg.prob_table, log=log) if cfg.prob_table else None

    # Build the sequence DB if not provided (merfin-globals.C:166-189),
    # under the JAX CLI's condition.
    if cfg.report_type != "completeness" or cfg.seq_db_name is None:
        if cfg.seq_db_name is None:
            if cfg.read_db_name is None or not is_mkdb(cfg.read_db_name):
                print(f"ERROR: read database '{cfg.read_db_name}' is not an MKDB "
                      f"directory (build or import it first).", file=log)
                return 1
            k = KmerDB(cfg.read_db_name).k
            cfg.seq_db_name = f"{os.path.basename(cfg.seq_name)}.meryl"
            print(f"-- No -seqmer given. Build sequence db as '{cfg.seq_db_name}'.",
                  file=log)
            from merfin_tpu_torch.count.counter import count_files

            count_files([cfg.seq_name], k, cfg.seq_db_name, log=log)

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
        if cfg.sortjoin is not False:
            print("-- Using sorted-join lookup kernel for -hist.", file=log)
        run_hist(engine, seq_file, cfg.out_name, log=log, resume=cfg.resume)
    elif cfg.report_type == "dump":
        from merfin_tpu_torch.modes.dump import run_dump

        print(f"-- Dump per-base k* metric to '{cfg.out_name}'.", file=log)
        run_dump(make_engine(), seq_file, cfg.out_name,
                 skip_missing=cfg.skip_missing, log=log, resume=cfg.resume)
    elif _run_variant_mode(cfg, k, read_db, read_lookup, asm_lookup, prob,
                           seq_file, device, log) != 0:
        return 1
    print("Bye!", file=log)
    return 0


def _run_variant_mode(cfg: MerfinConfig, k: int, read_db, read_lookup,
                      asm_lookup, prob, seq_file, device, log) -> int:
    """The variant modes, as the JAX CLI runs them on one device: the VCF
    and its clusters, the devscore rule, then the fused device scorer or
    the host scorer, both on one union table."""
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes.variants import run_variants
    from merfin_tpu_torch.ops.union_join import UnionTable, host_lookups
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    print(f"-- Opening vcf file '{cfg.vcf_name}'.", file=log)
    vcf = VcfFile(cfg.vcf_name, log=log)
    print(f"Merge variants within {k}-mer bases, splitting combinations "
          f"greater than {cfg.comb}.", file=log)
    vcf.merge_clusters(k, cfg.comb, cfg.nosplit, log=log)

    print("-- Generate variant mers and score them.", file=log)
    # Fused device scoring is the default for the numM-only modes, and
    # for -polish when its totdk sums are integers (no -prob table, and
    # ValueMap.int_scorer_ok, checked below); -debug and -polish with a
    # -prob table keep the host scorer.
    use_dev = cfg.devscore
    if use_dev is None:
        use_dev = not cfg.debug and (
            cfg.report_type != "polish" or prob is None)
    elif use_dev and cfg.debug:
        print("ERROR: -debug needs per-window K* stats; it cannot run "
              "with -devscore.", file=log)
        return 1
    table = UnionTable.from_dbs(read_lookup.keys, read_lookup.vals,
                                asm_lookup.keys, asm_lookup.vals, device)
    scorer = None
    if use_dev:
        print("-- Using fused device scoring (-devscore).", file=log)
        scorer = DeviceScorer(table, k, cfg.peak, prob,
                              max_value=_db_max(read_db), exact_max=True)
        if (cfg.report_type == "polish" and cfg.devscore is None
                and not scorer.value_map.int_scorer_ok()):
            print("-- Device scoring lacks the integer fast path "
                  "here; using the host scorer for -polish.", file=log)
            scorer = None
    lookup_read, lookup_asm = host_lookups(table)
    try:
        run_variants(cfg.report_type, seq_file, vcf, k, lookup_read,
                     lookup_asm, cfg.peak, prob, cfg.out_name, comb=cfg.comb,
                     debug=cfg.debug, log=log, resume=cfg.resume,
                     threads=cfg.threads, scorer=scorer)
    finally:
        if scorer is not None:
            scorer.close()
    return 0


# ---------------- database tools (meryl analog) ----------------

def db_tool_main(argv: list[str]) -> int:
    """The JAX CLI's database tools (merfin_tpu/cli.py:db_tool_main): the
    same arguments, stdout and output DBs; ``count`` on the device."""
    if _multi_host():
        return _not_ported(_MULTI_HOST)
    from merfin_tpu_torch.count import algebra
    from merfin_tpu_torch.io import meryl_text
    from merfin_tpu_torch.io.mkdb import KmerDB

    cmd = argv[0]
    args = argv[1:]

    def split_kv(args):
        opts, pos = {}, []
        for a in args:
            if "=" in a and not os.path.exists(a):
                k, v = a.split("=", 1)
                opts[k] = v
            else:
                pos.append(a)
        return opts, pos

    opts, pos = split_kv(args)
    out = None
    if "output" in opts:
        out = opts["output"]
    elif "output" in pos:
        j = pos.index("output")
        out = pos[j + 1]
        pos = pos[:j] + pos[j + 2:]

    mem = float(opts["memory"]) if "memory" in opts else None

    def need(ok: bool, usage: str) -> None:
        if not ok:
            raise ValueError(usage)

    if cmd == "count":
        from merfin_tpu_torch.count.counter import count_files

        k = int(opts.get("k", 21))
        need(bool(out), "count: need output <db>")
        count_files(pos, k, out, memory_gb=mem, log=sys.stderr)
        return 0

    if cmd == "import":
        need(bool(out) and len(pos) == 1, "import: <text> output <db>")
        meryl_text.import_text(pos[0], out, memory_gb=mem)
        return 0

    if cmd in ("print", "export"):
        db = KmerDB(pos[0])
        if out:
            meryl_text.export_text(db, out)
        else:
            for i in range(db.distinct):
                sys.stdout.write(
                    f"{meryl_text.decode_kmer(int(db.keys[i]), db.k)}\t{int(db.vals[i])}\n")
        return 0

    if cmd == "statistics":
        st = algebra.statistics(KmerDB(pos[0]))
        sys.stdout.write(
            f"Number of {st['k']}-mers that are:\n"
            f"    unique   {st['unique']:>12}\n"
            f"    distinct {st['distinct']:>12}\n"
            f"    present  {st['present']:>12}\n")
        return 0

    if cmd == "histogram":
        for v, c in sorted(algebra.histogram(KmerDB(pos[0])).items()):
            sys.stdout.write(f"{v}\t{c}\n")
        return 0

    if cmd == "intersect":
        need(bool(out) and len(pos) >= 2, "intersect: <db> <db>... output <db>")
        algebra.intersect(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "union-sum":
        need(bool(out) and len(pos) >= 1, "union-sum: <db>... output <db>")
        algebra.union_sum(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "subtract":
        need(bool(out) and len(pos) >= 2, "subtract: <db> <db>... output <db>")
        algebra.subtract(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "divide-round":
        need(bool(out) and len(pos) == 2, "divide-round: <d> <db> output <db>")
        d = float(pos[0])
        algebra.divide_round(out, KmerDB(pos[1]), d)
        return 0

    sys.stderr.write(f"unknown db tool '{cmd}'\n")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
