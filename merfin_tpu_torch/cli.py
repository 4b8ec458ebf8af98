"""Command-line interface of the torch port.

`merfin-tpu-torch` accepts the JAX CLI's flag set (merfin_tpu/cli.py,
itself the reference merfin's, merfin.C:80-155) so a pipeline switches
by swapping the binary name:

    merfin-tpu-torch -hist -sequence asm.fasta -readmers read.mkdb \\
                     -seqmers asm.mkdb -peak 106.7 -output out.hist

The lookup routes are the JAX CLI's: -dump probes the gather tables
(``table/lookup.py``); -hist takes the union sorted join with
``-sortjoin`` and the gather tables with ``-nosortjoin``, and without
either the union join on a card and the gather tables on the CPU;
-completeness runs on the single-value sorted join.  The variant modes
(-filter, -polish, -better, -strict, -loose) score candidate paths with
the fused device scorer (the union join on a card, the gather tables on
the CPU), -polish with a -prob table included, or, for -debug and
-nodevscore, with the host scorer, which probes the gather tables.  Without
-seqmers every mode first counts <seq.fasta> into <basename>.meryl on
the device.  The meryl-analog database tools (count / import / print /
export / statistics / histogram / intersect / union-sum / subtract /
divide-round) live under the same binary:

    merfin-tpu-torch count k=21 reads.fastq.gz output read.mkdb

``-mesh DxT`` shards both tables over a D x T device mesh for every
report type (``parallel/``); a multi-process launch (MERFIN_NUM_PROCESSES,
MERFIN_PROCESS_ID, MERFIN_COORDINATOR on every process) joins one
torch.distributed job, stripes sequences, DB slices or input blocks over
the processes, and rank 0 writes the merged outputs.  The device comes
from MERFIN_PLATFORM: ``cuda`` (default) or ``cpu``; on the CPU a mesh
has MERFIN_CPU_DEVICES logical devices (default 1).
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


def merfin_main(argv: list[str]) -> int:
    cfg = MerfinConfig()
    trace = None                         # -trace FILE: not a reference flag
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
            elif a == "-trace":
                trace = nextarg()
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

    return run(cfg) if trace is None else _run_traced(cfg, trace)


def _run_traced(cfg: MerfinConfig, trace: str) -> int:
    """run() with the program's spans recorded (utils/spans.py), written
    at the end to ``trace`` as Chrome trace-event JSON with each
    kernel's launches; each rank of a multi-process launch writes
    ``trace``.rank<N>."""
    from merfin_tpu_torch.utils import spans

    spans.clear()
    spans.enable()
    try:
        return run(cfg)
    finally:
        spans.disable()
        from merfin_tpu_torch.ops._build import Kernel
        from merfin_tpu_torch.parallel import multihost as mh

        launches: dict[str, int] = {}
        for kern in Kernel.instances:
            launches[kern.name] = launches.get(kern.name, 0) + kern.launches
        path = trace
        if mh.is_active():
            path += f".rank{mh.process_info()[0]}"
        spans.write_chrome(path, {"kernel launches": launches})


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
        "  -hist, -dump, -completeness and the variant modes run, -resume\n"
        "  restarts -hist, -dump and the variant modes at a sequence boundary.\n"
        "  Without -seqmers, <seq.fasta>.meryl is counted from -sequence first.\n"
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
        "                              except for -debug)\n"
        "             -resume          restart at the last finished sequence\n"
        "\n"
        "  -hist\n"
        "   Generate a 0-centered k* histogram for sequences in <input.fasta>.\n"
        "   Required: -sequence, -readmers, -seqmers, -peak, and -output.\n"
        "   Optional: -prob <file>  use probabilities to adjust multiplicity to copy number (recommended)\n"
        "             -min m / -max m  ignore read kmers with value below / above m\n"
        "             -memory m        don't use more than m GB memory for loading mers\n"
        "             -sortjoin / -nosortjoin   probe the union sorted join / the\n"
        "                              gather tables (default: the join on cuda,\n"
        "                              the gather tables on cpu)\n"
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
        "  -mesh DxT        shard the lookup tables over a DxT device mesh (all report types)\n"
        "  -trace FILE      write the run's host spans and kernel launches to FILE as\n"
        "                   Chrome trace-event JSON (opens in Perfetto; FILE.rank<N> a rank)\n"
        "  Multi-host: set MERFIN_NUM_PROCESSES, MERFIN_PROCESS_ID and MERFIN_COORDINATOR\n"
        "  (host:port) on every process; sequences/DB slices stripe across processes and\n"
        "  rank 0 writes the merged outputs.\n"
        "\n"
        "  Device: MERFIN_PLATFORM=cuda (default) or cpu (MERFIN_CPU_DEVICES logical\n"
        "  devices for -mesh, default 1).\n"
        "\n\n"
    )


def _db_max(db) -> int:
    import numpy as np

    return int(np.asarray(db.vals).max()) if db.distinct else 1


def _device_hbm_gb(device) -> float | None:
    """Memory of one card in GB; None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1] / 1024**3


def run(cfg: MerfinConfig) -> int:
    """Load DBs and run the report — the JAX CLI's run()."""
    from merfin_tpu_torch.device import devices, get_device
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.mkdb import KmerDB, is_mkdb
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.parallel import multihost as mh
    from merfin_tpu_torch.table.lookup import build_lookup

    log = sys.stderr
    device = get_device()

    # Multi-process launch (MERFIN_NUM_PROCESSES / MERFIN_PROCESS_ID /
    # MERFIN_COORDINATOR): each process takes a sequence (or DB-slice)
    # stripe, accumulators merge over gloo, rank 0 writes the outputs;
    # -debug writes per-rank gz files and -resume keeps per-rank
    # checkpoints.
    multi = mh.maybe_init_from_env(log=log)

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

            # ranks stripe the input blocks and rank 0 merges the DB
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

    def n_devices() -> int:
        return len(mh.global_devices()) if multi else len(devices())

    # Mesh: every report type rides it (the reference parallelizes every
    # mode: sweatShop merfin.C:366-413, OpenMP merfin-completeness.C:65).
    mesh = None
    t_shards = 1
    if cfg.mesh:
        from merfin_tpu_torch.parallel.sharded import make_mesh

        try:
            d, t = (int(x) for x in cfg.mesh.lower().split("x"))
        except ValueError:
            print(f"ERROR: -mesh '{cfg.mesh}' is not DxT (e.g. 2x4).", file=log)
            return 1
        n = n_devices()
        if n < d * t:
            print(f"ERROR: -mesh {d}x{t} needs {d * t} devices; "
                  f"{n} available.", file=log)
            return 1
        if multi and d * t != n:
            # a partial mesh under a multi-process launch would leave some
            # processes driving only other processes' devices
            hint = f"{n // t}x{t}" if n % t == 0 else f"1x{n}"
            print(f"ERROR: -mesh {d}x{t} must use all {n} devices "
                  f"of the multi-host slice (e.g. -mesh {hint}).", file=log)
            return 1
        mesh = mh.make_global_mesh(data=d) if multi else \
            make_mesh(d * t, data=d)
        t_shards = t
        print(f"-- Sharding tables over a {d}x{t} device mesh.", file=log)

    # device-memory fail-fast: tables must fit the card they go to, whole
    # on one card or 1/T per card when sharded over "t" (not for
    # -completeness, whose read DB streams)
    hbm_gb = _device_hbm_gb(device)
    if hbm_gb is not None and cfg.report_type != "completeness":
        per_dev = req / t_shards
        if per_dev > 0.92 * hbm_gb:    # headroom for batches
            print(f"\nLookup tables need {per_dev:.1f} GB per device but "
                  f"device HBM is {hbm_gb:.1f} GB.", file=log)
            if mesh is None:
                n = n_devices()
                if n > 1:
                    t_need = max(2, int(per_dev / (0.92 * hbm_gb)) + 1)
                    print(f"Shard the tables over the device mesh: "
                          f"-mesh 1x{min(t_need, n)} (up to {n} devices "
                          f"available).\n", file=log)
            else:
                print("Increase the -mesh table axis (DxT with larger T).\n",
                      file=log)
            return 1

    if cfg.report_type == "completeness":
        from merfin_tpu_torch.modes.completeness import run_completeness

        print("-- Compute completeness.", file=log)
        run_completeness(read_db, asm_db, cfg.peak, prob_table=prob, log=log,
                         device=device, mesh=mesh)
        print("Bye!", file=log)
        return 0

    if mesh is not None:
        from merfin_tpu_torch.parallel.sharded import ShardedLookup

        print(f"-- Loading kmers from '{cfg.read_db_name}' into sharded table.",
              file=log)
        read_lookup = ShardedLookup.build(read_db, mesh, min_v=cfg.min_v,
                                          max_v=cfg.max_v)
        print(f"-- Loading kmers from '{cfg.seq_db_name}' into sharded table.",
              file=log)
        asm_lookup = ShardedLookup.build(asm_db, mesh)
    else:
        print(f"-- Loading kmers from '{cfg.read_db_name}' into lookup table.", file=log)
        read_lookup = build_lookup(read_db, min_v=cfg.min_v, max_v=cfg.max_v,
                                   device=device)
        print(f"-- Loading kmers from '{cfg.seq_db_name}' into lookup table.", file=log)
        asm_lookup = build_lookup(asm_db, device=device)

    seq_file = SeqFile(cfg.seq_name)

    def make_engine():
        if mesh is not None:
            from merfin_tpu_torch.parallel.engine import ShardedKstarEngine

            return ShardedKstarEngine(
                mesh, read_lookup, asm_lookup, k, cfg.peak, prob_table=prob,
                max_value=_db_max(read_db), exact_max=True,
                asm_max_value=_db_max(asm_db))
        from merfin_tpu_torch.modes.engine import KstarEngine

        sortjoin = cfg.sortjoin
        if cfg.report_type != "hist":
            sortjoin = False   # dump needs positional output
        elif sortjoin is None:  # auto: the union join on a card
            sortjoin = device.type != "cpu"
        engine = KstarEngine(read_lookup, asm_lookup, k, cfg.peak,
                             prob_table=prob, max_value=_db_max(read_db),
                             sortjoin=sortjoin, exact_max=True,
                             asm_max_value=_db_max(asm_db))
        if engine.sortjoin:
            print("-- Using sorted-join lookup kernel for -hist.", file=log)
        return engine

    if cfg.report_type == "hist":
        from merfin_tpu_torch.modes.hist import run_hist

        print(f"-- Generate histogram of the k* metric to '{cfg.out_name}'.", file=log)
        run_hist(make_engine(), seq_file, cfg.out_name, log=log,
                 resume=cfg.resume)
    elif cfg.report_type == "dump":
        from merfin_tpu_torch.modes.dump import run_dump

        print(f"-- Dump per-base k* metric to '{cfg.out_name}'.", file=log)
        run_dump(make_engine(), seq_file, cfg.out_name,
                 skip_missing=cfg.skip_missing, log=log, resume=cfg.resume)
    elif _run_variant_mode(cfg, k, read_db, read_lookup, asm_lookup, prob,
                           seq_file, log, mesh=mesh) != 0:
        return 1
    print("Bye!", file=log)
    return 0


def _run_variant_mode(cfg: MerfinConfig, k: int, read_db, read_lookup,
                      asm_lookup, prob, seq_file, log, mesh=None) -> int:
    """The variant modes, as the JAX CLI runs them: the VCF and its
    clusters, the scorer of ``modes/variants.py:make_scorer``, then the
    fused device scorer or the host scorer, on the lookups or, with
    ``mesh``, on the sharded tables (on a mesh over several processes
    every rank evaluates every cluster).  The host scorer probes
    ``lookup_np`` of each table."""
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes.variants import make_scorer, run_variants

    print(f"-- Opening vcf file '{cfg.vcf_name}'.", file=log)
    vcf = VcfFile(cfg.vcf_name, log=log)
    print(f"Merge variants within {k}-mer bases, splitting combinations "
          f"greater than {cfg.comb}.", file=log)
    vcf.merge_clusters(k, cfg.comb, cfg.nosplit, log=log)

    print("-- Generate variant mers and score them.", file=log)
    # Fused device scoring is the default for every variant mode, -polish
    # with a -prob table included (its f64 totdk is summed in merfin's
    # order, bit for bit); -debug and -nodevscore keep the host scorer.
    try:
        scorer = make_scorer(read_lookup, asm_lookup, k, cfg.peak, prob,
                             _db_max(read_db),
                             devscore=cfg.devscore, debug=cfg.debug,
                             mesh=mesh, log=log)
    except ValueError as e:
        print(f"ERROR: {e}", file=log)
        return 1
    try:
        run_variants(cfg.report_type, seq_file, vcf, k,
                     read_lookup.lookup_np, asm_lookup.lookup_np, cfg.peak,
                     prob, cfg.out_name, comb=cfg.comb, debug=cfg.debug, log=log, resume=cfg.resume,
                     threads=cfg.threads,
                     spans=mesh is not None and mesh.spans_hosts,
                     scorer=scorer)
    finally:
        if scorer is not None:
            scorer.close()
    return 0


# ---------------- database tools (meryl analog) ----------------

def db_tool_main(argv: list[str]) -> int:
    """The JAX CLI's database tools (merfin_tpu/cli.py:db_tool_main): the
    same arguments, stdout and output DBs; ``count`` on the device."""
    from merfin_tpu_torch.count import algebra
    from merfin_tpu_torch.io import meryl_text
    from merfin_tpu_torch.io.mkdb import KmerDB

    from merfin_tpu_torch.parallel.multihost import maybe_init_from_env

    # `count` stripes input blocks across a multi-process launch
    maybe_init_from_env(log=sys.stderr)

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
