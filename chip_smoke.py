#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: python3 chip_smoke.py

Drives merfin_tpu_torch's main paths (-hist, -completeness, -dump and
the variant modes) end to end on the GPU and checks them, phase by phase
(any failure exits non-zero with its traceback):

  1. device   nvidia-smi name/power limit, torch/CUDA versions; requires
              compute capability (9, 0);
  2. build    every kernel library from csrc/ with nvcc for sm_90a, one
              nvcc per source in parallel, with ptxas's register and
              spill lines;
  3. kernel   each kernel vs its plain PyTorch version, bit-exact; at
              each timed shape the median CUDA-event times of plain,
              kernel, kernel, plain in turns, one torch.searchsorted of
              the same biased queries (library_ms, a yardstick the port
              never calls), the profiler's device time of kernel and
              yardstick (the time the card was busy, overlapping
              kernels counted once; host launch time excluded) and the
              bound (join_bytes over 3.35 TB/s).
              union_join: the full world's union table against one
              -hist dispatch's sorted 2^20-window query stream with
              hits, misses and sentinels (timed), a ragged length, a
              k=20 table with palindromes, and (timed) the sorted
              2^23-window stream of a phase-8 heavy cluster's first
              span, as the fused variant scorer probes it.  sorted_join
              and window_join: the full world's asm table against one
              2^22 block of sorted read-DB keys (the completeness
              dispatch, timed), a v1-ratio table of 2^21 keys against
              2^20 queries with 10% misses and 1% sentinels (timed), a
              ragged length, a k=31 table with keys near 2^62, values
              near 2^32-1.  sorted_join also at the mesh paths' shapes
              (timed): each shard of phase 10's 1x1 meshes is a whole
              DB's table, so the full read-DB and asm tables against one
              -hist/-dump mesh dispatch's sorted 2^19-window stream with
              misses and sentinels, and against the heavy span's 2^23
              windows as the mesh variant scorer probes it.  All three
              on join_edge_cases: k=32 keys with
              bit 63, n = 0 and 1, ragged lengths, heavy duplication,
              values >= 2^31, and tiles on each side of the windowed
              join's dense/sparse threshold and shared-memory capacity.
              A route row (no kernel): the gather tables
              (table/lookup.py, plain torch ops) of the full world's DBs
              at the -dump dispatch, 2^21 positional windows of scaffold
              0, one read-DB probe and both probes beside the union
              route's sort + union_join + scatter at the same shape
              (wall, CUDA-event and device ms), values equal.
              window_join also on window_edge_cases, tables whose keys
              repeat: runs of 2-5 equal keys, runs across chunk
              boundaries and tile boundaries, a run of 5,000+ keys,
              wrapping sums, windows on each side of its chunk size and
              dense/wide threshold, sentinels and ragged lengths.
              path_sum (the fused scorer's f64 totdK, -prob) against its
              plain version, bit for bit, and timed beside the two-level
              prefix difference it replaced, at the main path's shapes:
              the heavy cluster's first 2^23-window span and a light
              dispatch of 2^23 windows (SNP paths of k windows every
              3k-2), on values of the f64 branch's deltas;
  4. oracle   small worlds through the CLI on CUDA: the verify recipe's
              world and a fragmented 200 kb world with a -prob table are
              held byte for byte to tests/refmodel.py:hist_mode; the same
              world with a high-copy repeat (f32 fallback bins, kover
              fallback, bin growth) is held to refmodel on kasm/missing
              and byte for byte to the port's own CPU run.  -completeness
              and -dump on the recipe and -prob worlds are held to
              refmodel's completeness_mode and dump_mode (rows byte for
              byte), and run_completeness on a v1 table gives the CLI's
              lines.  The variant modes (each mode, and -polish on the
              host scorer) on both worlds equal the port's CPU run byte
              for byte; the recipe world gives its 3 true corrections;
              the -prob world's -polish run launches path_sum (its
              launches counted), the recipe world's and the host
              scorer's none;
  5. full     a synthetic 64 Mbp assembly (4 large scaffolds, 2,000
              contigs of 1-20 kb, N gaps, 2,000 substitutions; k=21,
              peak 30) against a read DB of the true genome's k-mers at
              Poisson(30) counts plus 128M error k-mers, -hist through the
              CLI: kasm/kmissing against an independent numpy count, the
              kernel's launch count, zero exactness fallbacks, wall time
              and bases/s, no gather table placed; then -hist
              -nosortjoin (the gather tables, no union table, no
              union_join launch): the same histogram, lines and
              counters, its wall and split;
  6. completeness full   -completeness through the CLI on the full
              world's DBs: TOTAL readK/undrcpy against an independent
              numpy sum, the 64 slice lines against the totals,
              sorted_join launches equal to the block count; the same on
              a v1 table (window_join); wall, k-mers/s and the split;
  7. dump full   -dump through the CLI against the full world's DBs (the
              whole gather tables on the card, no union table) for one
              scaffold and the 2,000 contigs: per-sequence missing/kasm
              against the independent count, the row count, union_join
              launches (none), wall, bases/s and the tables' split;
  8. variants full   -polish, -filter and -better (fused device scorer)
              through the CLI against the full world's DBs, on a VCF of
              the world's true corrections, 2,000 spurious SNPs, 1,000
              spurious 1/2 sites and 4 heavy clusters of 165,888 paths:
              the records against the independent list from the world's
              arrays; -polish on the VCF without the heavy clusters,
              with the fused scorer and with the host scorer
              (-nodevscore, the gather tables: no union table, no
              union_join launch), each byte-identical to the first run;
              records, clusters/s, union_join launches, wall and its
              split; the fused runs place no gather table;
  9. count full   the counter on the card: (a) -completeness through the
              CLI without -seqmers, which counts the 64 Mbp asm.fasta
              into asm.fasta.meryl (equal file for file to the world's
              asm.mkdb, made by torch.unique) and then gives phase 6's
              lines, with sorted_join launches equal to the block count;
              (b) a FASTQ of 150 bp reads at 20x of the true genome's
              scaffold 0 from both strands with 0.5% substitutions:
              `count k=21` in RAM (the device accumulator) against an
              independent numpy count over the read rows (distinct,
              total, a hash of keys and values), `count k=21
              memory=0.25` (the device step and disk spills) byte-identical
              to it, and `statistics` and `histogram` against numpy;
              wall, bases/s, distinct k-mers and the split (parse and
              pack, device, fetch and host merge, DB write) of the
              assembly count and the in-RAM read count, the spill run's
              wall;
 10. mesh full   the mesh paths, which build no union table (one
              sorted-join table a DB and shard, every shard probe a
              sorted_join launch): -hist, -completeness, -dump (phase
              7's cut) and -polish on light.vcf (fused ShardedScorer)
              through the CLI with -mesh 1x1, each byte-identical to its
              single-device phase (and its stderr lines); -hist on
              make_mesh(devices=[cuda:0] * 8, data=2) through the API,
              equal to phase 5's histogram; -mesh 2x4 on the CLI exits 1
              ("needs 8 devices; 1 available"); walls, splits and
              sorted_join launches of each;
 11. two processes   striped MERFIN_NUM_PROCESSES=2 launches, both ranks
              on cuda:0 with gloo merges: -hist of the full world (equal
              to phase 5's histogram) and -polish, -dump and `count` of a
              --small-bases parity world, each byte-identical to one
              process, with no part, checkpoint or spill file left.

The world is made from --seed with numpy; databases are written with the
port's KmerDB.create.  The last three stdout lines are a JSON object of
the kernels (launches in each main path, each run with the counts set
to 0 just before it, and their sum; max |kernel - plain|; ms, plain_ms,
library_ms, the device_ms of each, and bound_ms at the main path's
shape, and at every timed shape under "shapes"; path_sum's earlier
design is two_level_ms), the card's
`nvidia-smi --query-gpu=name,power.limit` line, and
{"ok": true, "device": {...}}.

Without CUDA the script fails (exit 1) and prints no result.  Phases 4
to 11 also run on the CPU at a tiny size in tests/test_torch_hist.py
(``MERFIN_PLATFORM=cpu``), which checks this harness without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

COUNTERS = ("overflow_values", "bin_fallbacks", "kover_fallbacks")
_ACGT = np.frombuffer(b"ACGTN", np.uint8)
_COMP = str.maketrans("ACGTN", "TGCAN")


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    say(f"[{name}] start")
    yield
    say(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------- worlds

def _dna(rng, n: int) -> str:
    return _ACGT[rng.integers(0, 4, size=n)].tobytes().decode()


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}


def recipe_world() -> dict:
    """The world of .claude/skills/verify/SKILL.md (k=15, peak 20), with
    its VCF: the three true corrections and a spurious call at 600."""
    import random

    random.seed(5)
    g = "".join(random.choice("ACGT") for _ in range(2000))
    asm = list(g)
    for p in (300, 900, 1500):
        asm[p] = ALT_OF[asm[p]]
    vcf = [("chr1", p, asm[p], g[p], "33.3", "1/1") for p in (300, 900, 1500)]
    vcf.append(("chr1", 599, asm[599], ALT_OF[asm[599]], "9.9", "1/1"))
    return dict(k=15, peak=20.0, scaffolds=[("chr1", "".join(asm))],
                reads=[g] * 20, prob=None, vcf=sorted(vcf, key=lambda r: r[1]))


def parity_world(seed: int, total_bases: int, k: int = 21,
                 repeat: int = 0) -> dict:
    """A scripts/chip_parity.py:build_world-style world: one long scaffold
    with N runs (and, with ``repeat`` > 0, an A homopolymer of ``repeat``
    windows that the reads hold once: asmK > 8192 forces the f32 fallback
    bins, the kover fallback and bin growth), 30 short scaffolds (the
    packed-group path), substitutions, reads on a coverage ladder so raw
    values hit the v/peak = x.5 ties of peak 2.0, and a -prob table.
    Even k gets palindromic windows."""
    rng = np.random.default_rng(seed)
    shorts = [_dna(rng, int(n)) for n in rng.integers(150, 2000, size=30)]
    if k % 2 == 0:
        for i in range(0, 30, 3):
            stem = _dna(rng, k // 2)
            mid = len(shorts[i]) // 2
            shorts[i] = shorts[i][:mid] + stem + _revcomp(stem) + shorts[i][mid:]
    shorts[5] = shorts[5][:60] + "N" * 30 + shorts[5][90:]
    long_len = max(20_000 + 3 * repeat,
                   total_bases - sum(len(s) for s in shorts))
    body = _dna(rng, long_len)
    body = body[: long_len // 2] + "N" * 50 + body[long_len // 2 + 50:]
    true_long = body
    if repeat:
        at = long_len // 3
        run = "A" * (repeat + k - 1)
        body = body[:at] + run + body[at + len(run):]
        true_long = body[:at] + "A" * k + body[at + len(run):]
    # assembly errors: substitutions the reads do not carry
    asm = bytearray(body.encode())
    subs = []
    for p in rng.choice(np.arange(100, long_len - 100), size=30, replace=False):
        if asm[p] in b"ACGT" and (not repeat or not at <= p < at + repeat + k):
            asm[p] = b"CGTA"[b"ACGT".index(asm[p])]
            subs.append(int(p))
    scaffolds = [("chrL", asm.decode())] + [
        (f"scaf{i}", s) for i, s in enumerate(shorts)]
    reads = [true_long] + shorts
    for cov, frac in ((1, 1.0), (2, 0.8), (4, 0.6), (6, 0.4), (11, 0.2)):
        reads += [true_long[: int(len(true_long) * frac)]] * cov
    reads.append(_dna(rng, 5_000))
    prob = "1,0.931\n1,0.871\n2,0.773\n2,0.597\n3,0.401\n"
    vcf = None if repeat else parity_vcf(rng, scaffolds, true_long, subs)
    return dict(k=k, peak=2.0, scaffolds=scaffolds, reads=reads, prob=prob,
                vcf=vcf)


def parity_vcf(rng, scaffolds, true_long: str, subs) -> list:
    """VCF rows for a parity world: the true corrections of chrL, and
    spurious calls (SNPs, 1/2 multiallelic sites, 3-base deletions,
    1-base insertions, 0/1 sites) on chrL and on ten short scaffolds,
    some close enough to a correction to share its cluster."""
    name, asm = scaffolds[0]
    rows = [(name, p, asm[p], true_long[p], "40.7", "1/1") for p in subs]
    kinds = ["snp"] * 10 + ["multi"] * 3 + ["del"] * 3 + ["ins"] * 3 + ["het"] * 2
    spots = [(name, int(p)) for p in rng.choice(
        np.arange(50, len(asm) - 50), size=len(kinds), replace=False)]
    spots += [(n, int(rng.integers(10, len(s) - 10)))
              for n, s in scaffolds[1:11]]
    kinds += ["snp"] * 10
    seqs = dict(scaffolds)
    for (chrom, p), kind in zip(spots, kinds):
        s = seqs[chrom]
        if "N" in s[p: p + 3]:
            continue
        b = s[p]
        if kind == "multi":
            rows.append((chrom, p, b, f"{ALT_OF[b]},{ALT_OF[ALT_OF[b]]}",
                         "17.2", "1/2"))
        elif kind == "del":
            rows.append((chrom, p, s[p: p + 3], b, "12.5", "1/1"))
        elif kind == "ins":
            rows.append((chrom, p, b, b + "ACGT"[int(rng.integers(4))],
                         "8.0", "1/1"))
        else:
            rows.append((chrom, p, b, ALT_OF[b], "21.9",
                         "0/1" if kind == "het" else "1/1"))
    order = {n: i for i, (n, _) in enumerate(scaffolds)}
    return sorted(rows, key=lambda r: (order[r[0]], r[1]))


def write_vcf(path: str, contigs, rows) -> None:
    """A VCF of ``rows`` (chrom, 0-based pos, REF, ALT, QUAL, GT)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.writelines(f"##contig=<ID={c}>\n" for c in contigs)
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        f.writelines(f"{c}\t{p + 1}\t.\t{ref}\t{alt}\t{q}\tPASS\t.\tGT\t{gt}\n"
                     for c, p, ref, alt, q, gt in rows)


def canonical_counts(code_arrays, k: int):
    """Sorted canonical keys (u64) and their counts over code arrays."""
    from merfin_tpu_torch.kcore.pack import kmers_from_codes_np

    parts = []
    for c in code_arrays:
        fmer, rmer, valid = kmers_from_codes_np(c, k)
        parts.append(np.minimum(fmer, rmer)[valid])
    allk = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    keys, counts = np.unique(allk, return_counts=True)
    return keys, counts.astype(np.uint32)


def materialize(world: dict, d: str) -> list[str]:
    """Write the world's FASTA, DBs and prob table under ``d``; returns
    the -hist argv without -output."""
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.kcore.pack import encode_bases

    os.makedirs(d, exist_ok=True)
    k = world["k"]
    fasta = os.path.join(d, "asm.fasta")
    with open(fasta, "w") as f:
        for name, s in world["scaffolds"]:
            f.write(f">{name} synthetic\n")
            for j in range(0, len(s), 80):
                f.write(s[j: j + 80] + "\n")
    for tag, seqs in (("read", world["reads"]),
                      ("asm", [s for _, s in world["scaffolds"]])):
        keys, counts = canonical_counts([encode_bases(s) for s in seqs], k)
        if tag == "read":       # counts set by the world, {mer: count}
            for mer, count in world.get("read_counts", {}).items():
                key = int("".join(str("ACGT".index(b)) for b in mer), 4)
                counts[keys == np.uint64(key)] = count
        KmerDB.create(os.path.join(d, f"{tag}.mkdb"), k, keys, counts)
    argv = ["-hist", "-sequence", fasta,
            "-readmers", os.path.join(d, "read.mkdb"),
            "-seqmers", os.path.join(d, "asm.mkdb"),
            "-peak", str(world["peak"])]
    if world["prob"]:
        prob = os.path.join(d, "prob.txt")
        with open(prob, "w") as f:
            f.write(world["prob"])
        argv += ["-prob", prob]
    if world.get("vcf"):
        write_vcf(os.path.join(d, "calls.vcf"),
                  [n for n, _ in world["scaffolds"]], world["vcf"])
    return argv


# ------------------------------------------------------------ CLI drivers

# Runs a package's CLI in a fresh process and prints the engine's
# exactness counters as JSON on stdout (the CLI itself writes only to
# stderr).
_COUNTED_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import {pkg}.modes.engine as eng
import {pkg}.parallel.engine as peng
made = []
for mod, name in ((eng, "KstarEngine"), (peng, "ShardedKstarEngine")):
    class Recording(getattr(mod, name)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    setattr(mod, name, Recording)
from {pkg}.cli import main
rc = main(sys.argv[1:])
print(json.dumps({{c: getattr(made[-1], c) for c in {counters!r}}}
                 if made else {{}}))
raise SystemExit(rc)
"""


def counted_cli(pkg: str) -> list[str]:
    """Command prefix running ``pkg``'s CLI with its counters on stdout."""
    return [sys.executable, "-c",
            _COUNTED_RUN.format(repo=REPO, pkg=pkg, counters=COUNTERS)]


def mode_argv(argv: list[str], mode: str) -> list[str]:
    """materialize()'s -hist argv for another report type (-completeness
    takes no -sequence)."""
    out = [f"-{mode}"] + argv[1:]
    if mode == "completeness":
        at = out.index("-sequence")
        del out[at: at + 2]
    return out


def vcf_argv(argv: list[str], mode: str) -> list[str]:
    """materialize()'s -hist argv for a variant mode, with its calls.vcf."""
    d = os.path.dirname(argv[argv.index("-sequence") + 1])
    return mode_argv(argv, mode) + ["-vcf", os.path.join(d, "calls.vcf")]


def _read_output(cwd: str, out: str) -> bytes:
    """The CLI's output file (b"" when it wrote none)."""
    path = os.path.join(cwd, out)
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def run_port_subprocess(argv, cwd: str, platform: str, out: str = "out.hist"):
    """-> (output bytes, stderr text, counters) of one port CLI process."""
    env = dict(os.environ, MERFIN_PLATFORM=platform)
    proc = subprocess.run(counted_cli("merfin_tpu_torch") + argv
                          + ["-output", out], cwd=cwd, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"port CLI failed ({platform}):\n{proc.stderr}")
    return (_read_output(cwd, out), proc.stderr,
            json.loads(proc.stdout.splitlines()[-1]))


@contextlib.contextmanager
def recording_engines():
    """Record every port engine (KstarEngine, ShardedKstarEngine) the CLI
    creates (for its counters)."""
    import merfin_tpu_torch.modes.engine as eng
    import merfin_tpu_torch.parallel.engine as peng

    made = []
    bases = ((eng, "KstarEngine"), (peng, "ShardedKstarEngine"))
    saved = [getattr(mod, name) for mod, name in bases]
    for (mod, name), base in zip(bases, saved):
        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        setattr(mod, name, Recording)
    try:
        yield made
    finally:
        for (mod, name), base in zip(bases, saved):
            setattr(mod, name, base)


class StampedLog(io.StringIO):
    """A stderr capture that notes when lines with given prefixes first
    appear (seconds since creation)."""

    def __init__(self, marks=()):
        super().__init__()
        self.t0 = time.perf_counter()
        self.stamps = dict.fromkeys(marks)

    def write(self, s):
        for m, t in self.stamps.items():
            if t is None and s.startswith(m):
                self.stamps[m] = time.perf_counter() - self.t0
        return super().write(s)


class _Switch(io.TextIOBase):
    """The stderr of every in-process CLI run.  A module first imported
    during one run binds it (as a ``log=sys.stderr`` default), so it
    writes to the current run's capture, not to the first run's."""

    def __init__(self):
        super().__init__()
        self.f = sys.__stderr__

    def write(self, s):
        return self.f.write(s)

    def flush(self):
        self.f.flush()


_STDERR = _Switch()


@contextlib.contextmanager
def platform_env(platform: str | None):
    """MERFIN_PLATFORM set to ``platform`` inside the block (None: as it
    is)."""
    saved = os.environ.get("MERFIN_PLATFORM")
    if platform is not None:
        os.environ["MERFIN_PLATFORM"] = platform
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MERFIN_PLATFORM", None)
        else:
            os.environ["MERFIN_PLATFORM"] = saved


def run_port_inprocess(argv, cwd: str, err: io.StringIO | None = None,
                       out: str = "out.hist", output: str | None = None,
                       platform: str | None = None):
    """The port's CLI entry point in this process on ``platform`` (default:
    MERFIN_PLATFORM's), run with ``-output out`` -> (bytes of the file
    ``output`` (default: ``out``), stderr text, counters; {} when the
    mode makes no engine)."""
    from merfin_tpu_torch.cli import main

    os.makedirs(cwd, exist_ok=True)
    err = io.StringIO() if err is None else err
    prev, _STDERR.f = _STDERR.f, err
    try:
        with platform_env(platform), contextlib.chdir(cwd), \
                recording_engines() as made, \
                contextlib.redirect_stderr(_STDERR):
            rc = main(argv + ["-output", out])
    finally:
        _STDERR.f = prev
    if rc != 0:
        raise RuntimeError(f"port CLI failed:\n{err.getvalue()}")
    counters = {c: getattr(made[-1], c) for c in COUNTERS} if made else {}
    return _read_output(cwd, output or out), err.getvalue(), counters


# ---------------------------------------------------------------- oracle

def _refmodel():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "refmodel", os.path.join(REPO, "tests", "refmodel.py"))
    refmodel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refmodel)
    return refmodel


def _read_counts(refmodel, world: dict) -> dict:
    """The read DB of a world as refmodel counts it, with the counts the
    world sets (``read_counts``, canonical mers)."""
    counts = refmodel.count_canonical(world["reads"], world["k"])
    counts.update(world.get("read_counts", {}))
    return counts


def _prob_columns(world: dict):
    ck, cp = [], []
    if world["prob"]:
        for line in world["prob"].splitlines():
            a, b = line.split(",")
            ck.append(int(a))
            cp.append(float(b))
    return ck, cp


def oracle(world: dict):
    """tests/refmodel.py:hist_mode formatted as tests/test_modes.py
    formats it -> (hist bytes, per-sequence lines, summary lines)."""
    refmodel = _refmodel()
    k, peak = world["k"], world["peak"]
    ck, cp = _prob_columns(world)
    seqs = world["scaffolds"]
    per_seq, undr, over, kasm, kmissing, kover = refmodel.hist_mode(
        seqs, _read_counts(refmodel, world),
        refmodel.count_canonical([s for _, s in seqs], k), k, peak, ck, cp)
    lines = []
    for ii in sorted(undr, reverse=True):
        if ii > 0 and undr[ii] > 0:
            lines.append(f"{ii * -0.2:.1f}\t{undr[ii]}")
    lines.append(f"{0.0:.1f}\t{undr.get(0, 0) + over.get(0, 0)}")
    for ii in sorted(over):
        if ii > 0 and over[ii] > 0:
            lines.append(f"{ii * 0.2:.1f}\t{over[ii]}")
    seq_lines, cum = [], 0
    for (ident, _), (pkasm, pmiss, _) in zip(seqs, per_seq):
        cum += pmiss
        qv = refmodel.histo_qv(pmiss, pkasm, k)
        seq_lines.append(f"{ident}\t{pmiss}\t{cum}\t{pkasm}\t{qv:.2f}")
    summary = [
        f"K-mers not found in reads (missing) : {kmissing}",
        f"K-mers overly represented in assembly: {kover:.2f}",
        f"K-mers found in the assembly: {kasm}",
        f"Missing QV: {refmodel.histo_qv(kmissing, kasm, k):.2f}",
        f"Merfin QV*: {refmodel.histo_qv(kmissing + kover, kasm, k):.2f}",
    ]
    return ("\n".join(lines) + "\n").encode(), seq_lines, summary


def oracle_completeness(world: dict) -> list[str]:
    """tests/refmodel.py:completeness_mode as the CLI's TOTAL lines."""
    refmodel = _refmodel()
    total, undrc, c = refmodel.completeness_mode(
        _read_counts(refmodel, world),
        refmodel.count_canonical([s for _, s in world["scaffolds"]],
                                 world["k"]),
        world["peak"], *_prob_columns(world))
    return [f"TOTAL readK:   {total:15.2f}",
            f"TOTAL undrcpy:    {undrc:15.5f}",
            f"COMPLETENESS:             {c:0.5f}"]


def oracle_dump(world: dict) -> bytes:
    """tests/refmodel.py:dump_mode as the rows file."""
    refmodel = _refmodel()
    k = world["k"]
    rows = refmodel.dump_mode(
        world["scaffolds"], _read_counts(refmodel, world),
        refmodel.count_canonical([s for _, s in world["scaffolds"]], k),
        k, world["peak"], *_prob_columns(world))
    return "".join(f"{i}\t{p}\t{r:.2f}\t{a:.2f}\t{m:.2f}\n"
                   for i, p, r, a, m in rows).encode()


def completeness_lines(stderr: str) -> list[str]:
    """The 64 slice lines and the three TOTAL/COMPLETENESS lines."""
    return [ln for ln in stderr.splitlines()
            if ln.startswith(("thread ", "TOTAL ", "COMPLETENESS:"))]


def seq_lines_of(stderr: str) -> list[str]:
    return [ln for ln in stderr.splitlines() if ln.count("\t") == 4]


def summary_of(stderr: str) -> list[str]:
    return [ln for ln in stderr.splitlines()
            if ln.startswith(("K-mers ", "Missing QV:", "Merfin QV*:"))]


def check_small_worlds(tmp: str, seed: int, bases: int, repeat: int,
                       platform: str) -> None:
    """Phase 4: small worlds through the CLI on ``platform``."""
    worlds = {"recipe": recipe_world(),
              "parity": parity_world(seed, bases),
              "repeat": parity_world(seed, bases, repeat=repeat)}
    for name, world in worlds.items():
        t0 = time.perf_counter()
        d = os.path.join(tmp, name)
        argv = materialize(world, d)
        hist, err, counters = run_port_inprocess(argv, os.path.join(d, platform))
        want_hist, want_seq, want_sum = oracle(world)
        assert seq_lines_of(err) == want_seq, (name, seq_lines_of(err)[:5],
                                               want_seq[:5])
        got_sum = summary_of(err)
        if name != "repeat":
            assert counters["bin_fallbacks"] == 0, (name, counters)
            assert hist == want_hist, (name, hist[:300], want_hist[:300])
            assert got_sum == want_sum, (name, got_sum, want_sum)
        else:
            assert counters["bin_fallbacks"] > 0, counters
            assert counters["kover_fallbacks"] > 0, counters
            assert "Growing k* histogram" in err
            assert [got_sum[0], got_sum[2]] == [want_sum[0], want_sum[2]], (
                got_sum, want_sum)
            if platform == "cuda":     # the CPU on the card's route
                c_hist, c_err, c_counters = run_port_subprocess(
                    argv + ["-sortjoin"], _mkdir(os.path.join(d, "cpu")),
                    "cpu")
                assert c_hist == hist, "repeat world: CUDA hist != CPU hist"
                assert c_err == err, "repeat world: CUDA stderr != CPU stderr"
                assert c_counters == counters, (c_counters, counters)
        say(f"  {name}: k={world['k']} windows={sum(len(s) for _, s in world['scaffolds'])} "
            f"counters={counters} matches "
            f"{'refmodel (kasm/missing) + own CPU run' if name == 'repeat' else 'refmodel byte for byte'}"
            f" ({time.perf_counter() - t0:.1f} s)")


def v1_table(asm_db, device):
    """The assembly DB as a v1 (window-join) table: the other table
    run_completeness takes (``asm_table=``) besides the CLI's v4 one."""
    from merfin_tpu_torch.ops.sortjoin import build_sortjoin_table

    return build_sortjoin_table(asm_db.keys, asm_db.vals, asm_db.k, 1 << 22,
                                prefer="v1", device=device)


def check_small_modes(tmp: str, seed: int, bases: int, platform: str) -> None:
    """Phase 4, -completeness and -dump: the recipe world and the -prob
    world through the CLI on ``platform``, held to tests/refmodel.py
    (completeness totals; dump rows byte for byte); run_completeness on
    a v1 (window-join) table gives the CLI's v4 lines."""
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.modes.completeness import run_completeness

    worlds = {"recipe": recipe_world(), "parity": parity_world(seed, bases)}
    for name, world in worlds.items():
        t0 = time.perf_counter()
        d = os.path.join(tmp, name)
        argv = materialize(world, d)
        _, err, _ = run_port_inprocess(mode_argv(argv, "completeness"),
                                       os.path.join(d, f"{platform}-compl"))
        lines = completeness_lines(err)
        assert len(lines) == 67, lines
        assert lines[-3:] == oracle_completeness(world), (
            name, lines[-3:], oracle_completeness(world))

        read_db, asm_db = KmerDB(argv[4]), KmerDB(argv[6])
        prob = (load_prob_table(argv[argv.index("-prob") + 1],
                                log=io.StringIO())
                if world["prob"] else None)
        log = io.StringIO()
        run_completeness(read_db, asm_db, world["peak"], prob_table=prob,
                         log=log, asm_table=v1_table(asm_db, platform))
        assert completeness_lines(log.getvalue()) == lines, name

        rows, err, _ = run_port_inprocess(mode_argv(argv, "dump"),
                                          os.path.join(d, f"{platform}-dump"),
                                          out="out.dump")
        assert rows == oracle_dump(world), (name, rows[:300])
        if name == "recipe":
            assert rows.count(b"\n") == 1986
            assert "chr1\t45\t45\t1986" in err.splitlines()
            assert lines[-2] == "TOTAL undrcpy:           45.00000", lines
        say(f"  {name}: -completeness ({lines[-1].split()[-1]}) matches "
            f"refmodel and the v1 table's run; -dump "
            f"({rows.count(b'\n')} rows) matches refmodel byte for byte "
            f"({time.perf_counter() - t0:.1f} s)")


VARIANT_MODES = ("polish", "filter", "better", "strict", "loose")


def variant_runs(argv: list[str]) -> list:
    """(tag, argv) of every variant mode at -threads 1, and -polish with
    the host scorer (-nodevscore)."""
    runs = [(m, vcf_argv(argv, m) + ["-threads", "1"]) for m in VARIANT_MODES]
    runs.append(("polish_host", vcf_argv(argv, "polish")
                 + ["-nodevscore", "-threads", "1"]))
    return runs


def variant_vcf(argv: list[str], out: str = "out") -> str:
    """The VCF a variant mode writes for ``-output out``."""
    return f"{out}.{'polish' if argv[0] == '-polish' else 'filter'}.vcf"


def vcf_records(vcf: bytes) -> int:
    """Records (non-header lines) of a VCF."""
    return sum(1 for ln in vcf.splitlines() if not ln.startswith(b"#"))


def check_small_variants(tmp: str, seed: int, bases: int,
                         platform: str) -> int:
    """Phase 4, the variant modes: the recipe world and the -prob world
    through the CLI on ``platform``, every mode and -polish -nodevscore.
    On CUDA each run's VCF and stderr equal the same run's on the CPU
    (MERFIN_PLATFORM=cpu, in this process) byte for byte.  The recipe world gives exactly its three
    true corrections (-polish and -better as 1/1 records with int-cast
    quals; -filter replays the original records) and never the spurious
    call.  Returns the path-sum kernel's launches in the -prob world's
    -polish run (the fused scorer's f64 branch; on CUDA more than 0, and
    none in the recipe world's or on the host scorer)."""
    from merfin_tpu_torch.ops.path_sum import path_sum_kernel

    worlds = {"recipe": recipe_world(), "parity": parity_world(seed, bases)}
    launches = {}
    for name, world in worlds.items():
        t0 = time.perf_counter()
        d = os.path.join(tmp, name)
        argv = materialize(world, d)
        got = {}
        for tag, run in variant_runs(argv):
            path_sum_kernel.launches = 0
            got[tag] = run_port_inprocess(
                run, os.path.join(d, f"var-{platform}", tag), out="out",
                output=variant_vcf(run))[:2]
            launches[name, tag] = path_sum_kernel.launches
            if platform == "cuda":
                want = run_port_inprocess(
                    run, os.path.join(d, "var-cpu", tag), out="out",
                    output=variant_vcf(run), platform="cpu")[:2]
                assert got[tag] == want, (name, tag, got[tag][1][-500:])
        n_rec = {tag: vcf_records(vcf) for tag, (vcf, _) in got.items()}
        if name == "recipe":
            fixes = [(p, r, a) for _, p, r, a, q, _ in world["vcf"]
                     if q == "33.3"]
            hom = "".join(f"chr1\t{p + 1}\t.\t{r}\t{a}\t33\tPASS\t.\tGT\t1/1\n"
                          for p, r, a in fixes).encode()
            assert got["polish"][0].endswith(b"\tS\n" + hom)
            assert got["polish_host"][0] == got["polish"][0]
            assert got["better"][0].endswith(b"\tS\n" + hom)
            assert got["filter"][0].endswith(
                hom.replace(b"\t33\t", b"\t33.3\t"))
            assert n_rec["polish"] == n_rec["filter"] == 3, n_rec
        say(f"  {name}: variant modes, records {n_rec}"
            f"{', equal to the CPU run byte for byte' if platform == 'cuda' else ''}"
            f"; path_sum launches of -polish {launches[name, 'polish']}"
            f" ({time.perf_counter() - t0:.1f} s)")
    n = launches["parity", "polish"]
    assert launches["recipe", "polish"] == 0, launches
    assert launches["parity", "polish_host"] == 0, launches
    assert n > 0 if platform == "cuda" else n == 0, launches
    return n


def _mkdir(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


# ------------------------------------------------------------ full world

def full_world(d: str, seed: int, mbp: float, n_error: int, device,
               k: int = 21, peak: float = 30.0) -> dict:
    """Phase 5's world: a synthetic ``mbp`` Mbp assembly of 4 large
    scaffolds and 2,000 contigs (log-uniform 1-20 kb), N gaps and 2,000
    substitutions; read DB = the true genome's canonical k-mers at
    Poisson(30) counts plus ``n_error`` error k-mers at counts 1-3.
    The k-mers come from the port's numpy/native extractor; their sorts
    run on ``device``."""
    import torch

    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.kcore.pack import kmers_from_codes_np

    rng = np.random.default_rng(seed)
    G = int(mbp * 1e6)
    n_contigs = max(10, round(2000 * G / 64e6))   # ~20% of the bases
    contigs = np.exp(rng.uniform(np.log(1000), np.log(20_000),
                                 size=n_contigs)).astype(np.int64)
    scaf = (G - int(contigs.sum())) // 4
    assert scaf > 20_000, "world too small for its contigs"
    lens = np.concatenate([[scaf] * 4, contigs])
    starts = np.concatenate([[0], np.cumsum(lens)])
    true = rng.integers(0, 4, size=int(starts[-1]), dtype=np.uint8)
    asm = true.copy()
    pos = rng.choice(asm.size, size=2000, replace=False)
    asm[pos] = (asm[pos] + rng.integers(1, 4, size=pos.size)) % 4
    for i in range(4):                         # N gaps in the scaffolds
        for g in rng.integers(starts[i] + 1000, starts[i + 1] - 1000, size=25):
            asm[g: g + int(rng.integers(50, 500))] = 4

    def pieces(codes):
        return [codes[starts[i]: starts[i + 1]] for i in range(lens.size)]

    def canonical_mers(codes_list):
        parts = []
        for c in codes_list:
            fmer, rmer, valid = kmers_from_codes_np(c, k)
            parts.append(np.minimum(fmer, rmer)[valid])
        return np.concatenate(parts)

    def on_device(x):
        return torch.from_numpy(x.view(np.int64)).to(device)

    # read DB: true k-mers at Poisson(30) + error k-mers at 1-3 (the
    # windows of a random sequence, each a fresh random k-mer).  One
    # device sort of (mer << 1 | is_error) dedups both sets; a true
    # k-mer sorts ahead of an equal error k-mer and keeps its count.
    t0 = time.perf_counter()
    assert 2 * k < 63
    tagged = [on_device(canonical_mers(pieces(true))) << 1]
    step = 1 << 25
    for s in range(0, n_error, step):
        n = min(step, n_error - s)
        fmer, rmer, _ = kmers_from_codes_np(
            rng.integers(0, 4, size=n + k - 1, dtype=np.uint8), k)
        tagged.append((on_device(np.minimum(fmer, rmer)) << 1) | 1)
        del fmer, rmer
    srt = torch.sort(torch.cat(tagged)).values
    del tagged
    first = torch.ones(srt.shape[0], dtype=torch.bool, device=device)
    first[1:] = (srt[1:] >> 1) != (srt[:-1] >> 1)
    srt = srt[first]
    keys = (srt >> 1).cpu().numpy().view(np.uint64)
    is_true = ((srt & 1) == 0).cpu().numpy()
    del srt, first
    vals = rng.integers(1, 4, size=keys.size).astype(np.uint32)
    vals[is_true] = np.maximum(rng.poisson(30, size=int(is_true.sum())),
                               1).astype(np.uint32)
    del is_true
    t1 = time.perf_counter()
    read_db = os.path.join(d, "read.mkdb")
    KmerDB.create(read_db, k, keys, vals)

    asm_keys, asm_counts = torch.unique(
        on_device(canonical_mers(pieces(asm))), sorted=True,
        return_counts=True)
    asm_db = os.path.join(d, "asm.mkdb")
    KmerDB.create(asm_db, k, asm_keys.cpu().numpy().view(np.uint64),
                  asm_counts.cpu().numpy().astype(np.uint32))
    del asm_keys, asm_counts
    t2 = time.perf_counter()

    # independent expectation (numpy), per sequence: kasm = valid
    # windows; a window that overlaps no substitution is a window of the
    # true genome, so its mer is a read key; the rest are looked up in
    # the read keys
    seq_kasm = np.zeros(lens.size, np.int64)
    seq_kmissing = np.zeros(lens.size, np.int64)
    pos_sorted = np.sort(pos)
    for i, c in enumerate(pieces(asm)):
        fmer, rmer, valid = kmers_from_codes_np(c, k)
        seq_kasm[i] = np.count_nonzero(valid)
        lo, hi = np.searchsorted(pos_sorted, [starts[i], starts[i + 1]])
        local = pos_sorted[lo:hi] - starts[i]
        win = (local[:, None] - np.arange(k)[None, :]).reshape(-1)
        win = np.unique(win[(win >= 0) & (win < valid.size)])
        win = win[valid[win]]
        q = np.minimum(fmer[win], rmer[win])
        idx = np.minimum(np.searchsorted(keys, q), keys.size - 1)
        seq_kmissing[i] = np.count_nonzero(keys[idx] != q)
    say(f"  full world steps: read DB {t1 - t0:.1f} s, asm DB + writes "
        f"{t2 - t1:.1f} s, expectation {time.perf_counter() - t2:.1f} s")

    # asm.fasta holds every sequence; dump.fasta the first scaffold and
    # the contigs (phase 7's -dump, cut for the smoke's time limit)
    names = [f"scaffold{i}" if i < 4 else f"contig{i - 4}"
             for i in range(lens.size)]
    dump_ids = [0] + list(range(4, lens.size))
    fasta = os.path.join(d, "asm.fasta")
    dump_fasta = os.path.join(d, "dump.fasta")
    for path, ids in ((fasta, range(lens.size)), (dump_fasta, dump_ids)):
        with open(path, "wb") as f:
            for i in ids:
                f.write(f">{names[i]}\n".encode())
                f.write(_ACGT[asm[starts[i]: starts[i + 1]]].tobytes())
                f.write(b"\n")
    return dict(argv=["-hist", "-sequence", fasta, "-readmers", read_db,
                      "-seqmers", asm_db, "-peak", str(peak)],
                bases=int(asm.size), n_seqs=int(lens.size),
                kasm=int(seq_kasm.sum()), kmissing=int(seq_kmissing.sum()),
                read_keys=int(keys.size), asm_first=asm[: starts[1]], k=k,
                peak=peak, dump_fasta=dump_fasta,
                dump_bases=int(lens[dump_ids].sum()),
                dump_seqs=[(names[i], int(seq_kasm[i]), int(seq_kmissing[i]))
                           for i in dump_ids],
                asm=asm, true=true, subs=pos, starts=starts, names=names,
                read_max=int(vals.max()))


# ------------------------------------------------------ variant world

HEAVY_CLUSTERS = 4        # phase 8's heavy clusters, on scaffold 0
HEAVY_SPACING = 8         # bases between a heavy cluster's variants


def variant_plan(w: dict, d: str, seed: int, heavy_vars: int = 15) -> dict:
    """Phase 8's VCFs, from the full world's own ``asm``/``true`` arrays:

    * the true corrections (REF = asm base, ALT = true base, QUAL 30), but
      none that an N gap overwrote or that no N-free window covers;
    * spurious SNPs (2,000 at 64 Mbp) and 1/2 sites (1,000), each at
      least 3k from any substitution, N, sequence end and other site;
    * HEAVY_CLUSTERS heavy clusters of ``heavy_vars`` variants at
      HEAVY_SPACING, in bench.py's SNP / SNP / 1/2 site / insertion
      cycle (the first kind spurious here): at 15 variants each has
      2^11 x 3^4 = 165,888 candidate paths.

    Writes ``calls.vcf`` (everything) and ``light.vcf`` (no heavy
    clusters) under ``d``; returns their paths, the heavy clusters, the
    cluster counts and the expected -polish/-better and -filter
    records (independent of the port: from the world's arrays alone)."""
    k, asm, starts, names = w["k"], w["asm"], w["starts"], w["names"]
    rng = np.random.default_rng(seed + 8)
    m = 3 * k
    bad = asm == 4
    bad[w["subs"]] = True
    bad[starts[:-1]] = True
    bad[starts[1:] - 1] = True
    base_at, heavy = [], []
    span = heavy_vars * HEAVY_SPACING
    cum = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])

    def clear(lo, hi):
        return cum[np.minimum(hi, asm.size)] - cum[np.maximum(lo, 0)] == 0

    for i in range(HEAVY_CLUSTERS):
        b = int(starts[0] + (starts[1] - starts[0]) * (i + 1)
                // (HEAVY_CLUSTERS + 1))
        while not clear(b - m, b + span + m):
            b += 997
        base_at.append(b)
    for b in base_at:
        bad[b: b + span] = True
    cum = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])
    scale = asm.size / 64e6
    n_snp, n_multi = max(20, round(2000 * scale)), max(10, round(1000 * scale))
    cand = np.sort(rng.choice(asm.size, size=8 * (n_snp + n_multi),
                              replace=False))
    cand = cand[clear(cand - m, cand + m + 1)]
    sites, last = [], -(1 << 62)
    for p in cand.tolist():
        if p - last > 2 * m:
            sites.append(p)
            last = p
    assert len(sites) >= n_snp + n_multi, (len(sites), n_snp + n_multi)
    sites = rng.permutation(np.asarray(sites))[: n_snp + n_multi]

    def where(p):
        i = int(np.searchsorted(starts, p, side="right")) - 1
        return i, names[i], int(p - starts[i])

    base = "ACGT"
    light = []                    # (seq index, row)
    fixes = []
    n_cum = np.concatenate([[0], np.cumsum(asm == 4, dtype=np.int64)])
    for p in np.sort(w["subs"]).tolist():
        i, chrom, loc = where(p)
        lo = np.arange(max(p - k + 1, int(starts[i])),
                       min(p, int(starts[i + 1]) - k) + 1)
        if asm[p] == 4 or not (n_cum[lo + k] == n_cum[lo]).any():
            continue
        row = (chrom, loc, base[asm[p]], base[w["true"][p]], "30", "1/1")
        light.append((i, row))
        fixes.append(row)
    for j, p in enumerate(sites.tolist()):
        i, chrom, loc = where(p)
        ref = base[asm[p]]
        alt = ALT_OF[ref] if j < n_snp else f"{ALT_OF[ref]},{ALT_OF[ALT_OF[ref]]}"
        light.append((i, (chrom, loc, ref, alt, "30",
                          "1/1" if j < n_snp else "1/2")))
    heavy_rows = []
    for b in base_at:
        i, chrom, loc0 = where(b)
        cl = []
        for v in range(heavy_vars):
            p = b + v * HEAVY_SPACING
            ref = base[asm[p]]
            kind = v % 4
            if kind in (0, 1):
                haps, gt = [ref, ALT_OF[ref]], "1/1"
            elif kind == 2:
                haps, gt = [ref, ALT_OF[ref], ALT_OF[ALT_OF[ref]]], "1/2"
            else:
                haps, gt = [ref, ref + base[int(rng.integers(4))]], "1/1"
            cl.append((chrom, loc0 + v * HEAVY_SPACING, ref, ",".join(haps[1:]),
                       "30", gt, haps))
        heavy.append((i, cl))
        heavy_rows += [(i, r[:6]) for r in cl]

    def key(e):
        return e[0], e[1][1]

    contigs = list(names)
    paths = {}
    for tag, rows in (("calls", light + heavy_rows), ("light", light)):
        paths[tag] = os.path.join(d, f"{tag}.vcf")
        write_vcf(paths[tag], contigs, [r for _, r in sorted(rows, key=key)])
    with open(paths["calls"], "rb") as f:
        header = b"".join(ln for ln in f if ln.startswith(b"#"))
    hom = "".join(f"{c}\t{p + 1}\t.\t{r}\t{a}\t30\tPASS\t.\tGT\t1/1\n"
                  for c, p, r, a, _, _ in fixes).encode()
    return dict(vcf=paths["calls"], light_vcf=paths["light"], heavy=heavy,
                n_fixes=len(fixes), n_snp=n_snp, n_multi=n_multi,
                n_variants=len(light) + len(heavy_rows),
                polish=header + hom,
                filter=header + hom.replace(b"\t30\t", b"\t30.0\t"),
                heavy_paths=2 ** sum(1 for v in range(heavy_vars) if v % 4 != 2)
                * 3 ** sum(1 for v in range(heavy_vars) if v % 4 == 2))


def heavy_span(w: dict, plan: dict, windows: int = 1 << 23):
    """The first ``windows``-window span of the first heavy cluster:
    (its sorted query stream as the fused scorer's device program makes
    it: canonical mers, u64::MAX for invalid windows and the padding;
    the span's _pack_inputs; the cluster's path count; the span's
    window count)."""
    from merfin_tpu_torch.kcore.pack import kmers_from_codes_np
    from merfin_tpu_torch.variants.enumerate_fast import build_path_blocks
    from merfin_tpu_torch.variants.device_score import (_pack_inputs,
                                                        split_spans)

    k = w["k"]
    i, cl = plan["heavy"][0]
    seq = _ACGT[w["asm"][w["starts"][i]: w["starts"][i + 1]]].tobytes().decode()
    lo = cl[0][1] - (k - 1)
    hi = cl[-1][1] + len(cl[-1][2]) + (k - 1)
    block = build_path_blocks([(seq[lo:hi], [r[1] - lo for r in cl],
                                [len(r[2]) for r in cl],
                                [r[6] for r in cl])], k)
    i, j, a, b = split_spans(block.starts, block.nis.shape[0], windows)[0]
    fmer, rmer, valid = kmers_from_codes_np(block.stream[a:b], k)
    q = np.full(windows, np.uint64(2**64 - 1))
    q[: fmer.size] = np.where(valid, np.minimum(fmer, rmer),
                              np.uint64(2**64 - 1))
    packed = _pack_inputs(block.stream[a:b], block.adjust[a:b],
                          block.starts[i: j + 1] - a, block.nis[i:j], k)
    return np.sort(q), packed, int(block.nis.shape[0]), int(fmer.size)


def time_span_program(table, w: dict, packed, reps: int) -> float:
    """Median ms of the fused scorer's device program on one packed span
    (inputs already on the card; CUDA events around each run)."""
    import torch

    from merfin_tpu_torch.table.lookup import DeviceLookup
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    # the union-route scorer, given phase 3's union table instead of
    # merging its own from the lookups' rows
    empty = DeviceLookup(np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                         w["k"], device=table.device)
    scorer = DeviceScorer(empty, empty, w["k"], w["peak"], None,
                          max_value=int(w["read_max"]), exact_max=True,
                          sortjoin=True)
    scorer.table = table
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(table.device)
            for x in packed[2:]]
    scorer._score_stream(packed[0], *args)       # warm up
    return _median_ms(lambda: scorer._score_stream(packed[0], *args), reps)


# ------------------------------------------------------- kernel vs plain

def _median_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def dispatch_queries(asm_first: np.ndarray, k: int, rng, windows: int):
    """One dispatch's sorted query stream: the first ``windows`` windows
    of a scaffold (canonical; invalid windows as u64::MAX), with 10%
    replaced by random mers (misses) and 1% by sentinels."""
    from merfin_tpu_torch.kcore.pack import kmers_from_codes_np

    fmer, rmer, valid = kmers_from_codes_np(asm_first[: windows + k - 1], k)
    q = np.where(valid, np.minimum(fmer, rmer), np.uint64(2**64 - 1))
    n_miss, n_sent = windows // 10, windows // 100
    at = rng.choice(windows, size=n_miss + n_sent, replace=False)
    q[at[:n_miss]] = rng.integers(0, 1 << (2 * k), size=n_miss,
                                  dtype=np.uint64)
    q[at[n_miss:]] = np.uint64(2**64 - 1)
    return np.sort(q)


H100_BYTES_PER_S = 3.35e12      # HBM3 of the H100 SXM (data sheet)


def join_bytes(keys, q, nv: int) -> int:
    """The bytes a sorted join must move for sorted queries ``q`` against
    sorted ``keys`` with ``nv`` u32 value columns (tensors on the card):
    8 B a query read, 4 * nv B a result written, the 32-byte sector
    holding each distinct query's lower-bound key, and, for each hit,
    the 32-byte sector of its value in each column; each sector counted
    once, so where the queries are dense this is the window's contiguous
    8 + 4 * nv bytes a key."""
    import torch

    from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias

    m, n = q.numel(), keys.numel()
    total = (8 + 4 * nv) * m
    uq = torch.unique(q[q != U64_MAX])
    if n == 0 or uq.numel() == 0:
        return total
    lb = torch.searchsorted(bias(keys), bias(uq)).clamp_(max=n - 1)
    hit = keys[lb] == uq
    total += 32 * torch.unique(lb // 4).numel()
    total += 32 * nv * torch.unique(lb[hit] // 8).numel()
    return int(total)


# path_sum's earlier design, kept as a measured entry: its key in the
# kernels line and its label
OLD_LABELS = {"two_level_ms": "two-level prefix"}


def time_turns(kernel_fn, plain_fn, reps: int, old=None) -> dict:
    """Median ms of a kernel, its plain version and (where given) its
    earlier design ``old`` = (key of OLD_LABELS, fn), taken in turns
    (plain, kernel, kernel, old, old, plain); the lower median of each,
    the earlier design's under its key."""
    p1 = _median_ms(plain_fn, reps)
    k1 = _median_ms(kernel_fn, reps)
    k2 = _median_ms(kernel_fn, reps)
    o = [_median_ms(old[1], reps) for _ in range(2)] if old else None
    p2 = _median_ms(plain_fn, reps)
    out = dict(ms=min(k1, k2), plain_ms=min(p1, p2))
    if old:
        out[old[0]] = min(o)
    return out


def device_ms(fn, reps: int = 10) -> float:
    """Mean device ms a call of ``fn`` keeps the card busy, from
    torch.profiler's trace of ``reps`` calls: the union of the intervals
    of every CUDA kernel and copy it launches, so that kernels that
    overlap (the window join's bounds pass and the join launched as its
    programmatic dependent) count once.  The CUDA event times include
    the host's launch time; this does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a trace now and then comes back without its device events (seen on
    # the H100 machine); such a trace is taken again, up to 3 times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        if busy > 0:
            return busy / reps / 1e3
    raise AssertionError("no device time in 3 profiler traces")


def measure(keys, q, nv: int, reps: int, kernel_fn, plain_fn) -> dict:
    """time_turns plus the bound (join_bytes over the card's memory
    rate), the library yardstick (one torch.searchsorted of the same
    biased queries into the same biased keys; it yields only the index
    and the port never calls it) and the profiler's device time of the
    kernel and the yardstick (``*_device_ms``)."""
    import torch

    from merfin_tpu_torch.ops.kmer_ops import bias

    out = time_turns(kernel_fn, plain_fn, reps)
    kb, qb = bias(keys), bias(q)

    def library():
        return torch.searchsorted(kb, qb)

    out["library_ms"] = _median_ms(library, reps)
    out["device_ms"] = device_ms(kernel_fn)
    out["library_device_ms"] = device_ms(library)
    out["bytes"] = join_bytes(keys, q, nv)
    out["bound_ms"] = out["bytes"] / H100_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    return out


def fmt_times(t: dict) -> str:
    s = (f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
         f"{t['plain_ms']:.4f} ms")
    for key, label in OLD_LABELS.items():
        if key in t:
            dev = t[key.replace("_ms", "_device_ms")]
            s += f", {label} {t[key]:.4f} ms (device {dev:.4f})"
    if "library_ms" in t:
        s += (f", torch.searchsorted {t['library_ms']:.4f} ms (device "
              f"{t['library_device_ms']:.4f})")
    return s + f", bound {t['bound_ms']:.4f} ms ({t['bytes']} bytes)"


def _u32_err(a, b) -> int:
    """max |a - b| of two tensors of u32 bit patterns (int32)."""
    import torch

    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def check_kernel(table, q_np: np.ndarray, reps: int):
    """Kernel vs plain on a union ``table`` for sorted queries: bit-exact
    checks, max |diff|, hits, and (reps > 0) measure()'s times."""
    import torch

    q = torch.from_numpy(q_np.view(np.int64)).to(table.device)
    kr, ka = table.lookup2_sorted(q)
    pr, pa = table.lookup2_plain(q)
    torch.cuda.synchronize()
    err = max(_u32_err(kr, pr), _u32_err(ka, pa))
    assert torch.equal(kr, pr) and torch.equal(ka, pa), "kernel != plain"
    hits = int(((pr != 0) | (pa != 0)).sum())
    if reps == 0:
        return err, None, hits
    return err, measure(table.keys, q, 2, reps,
                        lambda: table.lookup2_sorted(q),
                        lambda: table.lookup2_plain(q)), hits


def _wall_ms(fn, reps: int) -> float:
    """Median host wall ms of ``fn`` with the card synchronized after."""
    import torch

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def gather_route(w: dict, rdb, adb, table, windows: int, reps: int) -> dict:
    """Phase 3's route row (not a kernel): the -dump dispatch's positional
    probes of the gather tables (plain torch ops, no kernel) beside the
    union route at the same shape.  Queries: the canonical mers of the
    first ``windows`` windows of scaffold 0 in window order, invalid
    windows as the engine probes them (their Ns read as A).  Times (wall,
    CUDA events, profiler device time) of one read-DB probe, of the dump
    step's two probes, of the union route's sort + union_join + scatter
    back to window order, and of each block-strategy table's probe as
    the JAX package writes it (an [M, rows, 16] index, where the port
    copies rows of an overlapping view); the values of all equal."""
    import torch

    from merfin_tpu_torch.ops.kmer_ops import (bias, canonical_and_mult,
                                              kmer_windows)
    from merfin_tpu_torch.table.lookup import DeviceLookup

    t0 = time.perf_counter()
    rl, al = (DeviceLookup(db.keys, db.vals, w["k"], device="cuda")
              for db in (rdb, adb))
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    rl.tree(), al.tree()
    torch.cuda.synchronize()
    place = time.perf_counter() - t0
    codes = torch.from_numpy(w["asm_first"][: windows + w["k"] - 1]).cuda()
    fmer, rmer, _ = kmer_windows(codes, w["k"])
    canon, _ = canonical_and_mult(fmer, rmer)

    def union():
        keys_s, order = torch.sort(bias(canon))
        out = []
        for x in table.lookup2_sorted(bias(keys_s)):
            y = torch.empty_like(x)
            y[order] = x
            out.append(y)
        return out

    r_u, a_u = union()
    assert torch.equal(rl.lookup(canon), r_u.to(torch.int64) & 0xFFFFFFFF)
    assert torch.equal(al.lookup(canon), a_u.to(torch.int64) & 0xFFFFFFFF)
    row = dict(windows=windows, tables=[(x.strategy, x.rows, x.bits)
                                        for x in (rl, al)],
               table_build_s=build, table_place_s=place,
               gather_gb=(rl.memory_bytes() + al.memory_bytes()) / 1e9)
    runs = [("read", lambda: rl.lookup(canon)),
            ("dump_step", lambda: (rl.lookup(canon), al.lookup(canon))),
            ("union", union)]
    for db, lk in (("read", rl), ("asm", al)):
        if lk.strategy == "block":
            assert torch.equal(indexed_block(lk, canon), lk.lookup(canon))
            runs += [(f"{db}_block", lambda lk=lk: lk.lookup(canon)),
                     (f"{db}_block_indexed",
                      lambda lk=lk: indexed_block(lk, canon))]
    for tag, fn in runs:
        fn()
        row[tag] = dict(wall_ms=_wall_ms(fn, reps), ms=_median_ms(fn, reps),
                        device_ms=device_ms(fn))
    return row


def indexed_block(lk, q):
    """A gather table's block probe as the JAX package writes it
    (``merfin_tpu/table/lookup.py:229-240``): an [M, rows, 16] index."""
    import torch

    keys, vals, offsets = lk.tree()
    b = (q >> lk.shift) & ((1 << (64 - lk.shift)) - 1)
    r = torch.clamp(offsets[b].to(torch.int64) // lk.window,
                    max=lk.nblocks - lk.rows)
    rows = r[:, None] + torch.arange(lk.rows, device=q.device)
    match = keys.view(-1, lk.window)[rows] == q[:, None, None]
    v = torch.where(match, vals.view(-1, lk.window)[rows], 0)
    return v.sum(dim=(1, 2), dtype=torch.int64) & 0xFFFFFFFF


def check_single(table, q_np: np.ndarray, reps: int):
    """check_kernel for a single-value table: SortedJoinTable or the
    window join's SortJoinTable."""
    import torch

    q = torch.from_numpy(q_np.view(np.int64)).to(table.device)
    got = table.lookup_sorted(q)
    want = table.lookup_plain(q)
    torch.cuda.synchronize()
    err = _u32_err(got, want)
    assert torch.equal(got, want), f"{table.kernel.name} kernel != plain"
    hits = int((want != 0).sum())
    if reps == 0:
        return err, None, hits
    return err, measure(table.keys, q, 1, reps,
                        lambda: table.lookup_sorted(q),
                        lambda: table.lookup_plain(q)), hits


def path_sum_spans(w: dict, plan: dict, rng, windows: int = 1 << 23):
    """The path-sum kernel's shapes on the main path (the fused scorer's
    f64 branch, -prob), [(label, values f64, b_start, b_end int64)]:
    "heavy span", the bounds of the first ``windows``-window span of a
    heavy cluster (heavy_span's, padded as the scorer pads them); "light
    span", the widest dispatch of light clusters (query_budget windows),
    whose SNP and 1/2-site paths are each a 2k-1-base stretch and k-1
    separators: k windows every 3k-2 (padded alike).  The values
    are what the branch's per-window deltas are: 0 or plus or minus a
    table probability."""
    k = w["k"]
    _, packed, _, _ = heavy_span(w, plan, windows)
    spans = [("heavy span", packed[-2].astype(np.int64),
              packed[-1].astype(np.int64))]
    P = (windows - k) // (3 * k - 2) + 1
    b_start = np.zeros(max(64, 1 << (P - 1).bit_length()), np.int64)
    b_start[:P] = np.arange(P) * (3 * k - 2)
    b_end = b_start.copy()
    b_end[:P] += k
    spans.append(("light span", b_start, b_end))
    out = []
    for label, b_start, b_end in spans:
        vals = rng.integers(-1, 2, windows) * (1.0 - rng.random(windows)
                                               * 3e-3)
        out.append((label, vals, b_start, b_end))
    return out


def check_path_sum(spans: list, reps: int, device: str = "cuda"):
    """The path-sum kernel against its plain version (path_sums_plain:
    the same order, one column of the paths at a time) on each of
    ``spans``, bit for bit; with reps > 0 each span's times: kernel and
    plain in turns with the two-level prefix difference it replaced (the
    earlier design; another order, so not bit-exact), the profiler's
    device times and the bound (8 B a path window read, 16 B of bounds
    read and 8 B written a path slot, over 3.35 TB/s).  -> (max |kernel -
    plain| over every span, {label: times})."""
    import torch

    from merfin_tpu_torch.ops.path_sum import path_sums, path_sums_plain
    from merfin_tpu_torch.variants.device_score import _prefix

    errs, shapes = [], {}
    for label, vals_np, s_np, e_np in spans:
        v, s, e = (torch.from_numpy(x).to(device)
                   for x in (vals_np, s_np, e_np))
        got, want = path_sums(v, s, e), path_sums_plain(v, s, e)
        errs.append(float((got - want).abs().max()) if got.numel() else 0.0)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64)), \
            f"path_sum kernel != plain on the {label}"
        if not reps:
            continue

        def two_level(v=v, s=s, e=e):
            at = _prefix(v, torch.float64)
            return at(e) - at(s)

        def kernel(v=v, s=s, e=e):
            return path_sums(v, s, e)

        t = time_turns(kernel, lambda: path_sums_plain(v, s, e), reps,
                       ("two_level_ms", two_level))
        t["device_ms"] = device_ms(kernel)
        t["two_level_device_ms"] = device_ms(two_level)
        t["bytes"] = int(8 * (e - s).clamp(min=0).sum() + 24 * s.numel())
        t["bound_ms"] = t["bytes"] / H100_BYTES_PER_S * 1e3
        t["bound_by"] = "bytes"
        t["paths"] = int((e > s).sum())
        t["windows"] = int(v.numel())
        shapes[label] = t
    return max(errs), shapes


def ratio_queries(rng, keys: np.ndarray, m: int, lo: int, hi: int):
    """``m`` sorted queries: table keys, 10% random mers in [lo, hi)
    (misses, bar chance hits) and 1% sentinels."""
    n_miss, n_sent = m // 10, m // 100
    q = np.concatenate([
        keys[rng.integers(0, keys.size, size=m - n_miss - n_sent)],
        rng.integers(lo, hi, size=n_miss, dtype=np.uint64),
        np.full(n_sent, np.uint64(2**64 - 1))])
    return np.sort(q)


def kernel_report(errs: list, shapes: dict, main: str) -> dict:
    """One kernel's entry of the kernels line: max |kernel - plain| over
    every case, the times of its main path's shape at the top level,
    every timed shape under "shapes"."""
    return dict(max_abs_err=max(errs), **{
        k: v for k, v in shapes[main].items() if k != "bytes"},
        shapes=shapes)


def check_single_kernels(adb, rdb, rng, reps: int, edges: list,
                         mesh_q: list) -> dict:
    """Phase 3, the single-value kernels (sorted_join, window_join) vs
    their plain versions, bit-exact: the full world's asm table against one
    2^22 block of sorted read-DB keys (the completeness dispatch, timed), a
    v1-ratio table of 2^21 keys against 2^20 sorted queries (timed) and at
    a ragged length, a k=31 table with keys near 2^62, values near 2^32-1,
    and the ``edges`` of join_edge_cases.  sorted_join also at the mesh
    paths' shapes (timed): the full read-DB and asm tables against each
    (path, label, sorted queries) of ``mesh_q``.  -> {kernel name:
    report}."""
    import torch

    from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
    from merfin_tpu_torch.ops.window_join import SortJoinTable

    smi = smi_line()
    mid = max(0, rdb.distinct // 2 - (1 << 21))
    cases = [("completeness block: asm table x 2^22 read-DB keys", adb.keys,
              adb.vals, np.array(rdb.keys[mid: mid + (1 << 22)]),
              "completeness block")]
    k21 = 1 << 42
    rk = np.unique(rng.integers(0, k21, size=(1 << 21) + 4096,
                                dtype=np.uint64))[: 1 << 21]
    rv = rng.integers(1, 1 << 16, size=rk.size).astype(np.uint32)
    rq = ratio_queries(rng, rk, 1 << 20, 0, k21)
    cases += [("v1 ratio: 2^21 keys x 2^20 queries", rk, rv, rq, "v1 ratio"),
              ("ragged 2^20-77", rk, rv, rq[: (1 << 20) - 77], None)]
    top = (1 << 62) - 1
    k31 = np.unique(np.uint64(top) - rng.integers(0, 1 << 40, size=1 << 20,
                                                  dtype=np.uint64))
    cases.append(("k=31 keys near 2^62", k31,
                  rng.integers(1, 1000, size=k31.size).astype(np.uint32),
                  ratio_queries(rng, k31, 1 << 19, top - (1 << 40), top),
                  None))
    big = (np.uint32(0xFFFFFFFF)
           - rng.integers(0, 1000, size=rk.size).astype(np.uint32))
    cases.append(("values near 2^32-1", rk, big, rq, None))
    cases += [(f"edge: {label}", keys, v0, q, None)
              for label, keys, v0, _, q in edges]
    # a 1x1 mesh's shard is the whole DB's table: -hist and -dump probe
    # both tables with each dispatch, the variant scorer with each span
    mesh_cases = [(f"{path}: {db} table x {label}", d.keys, d.vals, q,
                   f"{path}, {db} table")
                  for path, label, q in mesh_q
                  for db, d in (("read-DB", rdb), ("asm", adb))]

    cfg = SortJoinTable.kernel.config()
    say(f"  window join built with tile {cfg['tile']}, chunk {cfg['chunk']} "
        f"keys, dense up to {cfg['wide']} keys a query")
    runs = [(f"equal keys: {label}", keys, vals, q, None)
            for label, keys, vals, q in window_edge_cases(rng, cfg)]
    report = {}
    for cls in (SortedJoinTable, SortJoinTable):
        name = cls.kernel.name
        errs, shapes = [], {}
        for label, keys, vals, q, shape in cases + (
                runs if cls is SortJoinTable else mesh_cases):
            table = cls(keys, vals, "cuda")
            err, times, hits = check_single(table, q,
                                            reps if shape else 0)
            errs.append(err)
            msg = (f"  {name}, {label} ({table.n} keys, {q.size} queries, "
                   f"{hits} hits): bit-exact")
            if shape:
                shapes[shape] = times
                msg += f"; {fmt_times(times)} (median of {reps}; {smi})"
            say(msg)
            del table
            torch.cuda.empty_cache()
        report[name] = kernel_report(errs, shapes, "completeness block")
    return report


def join_edge_cases(rng, cfg: dict) -> list:
    """(label, keys u64, vals0 u32, vals1 u32, sorted queries u64) for
    the windowed join's edges at its built constants (``cfg``: the
    kernel wrapper's config()): k=32 keys with bit 63 set, n = 0 and
    n = 1, a ragged length, heavy duplication, values >= 2^31, and one
    table whose tiles' windows sit on each side of the dense/sparse
    threshold, of one and two shared-memory chunks of fences (windows
    larger than shared memory) and of the sparse/device-memory search
    threshold, ending in a tile of sentinels and a ragged tile."""
    tile, fence, smem = cfg["tile"], cfg["fence"], cfg["smem"]
    wide = cfg["fences_per_query"] * tile
    top = np.iinfo(np.uint64).max
    sent = np.uint64(top)

    def vals(n, lo=1, hi=1 << 32):
        return rng.integers(lo, hi, size=n).astype(np.uint32)

    def mixed(keys, m, n_sent):
        parts = [rng.integers(0, top, size=m // 2, dtype=np.uint64),
                 np.full(n_sent, sent)]
        if keys.size:
            parts.append(keys[rng.integers(0, keys.size,
                                           size=m - m // 2 - n_sent)])
        return np.sort(np.concatenate(parts))

    cases = []
    k32 = np.unique(rng.integers(1 << 63, top, size=50_000, dtype=np.uint64))
    k32 = np.unique(np.concatenate([k32, rng.integers(
        0, 1 << 63, size=50_000, dtype=np.uint64)]))
    cases.append(("k=32 keys, bit 63 set", k32, vals(k32.size),
                  vals(k32.size), mixed(k32, 8 * tile, tile // 3)))
    e = np.zeros(0, np.uint64)
    cases.append(("n = 0", e, vals(0), vals(0), mixed(e, 3 * tile, 5)))
    one = np.asarray([rng.integers(1, top - 1, dtype=np.uint64)])
    q1 = np.sort(np.concatenate([np.repeat(one, tile + 3), one - 1, one + 1,
                                 np.full(9, sent)]))
    cases.append(("n = 1", one, vals(1), vals(1), q1))
    cases.append(("ragged length", k32, vals(k32.size), vals(k32.size),
                  mixed(k32, 5 * tile + 7, 0)[: 5 * tile + 7]))
    few = k32[rng.integers(0, k32.size, size=40)]
    dup = np.sort(np.concatenate([np.repeat(few, 997),
                                  np.full(3 * tile + 1, sent)]))
    cases.append(("heavy duplication", k32, vals(k32.size), vals(k32.size),
                  dup))
    cases.append(("values >= 2^31", k32, vals(k32.size, 1 << 31),
                  vals(k32.size, 1 << 31), mixed(k32, 4 * tile, 11)))

    # one tile per window of W keys, starting at an odd leaf (so the
    # fence slice starts at an odd, unaligned index)
    widths = [smem - fence, smem, smem + fence, fence * (smem - 2),
              fence * (smem - 1), fence * (2 * smem - 4),
              fence * (2 * smem - 3), fence * wide, fence * (wide + 1),
              3 * fence * wide // 2]
    n = sum(widths) + fence * (2 * len(widths) + 8)
    # even keys; the odd values between them are misses
    keys = np.arange(n, dtype=np.uint64) * np.uint64(2) + np.uint64(1000)
    q, s = [], fence
    for w in widths:
        inner = keys[s] + rng.integers(0, 2 * (w - 1), size=tile - 2,
                                       dtype=np.uint64)
        q.append(np.sort(np.concatenate([[keys[s]], inner,
                                         [keys[s + w - 1]]])))
        s += w + fence
        s += fence if (s // fence) % 2 == 0 else 0
    q.append(np.sort(keys[s:][rng.integers(0, n - s, size=tile)]))
    q.append(np.full(tile + tile // 2 + 3, sent))
    cases.append(("windows around the dense/sparse threshold and the "
                  "shared-memory fence capacity", keys, vals(n), vals(n),
                  np.concatenate(q)))
    return cases


def window_edge_cases(rng, cfg: dict) -> list:
    """(label, keys u64, vals u32, sorted queries u64) for the window
    join, whose table keys repeat and sum, at its built constants
    (``cfg``: the kernel wrapper's config(), tile T, chunk C and wide W
    keys a query): runs of 2-5 equal keys with tile boundaries inside
    runs of equal queries, a ragged length and sentinels; then one table
    of runs of 1-5 equal keys (full-range u32 values, so sums wrap) whose
    tiles' windows sit on each side of the chunk size, of two chunks and
    of the dense/wide threshold (W * T keys), each window with a run
    across every chunk boundary it has, one window holding a run longer
    than 4 chunks and 5,000 keys, and a wide one holding a run longer
    than a chunk, ending in a tile of sentinels and a ragged tile; and
    that table again with values near 2^32-1."""
    tile, chunk, wide = cfg["tile"], cfg["chunk"], cfg["wide"]
    sent = np.uint64(np.iinfo(np.uint64).max)
    cases = []

    # runs of 2-5 equal keys; the queries around every tile boundary all
    # equal one run's key, so two tiles' windows share that run
    base = np.unique(rng.integers(0, 1 << 42, size=6 * tile,
                                  dtype=np.uint64))
    keys = np.repeat(base, rng.integers(2, 6, size=base.size))
    m = 8 * tile + 5
    q = np.sort(np.concatenate([
        base[rng.integers(0, base.size, size=m - m // 4 - 40)],
        rng.integers(0, 1 << 42, size=m // 4, dtype=np.uint64),
        np.full(40, sent)]))
    for b in range(1, m // tile):
        i = b * tile
        y = keys[min(np.searchsorted(keys, q[i]), keys.size - 1)]
        if y >= q[i] and y <= q[i + 5] and q[i + 5] != sent:
            q[i - 5: i + 5] = y
    cases.append(("runs of 2-5 equal keys, tile boundaries inside runs "
                  "of equal queries, ragged, sentinels", keys,
                  rng.integers(0, 1 << 32, size=keys.size).astype(np.uint32),
                  q))

    # runs of 1-5 keys (run r has key 1000 + 2r; odd values miss); one
    # tile of queries per window [s, s + w), which starts and ends on run
    # boundaries and has a run across each of its chunk boundaries; the
    # windows are adjacent, since a tile's window reaches the next
    # tile's first key
    widths = [chunk - 1, chunk, chunk + 1, 2 * chunk, 2 * chunk + 1,
              max(5000, 4 * chunk) + 64, wide * tile, wide * tile + 1,
              2 * wide * tile]
    lens, windows, pos = [], [], 0

    def runs(total, cuts, long_run=0):
        """run lengths summing to ``total``; no run ends at a cut; one
        run of ``long_run`` keys in the middle"""
        out, p = [], 0
        while p < total:
            n_run = long_run if long_run and p >= 16 else \
                int(rng.integers(1, 6))
            long_run = 0 if n_run == long_run else long_run
            if p + n_run in cuts:
                n_run += 2
            n_run = min(n_run, total - p)
            out.append(n_run)
            p += n_run
        return out

    for w in widths:
        cuts = set(range(chunk, w, chunk))
        big = max(5000, 4 * chunk + 3) if w == widths[5] else \
            (chunk + 7 if w == widths[-1] else 0)
        windows.append((pos, w))
        lens += runs(w, cuts, big)
        pos += w
    lens += [3] * (2 * tile)
    ids = np.repeat(np.arange(len(lens), dtype=np.uint64), lens)
    keys = np.uint64(1000) + np.uint64(2) * ids
    qs = []
    for s, w in windows:
        inner = keys[s] + rng.integers(0, keys[s + w - 1] - keys[s] + 1,
                                       size=tile - 2, dtype=np.uint64)
        qs.append(np.sort(np.concatenate([[keys[s]], inner,
                                          [keys[s + w - 1]]])))
    tail = keys[pos:]
    qs.append(np.sort(tail[rng.integers(0, tail.size, size=tile)]))
    qs.append(np.full(tile + tile // 2 + 3, sent))
    q = np.concatenate(qs)
    for label, vals in (
            ("windows around the chunk size and the dense/wide threshold, "
             "runs across chunk boundaries, a run of 5,000+ keys",
             rng.integers(0, 1 << 32, size=keys.size).astype(np.uint32)),
            ("the same, values near 2^32-1",
             np.uint32(0xFFFFFFFF)
             - rng.integers(0, 1000, size=keys.size).astype(np.uint32))):
        cases.append((label, keys, vals, q))
    return cases


def palindrome_table(rng, k: int = 20, n: int = 1 << 20):
    """A k=20 union table holding palindromic keys, and sorted queries
    that hit them."""
    from merfin_tpu_torch.kcore.pack import revcomp_np

    half = rng.integers(0, 1 << k, size=4096, dtype=np.uint64)
    pal = (half << np.uint64(k)) | (revcomp_np(half, k // 2))
    rand = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    rk = np.unique(np.concatenate([pal, rand]))
    rv = rng.integers(1, 1 << 20, size=rk.size).astype(np.uint32)
    ak = np.unique(np.concatenate([pal[::2], rand[::5]]))
    av = rng.integers(1, 9, size=ak.size).astype(np.uint32)
    q = np.sort(np.concatenate([
        np.repeat(pal, 16), rk[rng.integers(0, rk.size, size=1 << 19)],
        rng.integers(0, 1 << (2 * k), size=(1 << 20) - (1 << 19) - 16 * 4096,
                     dtype=np.uint64)]))
    return (rk, rv, ak, av), q


# ------------------------------------------------------------------ main

def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=float, default=64.0,
                    help="full-size assembly length in Mbp")
    ap.add_argument("--error-kmers", type=int, default=128 << 20)
    ap.add_argument("--small-bases", type=int, default=200_000)
    ap.add_argument("--repeat", type=int, default=40_000)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed launches per kernel/plain measurement")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    os.environ["MERFIN_PLATFORM"] = "cuda"
    from merfin_tpu_torch.ops import _build
    from merfin_tpu_torch.ops.path_sum import path_sum_kernel
    from merfin_tpu_torch.ops.sorted_join import sorted_join_kernel
    from merfin_tpu_torch.ops.union_join import (UnionTable,
                                                 union_join_kernel)
    from merfin_tpu_torch.ops.window_join import window_join_kernel

    with phase("1 device"):
        smi = smi_line()
        cap = torch.cuda.get_device_capability(0)
        say(f"  nvidia-smi: {smi}")
        say(f"  torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} capability {cap} "
            f"count {torch.cuda.device_count()}")
        assert cap == (9, 0), f"needs compute capability (9, 0), got {cap}"

    kernels = (union_join_kernel, sorted_join_kernel, window_join_kernel,
               path_sum_kernel)
    with phase("2 build"):
        t0 = time.perf_counter()
        libs = sorted({kern.lib for kern in kernels})
        _build.build_all(libs)          # one nvcc per source, in parallel
        for kern in kernels:
            kern.build()
        say(f"  built {', '.join(_build.library_path(n).name for n in libs)}"
            f" in {time.perf_counter() - t0:.1f} s")
        for lib in libs:
            for line in _build.BUILD_LOGS.get(lib, "").splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {lib}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        with phase("3 kernel vs plain"):
            t0 = time.perf_counter()
            w = full_world(_mkdir(os.path.join(tmp, "full")), args.seed,
                           args.mbp, args.error_kmers, "cuda")
            say(f"  full world: {w['bases']} bases, {w['n_seqs']} sequences, "
                f"{w['read_keys']} read keys ({time.perf_counter() - t0:.1f} s)")
            from merfin_tpu_torch.io.mkdb import KmerDB

            rdb = KmerDB(w["argv"][4])
            adb = KmerDB(w["argv"][6])
            t0 = time.perf_counter()
            table = UnionTable.from_dbs(rdb.keys, rdb.vals, adb.keys,
                                        adb.vals, "cuda")
            say(f"  union table: {table.n} keys, {table.nbytes() / 1e9:.2f} GB "
                f"on the card ({time.perf_counter() - t0:.1f} s)")
            q = dispatch_queries(w["asm_first"], w["k"], rng, 1 << 20)
            err, hist_t, hits = check_kernel(table, q, args.reps)
            say(f"  -hist dispatch, 2^20 sorted queries ({hits} hits): "
                f"bit-exact; {fmt_times(hist_t)} "
                f"(median of {args.reps}; {smi})")
            err2, *_ = check_kernel(table, q[: (1 << 20) - 77], 0)
            say("  ragged length 2^20-77: bit-exact")
            plan = variant_plan(w, os.path.join(tmp, "full"), args.seed)
            qv, packed, n_paths, n_win = heavy_span(w, plan)
            err4, span_t, hits = check_kernel(table, qv, args.reps)
            say(f"  variant span: the first 2^23-window span of a heavy "
                f"cluster ({n_paths} paths; {n_win} windows in the span, "
                f"{np.unique(qv).size} distinct queries, {hits} hits): "
                f"bit-exact; {fmt_times(span_t)} (median of {args.reps}; "
                f"{smi})")
            span_ms = time_span_program(table, w, packed, args.reps)
            say(f"  fused scorer program on that span (unpack to boundary "
                f"reduce, inputs on the card): {span_ms:.4f} ms, union_join "
                f"{100 * span_t['ms'] / span_ms:.1f}% of it (median of "
                f"{args.reps}; {smi})")
            route = gather_route(w, rdb, adb, table, 1 << 21, args.reps)
            say(f"  route row, -dump dispatch ({route['windows']} positional "
                f"windows; gather tables (strategy, rows, bucket bits): read "
                f"DB {route['tables'][0]}, asm DB {route['tables'][1]}; "
                f"{route['gather_gb']:.2f} GB, built "
                f"{route['table_build_s']:.1f} s, placed "
                f"{route['table_place_s']:.1f} s): values equal the union "
                f"route's; " + "; ".join(
                    f"{tag} {t['wall_ms']:.4f} ms wall, {t['ms']:.4f} ms "
                    f"events, {t['device_ms']:.4f} ms device"
                    for tag, t in ((lab, route[key]) for lab, key in (
                        ("read-DB gather probe", "read"),
                        ("both gather probes", "dump_step"),
                        ("union sort + join + scatter", "union"),
                        ("read-DB block probe", "read_block"),
                        ("JAX-literal read-DB block probe",
                         "read_block_indexed"),
                        ("asm-DB block probe", "asm_block"),
                        ("JAX-literal asm-DB block probe",
                         "asm_block_indexed")) if key in route))
                + f" (median of {args.reps}; {smi})")
            del table
            torch.cuda.empty_cache()
            tabs, qp = palindrome_table(rng)
            ptable = UnionTable.from_dbs(*tabs, "cuda")
            errs = [err, err2, err4, check_kernel(ptable, qp, 0)[0]]
            say(f"  k=20 palindrome table ({ptable.n} keys): bit-exact")
            del ptable
            cfg = union_join_kernel.config()
            say(f"  windowed join built with tile {cfg['tile']}, fence "
                f"stride {cfg['fence']}, {cfg['smem']} shared-memory "
                f"entries, {cfg['fences_per_query']} fences a query")
            edges = join_edge_cases(rng, cfg)
            for label, keys, v0, v1, qe in edges:
                etable = UnionTable(keys, v0, v1, "cuda")
                errs.append(check_kernel(etable, qe, 0)[0])
                say(f"  edge: {label} ({etable.n} keys, {qe.size} queries): "
                    "bit-exact")
                del etable
            torch.cuda.empty_cache()
            report[union_join_kernel.name] = kernel_report(
                errs, {"-hist dispatch": hist_t, "variant span": span_t},
                "-hist dispatch")
            q19 = dispatch_queries(w["asm_first"], w["k"], rng, 1 << 19)
            report.update(check_single_kernels(
                adb, rdb, rng, args.reps, edges,
                [("mesh dispatch", "2^19 sorted windows", q19),
                 ("mesh variant span", "the heavy 2^23-window span", qv)]))
            ps_err, ps_t = check_path_sum(path_sum_spans(
                w, plan, np.random.default_rng(args.seed + 23)), args.reps)
            for label, t in ps_t.items():
                say(f"  path_sum, {label} ({t['paths']} paths, "
                    f"{t['windows']} windows): bit-exact; {fmt_times(t)} "
                    f"(median of {args.reps}; {smi})")
            report[path_sum_kernel.name] = kernel_report(
                [ps_err], ps_t, "heavy span")

        # each main path runs with the launch counts set to 0 just before
        # it and read just after; a kernel reports its launches in each
        # path and their sum
        by_path = {kern.name: {} for kern in kernels}
        with phase("4 oracle"):
            check_small_worlds(tmp, args.seed, args.small_bases, args.repeat,
                               "cuda")
            check_small_modes(tmp, args.seed, args.small_bases, "cuda")
            by_path[path_sum_kernel.name]["-polish -prob"] = \
                check_small_variants(tmp, args.seed, args.small_bases,
                                     "cuda")
        with phase("5 full"):
            by_path[union_join_kernel.name]["-hist"] = _run_full(
                w, os.path.join(tmp, "full", "run"))

        with phase("6 completeness full"):
            n = _run_completeness_full(w, os.path.join(tmp, "full", "compl"))
            by_path[sorted_join_kernel.name]["-completeness"] = \
                n[sorted_join_kernel.name]
            by_path[window_join_kernel.name]["-completeness, v1 table"] = \
                n[window_join_kernel.name]

        with phase("7 dump full"):
            by_path[union_join_kernel.name]["-dump"] = _run_dump_full(
                w, os.path.join(tmp, "full", "dump"))

        with phase("8 variants full"):
            by_path[union_join_kernel.name]["variant modes"] = \
                _run_variants_full(w, plan,
                                   os.path.join(tmp, "full", "variants"))

        with phase("9 count full"):
            by_path[sorted_join_kernel.name][
                "-completeness, sequence DB counted"] = _run_count_full(
                    w, os.path.join(tmp, "full", "count"), args.seed)

        with phase("10 mesh full"):
            by_path[sorted_join_kernel.name].update(_run_mesh_full(
                w, plan, os.path.join(tmp, "full", "mesh")))

        with phase("11 two processes"):
            _run_two_process(w, os.path.join(tmp, "two"), args.seed,
                             args.small_bases)

    print(json.dumps({"kernels": [{
        "name": kern.name, "route": "cuda", "source": kern.source,
        "replaces": kern.replaces,
        "launches": sum(by_path[kern.name].values()),
        "launches_by_path": by_path[kern.name],
        **report[kern.name]} for kern in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_full(w: dict, cwd: str) -> int:
    """Phase 5: the full world through the CLI entry point; returns the
    union-join kernel launches of that run."""
    import torch

    from merfin_tpu_torch.ops.union_join import union_join_kernel

    on_card = _on_card()
    marks = ("-- Loading kmers", "-- Generate histogram",
             "-- Using sorted-join", "K-mers not found")
    log = StampedLog(marks)
    union_join_kernel.launches = 0
    with gather_timers() as tables:
        hist, err, counters = run_port_inprocess(w["argv"], cwd, log)
    if on_card:
        torch.cuda.synchronize()
        assert tables["place"] == 0.0, "the union route placed a gather table"
    wall = time.perf_counter() - log.t0
    launches = union_join_kernel.launches
    summary = summary_of(err)
    for line in summary:
        say(f"  {line}")
    assert summary[0] == f"K-mers not found in reads (missing) : {w['kmissing']}", (
        summary[0], w["kmissing"])
    assert summary[2] == f"K-mers found in the assembly: {w['kasm']}", (
        summary[2], w["kasm"])
    assert len(seq_lines_of(err)) == w["n_seqs"]
    assert counters == {c: 0 for c in COUNTERS}, counters
    assert hist.count(b"\n") >= 1
    if on_card:
        assert launches > 0, "the full -hist run never launched the kernel"
    w["hist_out"], w["hist_err"] = hist, err    # phases 10 and 11
    t = [log.stamps[m] for m in marks]
    if t[2] is None:        # the CPU's default: the gather route
        t[2] = t[1]
    say(f"  split: start->DB load {t[0]:.1f} s, DB load {t[1] - t[0]:.1f} s, "
        f"union table build+upload {t[2] - t[1]:.1f} s, hist loop "
        f"{t[3] - t[2]:.1f} s, output {wall - t[3]:.1f} s")
    say(f"  -hist wall {wall:.1f} s for {w['bases']} bases: "
        f"{w['bases'] / wall:.0f} bases/s; kernel launches {launches}; "
        f"counters {counters}")

    # -nosortjoin: the gather route, no union table, no union_join launch
    marks = ("-- Loading kmers", "-- Generate histogram", "K-mers not found")
    log = StampedLog(marks)
    union_join_kernel.launches = 0
    with gather_timers() as spent, refused_union():
        g_hist, g_err, g_counters = run_port_inprocess(
            w["argv"] + ["-nosortjoin"], cwd + "-gather", log)
    if on_card:
        torch.cuda.synchronize()
    g_wall = time.perf_counter() - log.t0
    assert union_join_kernel.launches == 0, union_join_kernel.launches
    assert g_hist == hist and g_counters == counters, g_counters
    assert g_err == err.replace(
        "-- Using sorted-join lookup kernel for -hist.\n", ""), \
        "-nosortjoin stderr != -hist's"
    t = [log.stamps[m] for m in marks]
    say(f"  -hist -nosortjoin (gather tables): phase 5's histogram, lines "
        f"and counters; wall {g_wall:.1f} s: DB load + gather-table build "
        f"{t[1] - t[0]:.1f} s (build {spent['build']:.1f}), hist loop "
        f"{t[2] - t[1]:.1f} s (first placement {spent['place']:.1f}), "
        f"output {g_wall - t[2]:.1f} s; union_join launches 0")
    return launches


def gather_timers():
    """Seconds spent building the gather tables on the host
    (``DeviceLookup.__init__``) and placing them (``tree``, whose first
    call copies the table to the device)."""
    from merfin_tpu_torch.table.lookup import DeviceLookup

    return timers({"build": (DeviceLookup, "__init__"),
                   "place": (DeviceLookup, "tree")})


@contextlib.contextmanager
def refused_union():
    """A block in which building a UnionTable fails."""
    from merfin_tpu_torch.ops.union_join import UnionTable

    def refuse(*a, **kw):
        raise AssertionError("a union table was built on the gather route")

    saved = UnionTable.__init__
    UnionTable.__init__ = refuse
    try:
        yield
    finally:
        UnionTable.__init__ = saved


def _on_card() -> bool:
    import torch

    return torch.cuda.is_available() and \
        os.environ.get("MERFIN_PLATFORM") == "cuda"


def expected_completeness(read_db, asm_db, peak: float):
    """Independent numpy totals (no -prob table): readK by getK's rule
    read from merfin-globals.C:66-98 (0 for 0, 1 below the peak, else
    round(v/peak)); asmK by a search of the asm keys among the read
    keys; undrcpy = sum of readK - asmK where readK > asmK."""
    rk = np.asarray(read_db.keys)
    rv = np.asarray(read_db.vals).astype(np.float64)
    read_k = np.where(rv < peak, np.minimum(rv, 1.0),
                      np.floor(rv / peak + 0.5))
    del rv
    total = float(read_k.sum())
    ak = np.asarray(asm_db.keys)
    idx = np.minimum(np.searchsorted(rk, ak), rk.size - 1)
    hit = rk[idx] == ak
    r_hit = read_k[idx[hit]]
    a_hit = np.asarray(asm_db.vals)[hit].astype(np.float64)
    undrc = total - float(r_hit.sum()) + float(
        np.maximum(r_hit - a_hit, 0.0).sum())
    return total, undrc


def _run_completeness_full(w: dict, cwd: str) -> dict:
    """Phase 6: -completeness on the full world's DBs through the CLI
    (v4 route: sorted_join), held to the independent numpy totals, then
    run_completeness on a v1 table (window_join) held to the CLI's lines.
    Returns both kernels' launches."""
    import torch

    import merfin_tpu_torch.modes.completeness as compl
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.ops.sorted_join import sorted_join_kernel
    from merfin_tpu_torch.ops.window_join import window_join_kernel

    on_card = _on_card()
    argv = mode_argv(w["argv"], "completeness")
    rdb, adb = KmerDB(argv[2]), KmerDB(argv[4])
    block = 1 << 22
    n_blocks = -(-rdb.distinct // block)
    t0 = time.perf_counter()
    total, undrc = expected_completeness(rdb, adb, w["peak"])
    say(f"  numpy expectation: total {total:.2f}, undrcpy {undrc:.5f} "
        f"({time.perf_counter() - t0:.1f} s)")

    built = {}
    build = compl.build_asm_table

    def timed_build(*a, **kw):
        t = time.perf_counter()
        table = build(*a, **kw)
        if on_card:
            torch.cuda.synchronize()
        built["s"] = time.perf_counter() - t
        return table

    marks = ("-- Compute completeness.", "thread  0")
    log = StampedLog(marks)
    compl.build_asm_table = timed_build
    sorted_join_kernel.launches = 0
    try:
        _, err, _ = run_port_inprocess(argv, cwd, log, out="unused")
        if on_card:
            torch.cuda.synchronize()
    finally:
        compl.build_asm_table = build
    wall = time.perf_counter() - log.t0
    launches = sorted_join_kernel.launches

    lines = w["completeness_lines"] = completeness_lines(err)
    for line in lines[-3:]:
        say(f"  {line}")
    assert lines[-3] == f"TOTAL readK:   {total:15.2f}", (lines[-3], total)
    assert lines[-2] == f"TOTAL undrcpy:    {undrc:15.5f}", (lines[-2], undrc)
    cols = np.array([[float(x) for x in ln.split()[3:6:2]]
                     for ln in lines[:-3]])
    assert cols.shape == (64, 2)
    assert cols[:, 0].sum() == total and cols[:, 1].sum() == undrc
    if on_card:
        assert launches == n_blocks, (launches, n_blocks)
    t = [log.stamps[m] for m in marks]
    say(f"  split: DB load + checks {t[0]:.1f} s, asm table build+upload "
        f"{built['s']:.1f} s, value map + stream loop "
        f"{t[1] - t[0] - built['s']:.1f} s, output {wall - t[1]:.1f} s")
    say(f"  -completeness wall {wall:.1f} s for {rdb.distinct} read k-mers: "
        f"{rdb.distinct / wall:.0f} k-mers/s; {n_blocks} blocks, "
        f"sorted_join launches {launches}")

    window_join_kernel.launches = 0
    t0 = time.perf_counter()
    v1 = io.StringIO()
    compl.run_completeness(rdb, adb, w["peak"], log=v1,
                           asm_table=v1_table(adb, "cuda" if on_card
                                              else "cpu"))
    if on_card:
        torch.cuda.synchronize()
    v1_launches = window_join_kernel.launches
    assert completeness_lines(v1.getvalue()) == lines, "v1 route != v4 route"
    if on_card:
        assert v1_launches == n_blocks, (v1_launches, n_blocks)
    say(f"  v1 (window join) table: same 67 lines, window_join launches "
        f"{v1_launches} ({time.perf_counter() - t0:.1f} s, table build "
        f"included)")
    return {sorted_join_kernel.name: launches,
            window_join_kernel.name: v1_launches}


def _run_dump_full(w: dict, cwd: str) -> int:
    """Phase 7: -dump through the CLI against the full world's DBs (the
    whole gather tables on the card; no union table is built) for one
    scaffold and the contigs: per-sequence missing and cumulative kasm
    against the independent count, the row count, and the union-join
    launches of that run (none)."""
    import torch

    from merfin_tpu_torch.ops.union_join import union_join_kernel

    on_card = _on_card()
    argv = mode_argv(w["argv"], "dump")
    argv[argv.index("-sequence") + 1] = w["dump_fasta"]
    marks = ("-- Loading kmers", "-- Dump per-base", "Processing sequence")
    log = StampedLog(marks)
    union_join_kernel.launches = 0
    with gather_timers() as spent, refused_union():
        rows, err, counters = run_port_inprocess(argv, cwd, log,
                                                 out="out.dump")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - log.t0
    launches = union_join_kernel.launches

    got = [ln.split("\t") for ln in err.splitlines() if ln.count("\t") == 3]
    assert len(got) == len(w["dump_seqs"]), (len(got), len(w["dump_seqs"]))
    cum_mis = cum_kasm = 0
    for (ident, mis, c_mis, c_kasm), (name, kasm, kmis) in zip(
            got, w["dump_seqs"]):
        cum_mis += kmis
        cum_kasm += kasm
        assert (ident, int(mis), int(c_mis), int(c_kasm)) == (
            name, kmis, cum_mis, cum_kasm), (ident, mis, c_mis, c_kasm)
    n_rows = rows.count(b"\n")
    # every valid assembly window has asmK >= 1, so each gives a row
    assert n_rows == cum_kasm, (n_rows, cum_kasm)
    w["dump_digest"] = hashlib.sha256(rows).hexdigest()   # phase 10
    w["dump_lines"] = [ln for ln in err.splitlines() if ln.count("\t") == 3]
    assert counters == {c: 0 for c in COUNTERS}, counters
    assert launches == 0, "the -dump run launched the union join"
    t = [log.stamps[m] for m in marks]
    say(f"  split: DB load + gather-table build {t[1] - t[0]:.1f} s (build "
        f"{spent['build']:.1f}), dump loop + rows {wall - t[1]:.1f} s "
        f"(first placement {spent['place']:.1f})")
    say(f"  -dump wall {wall:.1f} s for {w['dump_bases']} bases "
        f"({len(got)} sequences, {n_rows} rows, {len(rows)} bytes, "
        f"missing {cum_mis}): {w['dump_bases'] / wall:.0f} bases/s; "
        f"union_join launches {launches}")
    return launches


@contextlib.contextmanager
def timers(targets: dict):
    """Seconds the calling threads spend in each target, {key: (owner,
    name)}: a module's function or a class's method, patched for the
    block; a generator's time is that of its steps (calls nested in
    another target count in both)."""
    spent = dict.fromkeys(targets, 0.0)
    saved = {key: inspect.getattr_static(owner, name)
             for key, (owner, name) in targets.items()}

    def steps(key, gen):
        while True:
            t = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                spent[key] += time.perf_counter() - t
            yield item

    def timed(key, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
            return steps(key, out) if inspect.isgenerator(out) else out
        return run

    for key, (owner, name) in targets.items():
        fn = timed(key, getattr(owner, name))
        setattr(owner, name, staticmethod(fn)
                if isinstance(saved[key], staticmethod) else fn)
    try:
        yield spent
    finally:
        for key, (owner, name) in targets.items():
            setattr(owner, name, saved[key])


def variant_timers():
    """Main-thread seconds of the variant loop's steps: stream assembly,
    packing and launch (``dispatch_blocks``), the fetch (device wait and
    copy, ``fetch_blocks``) and selection (``_select_block_task``); the
    rest of the loop waits for enumeration (build thread, pool)."""
    import merfin_tpu_torch.modes.variants as mv

    return timers({"dispatch": (mv, "dispatch_blocks"),
                   "fetch": (mv, "fetch_blocks"),
                   "select": (mv, "_select_block_task")})


def _run_variants_full(w: dict, plan: dict, cwd: str,
                       threads: int | None = None) -> int:
    """Phase 8: the variant modes through the CLI on the full world's
    DBs (the whole union table on the device).

    * -polish (fused scorer): exactly the planned true corrections, as
      1/1 records with int-cast QUAL, and nothing from a spurious site or
      a heavy cluster (their REF paths miss no k-mer);
    * -filter: the same corrections as their original records (QUAL
      %.1f); a spurious site's REF path misses nothing, so it is dropped;
    * -better: the same records as -polish (each correction's ALT path
      misses fewer k-mers than REF; no spurious path does);
    * -polish on light.vcf (no heavy clusters), once with the fused
      scorer (the default) and once with the host scorer (-nodevscore,
      on the gather tables: no union table, no union_join launch): each
      byte-identical to the fused -polish output on calls.vcf, and the
      two variant-loop times side by side.

    Reports records, clusters/s, the wall and its split; returns the
    union_join launches of these runs."""
    import torch

    from merfin_tpu_torch.ops.union_join import union_join_kernel

    on_card = _on_card()
    argv = mode_argv(w["argv"], "polish")
    extra = ["-threads", str(threads)] if threads else []
    marks = ("-- Loading kmers", "-- Opening vcf", "-- Generate variant",
             "Processing sequence", "Bye!")
    launches = 0
    outs, loops = {}, {}
    for tag, mode, vcf, flags in (
            ("polish", "polish", plan["vcf"], []),
            ("filter", "filter", plan["vcf"], []),
            ("better", "better", plan["vcf"], []),
            ("polish_light", "polish", plan["light_vcf"], []),
            ("polish_host", "polish", plan["light_vcf"], ["-nodevscore"])):
        run = mode_argv(argv, mode) + ["-vcf", vcf] + flags + extra
        log = StampedLog(marks)
        union_join_kernel.launches = 0
        host = "-nodevscore" in flags
        with variant_timers() as spent, gather_timers() as tables, \
                refused_union() if host else contextlib.nullcontext():
            outs[tag], err, _ = run_port_inprocess(
                run, os.path.join(cwd, tag), log, out="out",
                output=variant_vcf(run))
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - log.t0
        launches += union_join_kernel.launches
        clusters = sum(int(ln.split(" down to ")[1].split()[0])
                       for ln in err.splitlines() if " down to " in ln)
        n_rec = vcf_records(outs[tag])
        if host:
            assert union_join_kernel.launches == 0, tag
        elif on_card:       # the fused scorer's union route places no
            assert union_join_kernel.launches > 0, tag   # gather table
            assert tables["place"] == 0.0, tag
        t = {m: log.stamps[m] for m in marks}
        loop = loops[tag] = t["Bye!"] - t["Processing sequence"]
        rest = loop - sum(spent.values())
        say(f"  {tag}: {n_rec} records, {clusters} clusters in {wall:.1f} s "
            f"({clusters / wall:.1f} clusters/s; {clusters / loop:.1f} in "
            f"the variant loop); union_join launches "
            f"{union_join_kernel.launches}")
        say(f"    split: DB load {t['-- Opening vcf'] - t['-- Loading kmers']:.1f}"
            f" s (gather-table build {tables['build']:.1f}), VCF + clusters "
            f"{t['-- Generate variant'] - t['-- Opening vcf']:.1f} s, "
            f"{'gather tables' if host else 'union table build+upload'} "
            f"(and scorer) "
            f"{t['Processing sequence'] - t['-- Generate variant']:.1f} s, "
            f"variant loop {loop:.1f} s (first gather-table placement "
            f"{tables['place']:.1f}; main thread: dispatch "
            f"{spent['dispatch']:.1f}, fetch/device wait "
            f"{spent['fetch']:.1f}, selection {spent['select']:.1f}, "
            f"enumeration wait + host scoring {rest:.1f})")
    assert outs["polish"] == plan["polish"], outs["polish"][-500:]
    assert outs["filter"] == plan["filter"], outs["filter"][-500:]
    assert outs["better"] == plan["polish"], outs["better"][-500:]
    assert outs["polish_light"] == outs["polish_host"] == outs["polish"]
    plan["light_out"] = outs["polish_light"]    # phase 10
    say(f"  light.vcf variant loop: fused scorer {loops['polish_light']:.3f}"
        f" s, host scorer {loops['polish_host']:.3f} s")
    say(f"  -polish/-better: exactly the {plan['n_fixes']} true corrections; "
        f"-filter: their original records; fused and host scorers on "
        f"light.vcf: byte-identical to that -polish; {plan['n_variants']} "
        f"variants ({plan['n_snp']} spurious SNPs, {plan['n_multi']} 1/2 "
        f"sites, {len(plan['heavy'])} heavy clusters of "
        f"{plan['heavy_paths']} paths)")
    return launches


# ------------------------------------------------------------- counting

MKDB_FILES = ("keys.npy", "vals.npy", "mkdb.json")


def count_timers():
    """Seconds in the counter's steps during a count: the whole of
    count_files, on the parse thread reading and parsing the input
    (SeqFile._stream) and packing its records into blocks
    (iter_packed, parse included), on the main thread chunking the
    blocks (_packed_chunks, waits on the parse thread included), the
    device accumulator's add_codes (wire pack, upload, chunk program,
    collapses) and drain, the wire pack, run fetches, host merges and
    the DB write."""
    import merfin_tpu_torch.count.counter as counter
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.mkdb import KmerDB

    acc = counter._DeviceCountAcc
    return timers({"count": (counter, "count_files"),
                   "parse": (SeqFile, "_stream"),
                   "blocks": (SeqFile, "iter_packed"),
                   "chunks": (counter, "_packed_chunks"),
                   "add": (acc, "add_codes"), "drain": (acc, "drain"),
                   "pack": (counter, "pack_transfer_np"),
                   "fetch": (acc, "_fetch_run"),
                   "merge": (counter, "_merge_sorted"),
                   "write": (KmerDB, "create")})


def count_split(spent: dict) -> str:
    """count_timers' seconds as the split of count_files' wall: parse and
    pack (waiting on the parse thread, chunking, the wire pack), device
    (upload, chunk programs, collapses and their syncs), fetch and host
    merge, DB write; then the parts of parse and pack."""
    fetch_merge = spent["fetch"] + spent["merge"]
    device = spent["add"] + spent["drain"] - spent["pack"] - fetch_merge
    parse_pack = spent["count"] - spent["write"] - device - fetch_merge
    return (f"parse and pack {parse_pack:.2f} s, device {device:.2f} s, "
            f"fetch and host merge {fetch_merge:.2f} s, DB write "
            f"{spent['write']:.2f} s (main thread: chunking and waits on "
            f"the parse thread {spent['chunks']:.2f} s, wire pack "
            f"{spent['pack']:.2f} s; parse thread: read and parse "
            f"{spent['parse']:.2f} s, block packing "
            f"{spent['blocks'] - spent['parse']:.2f} s)")


def run_db_tool(argv: list[str], cwd: str) -> tuple[str, str]:
    """The port's CLI entry point for a database tool, in this process
    -> (stdout, stderr)."""
    from merfin_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    prev, _STDERR.f = _STDERR.f, err
    try:
        with contextlib.chdir(cwd), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(_STDERR):
            rc = main(argv)
    finally:
        _STDERR.f = prev
    if rc != 0:
        raise RuntimeError(f"{argv[0]} failed:\n{err.getvalue()}")
    return out.getvalue(), err.getvalue()


def read_set(w: dict, d: str, seed: int, coverage: int = 20,
             length: int = 150, sub_rate: float = 0.005):
    """Phase 9's reads: ``coverage``x of the true genome's scaffold 0 in
    ``length`` bp reads at uniform positions, half of them reverse
    complemented, with ``sub_rate`` substitutions, written to
    ``d``/reads.fq as fixed-width FASTQ records -> (path, codes u8
    [reads, length])."""
    rng = np.random.default_rng(seed + 9)
    src = w["true"][w["starts"][0]: w["starts"][1]]
    n = int(coverage * src.size // length)
    pos = rng.integers(0, src.size - length + 1, size=n)
    reads = src[pos[:, None] + np.arange(length)]
    rev = rng.random(n) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    sub = rng.random(reads.shape) < sub_rate
    reads[sub] = (reads[sub] + rng.integers(1, 4, size=int(sub.sum()),
                                            dtype=np.uint8)) % 4
    digits = 9
    rec = np.empty((n, 2 + digits + 1 + 2 * (length + 1) + 2), np.uint8)
    rec[:, :2] = np.frombuffer(b"@r", np.uint8)
    ids = np.arange(n)
    for j in range(digits):
        rec[:, 2 + j] = ord("0") + ids // 10 ** (digits - 1 - j) % 10
    at = 2 + digits
    rec[:, at] = ord("\n")
    rec[:, at + 1: at + 1 + length] = _ACGT[reads]
    at += 1 + length
    rec[:, at: at + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, at + 3: at + 3 + length] = ord("I")
    rec[:, -1] = ord("\n")
    path = os.path.join(_mkdir(d), "reads.fq")
    rec.tofile(path)
    return path, reads


def numpy_read_counts(reads: np.ndarray, k: int):
    """Independent count of the reads' canonical k-mers: the native
    window extractor over the read rows, each ended by an invalid code so
    that no window crosses a row, and np.unique -> (sorted keys u64,
    counts u32)."""
    from merfin_tpu_torch.kcore.pack import kmers_from_codes_np

    rows = np.full((reads.shape[0], reads.shape[1] + 1), 4, np.uint8)
    rows[:, :-1] = reads
    fmer, rmer, valid = kmers_from_codes_np(rows.reshape(-1), k)
    del rows
    canon = np.minimum(fmer, rmer)[valid]
    del fmer, rmer, valid
    keys, counts = np.unique(canon, return_counts=True)
    return keys, counts.astype(np.uint32)


def db_digest(keys, vals) -> str:
    """A hash of a DB's keys (u64) and values (u32)."""
    h = hashlib.sha256(np.ascontiguousarray(keys, np.uint64).tobytes())
    h.update(np.ascontiguousarray(vals, np.uint32).tobytes())
    return h.hexdigest()


def _same_mkdb(a: str, b: str) -> None:
    for name in MKDB_FILES:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), (a, b, name)


def _run_count_full(w: dict, cwd: str, seed: int,
                    memory_gb: float = 0.25) -> int:
    """Phase 9: the counter through the CLI on the card.

    (a) -completeness without -seqmers counts asm.fasta into
        asm.fasta.meryl, equal to the world's asm.mkdb (torch.unique, an
        independent path) file for file, and then gives phase 6's lines;
    (b) `count k=21` of a read set (read_set) in RAM against the
        independent numpy count, `count k=21 memory=<memory_gb>` (the
        budgeted path: device step, spills, the 64-slice merge)
        byte-identical to it, `statistics` and `histogram` against numpy.

    Prints walls, rates, distinct k-mers and the splits; returns the
    sorted_join launches of (a)."""
    import torch

    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.ops.sorted_join import sorted_join_kernel

    on_card = _on_card()
    where = smi_line() if on_card else "CPU run"
    k = w["k"]

    argv = ["-completeness"] + w["argv"][1:5] + w["argv"][7:9]
    a_dir = _mkdir(os.path.join(cwd, "asm"))
    log = StampedLog()
    sorted_join_kernel.launches = 0
    with count_timers() as spent:
        _, err, _ = run_port_inprocess(argv, a_dir, log, out="unused")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - log.t0
    launches = sorted_join_kernel.launches
    assert ("-- No -seqmer given. Build sequence db as 'asm.fasta.meryl'."
            in err.splitlines()), err[:2000]
    built = os.path.join(a_dir, "asm.fasta.meryl")
    _same_mkdb(built, w["argv"][6])
    assert completeness_lines(err) == w["completeness_lines"]
    n_blocks = -(-KmerDB(w["argv"][4]).distinct // (1 << 22))
    if on_card:
        assert launches == n_blocks, (launches, n_blocks)
    distinct = KmerDB(built).distinct
    say(f"  asm count: {w['bases']} bases, {distinct} distinct k-mers, "
        f"equal to asm.mkdb file for file; count wall "
        f"{spent['count']:.2f} s ({w['bases'] / spent['count']:.0f} "
        f"bases/s): {count_split(spent)}; -completeness wall {wall:.1f} s, "
        f"phase 6's 67 lines, sorted_join launches {launches} ({where})")

    r_dir = os.path.join(cwd, "reads")
    t0 = time.perf_counter()
    fq, reads = read_set(w, r_dir, seed)
    (n_reads, length), n_bases = reads.shape, reads.size
    t1 = time.perf_counter()
    keys, counts = numpy_read_counts(reads, k)
    del reads
    say(f"  reads: {n_reads} x {length} bp ({n_bases} bases, "
        f"{os.path.getsize(fq)} bytes of FASTQ; {t1 - t0:.1f} s), numpy "
        f"count {keys.size} distinct ({time.perf_counter() - t1:.1f} s)")
    with count_timers() as spent:
        run_db_tool(["count", f"k={k}", fq, "output=reads.mkdb"], r_dir)
    if on_card:
        torch.cuda.synchronize()
    db = KmerDB(os.path.join(r_dir, "reads.mkdb"))
    assert db.distinct == keys.size, (db.distinct, keys.size)
    assert db.total == int(counts.sum(dtype=np.int64)), db.total
    assert db_digest(db.keys, db.vals) == db_digest(keys, counts)
    say(f"  read count in RAM: {db.distinct} distinct k-mers, total "
        f"{db.total}, equal to the numpy count; wall {spent['count']:.2f} s "
        f"({n_bases / spent['count']:.0f} bases/s): {count_split(spent)} "
        f"({where})")

    t0 = time.perf_counter()
    _, err = run_db_tool(["count", f"k={k}", f"memory={memory_gb}", fq,
                          "output=spill.mkdb"], r_dir)
    spill_wall = time.perf_counter() - t0
    merged = [ln for ln in err.splitlines() if ln.startswith("count: merging")]
    assert merged, err[:2000]
    _same_mkdb(os.path.join(r_dir, "spill.mkdb"), db.path)
    say(f"  read count with memory={memory_gb}: {merged[0][7:]}, "
        f"byte-identical to the in-RAM DB; wall {spill_wall:.2f} s ({where})")

    out, _ = run_db_tool(["statistics", db.path], r_dir)
    assert out == (f"Number of {k}-mers that are:\n"
                   f"    unique   {int(np.count_nonzero(counts == 1)):>12}\n"
                   f"    distinct {keys.size:>12}\n"
                   f"    present  {int(counts.sum(dtype=np.int64)):>12}\n"), out
    out, _ = run_db_tool(["histogram", db.path], r_dir)
    v, c = np.unique(counts, return_counts=True)
    assert out == "".join(f"{a}\t{b}\n" for a, b in zip(v, c)), out[:500]
    say(f"  statistics and histogram ({v.size} values) equal numpy's")
    return launches



# ------------------------------------------------------ multi-device

def _mesh_blocks(read_db, data: int, block: int = 1 << 22) -> int:
    """The -completeness mesh steps over ``read_db``: per slice,
    ceil(rows / (D * block)) at the mesh path's block size (the largest
    slice's rows a d-row, rounded up to a power of two, at least 4096)."""
    sizes = np.diff(np.asarray(read_db.slice_offsets))
    per_dev = -(-int(sizes.max()) // data) if sizes.size else 0
    if per_dev:
        block = min(block, max(4096, 1 << (per_dev - 1).bit_length()))
    return sum(-(-int(n) // (data * block)) for n in sizes)


def _run_cli_rc(argv, cwd: str) -> tuple[int, str]:
    """The port's CLI in this process -> (exit code, stderr)."""
    from merfin_tpu_torch.cli import main

    os.makedirs(cwd, exist_ok=True)
    err = io.StringIO()
    prev, _STDERR.f = _STDERR.f, err
    try:
        with contextlib.chdir(cwd), contextlib.redirect_stderr(_STDERR):
            rc = main(argv)
    finally:
        _STDERR.f = prev
    return rc, err.getvalue()


def _run_mesh_full(w: dict, plan: dict, cwd: str) -> dict:
    """Phase 10: the mesh paths on the full world.

    Through the CLI on a 1x1 mesh (one sorted-join table a DB, no union
    merge): -hist, -completeness, -dump (phase 7's cut) and -polish on
    light.vcf, each byte-identical to its single-device phase (stderr
    lines too, where the single-device run prints them).  Through the API
    a 2x4 mesh over one card repeated (``make_mesh(devices=[cuda:0] * 8,
    data=2)``) runs -hist, equal to phase 5's histogram.  ``-mesh 2x4``
    on the CLI exits 1 (one card).  Prints walls and splits; returns
    each path's sorted_join launches."""
    import torch

    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.modes.hist import run_hist
    from merfin_tpu_torch.ops.sorted_join import sorted_join_kernel
    from merfin_tpu_torch.parallel.engine import ShardedKstarEngine
    from merfin_tpu_torch.parallel.sharded import ShardedLookup, make_mesh

    on_card = _on_card()
    where = smi_line() if on_card else "CPU run"
    mesh = ["-mesh", "1x1"]
    launches = {}

    def timed_run(tag, argv, marks, out, output=None):
        log = StampedLog(marks)
        sorted_join_kernel.launches = 0
        got, err, counters = run_port_inprocess(
            argv + mesh, os.path.join(cwd, tag), log, out=out, output=output)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - log.t0
        launches[tag] = n = sorted_join_kernel.launches
        if on_card:
            assert n > 0, f"{tag} never launched sorted_join"
        assert "-- Sharding tables over a 1x1 device mesh." in err
        return got, err, counters, wall, [log.stamps[m] for m in marks], n

    marks = ("-- Loading kmers", "-- Generate histogram", "K-mers not found")
    hist, err, counters, wall, t, n = timed_run(
        "-hist -mesh 1x1", w["argv"], marks, "out.hist")
    assert hist == w["hist_out"], "mesh -hist != phase 5's histogram"
    assert summary_of(err) == summary_of(w["hist_err"])
    assert seq_lines_of(err) == seq_lines_of(w["hist_err"])
    assert counters == {c: 0 for c in COUNTERS}, counters
    say(f"  -hist -mesh 1x1: phase 5's histogram and lines; wall {wall:.1f} s "
        f"({w['bases'] / wall:.0f} bases/s): DB load + two sorted-join "
        f"tables (no union merge) {t[1] - t[0]:.1f} s, hist loop "
        f"{t[2] - t[1]:.1f} s; sorted_join launches {n} ({where})")

    argv = mode_argv(w["argv"], "completeness")
    marks = ("-- Sharding tables", "thread  0")
    _, err, _, wall, t, n = timed_run("-completeness -mesh 1x1", argv, marks,
                                      "unused")
    assert completeness_lines(err) == w["completeness_lines"]
    blocks = _mesh_blocks(KmerDB(argv[2]), 1)
    if on_card:
        assert n == blocks, (n, blocks)
    say(f"  -completeness -mesh 1x1: phase 6's 67 lines; wall {wall:.1f} s: "
        f"asm shard + stream loop {t[1] - t[0]:.1f} s; {blocks} slice "
        f"blocks, sorted_join launches {n} ({where})")

    argv = mode_argv(w["argv"], "dump")
    argv[argv.index("-sequence") + 1] = w["dump_fasta"]
    marks = ("-- Loading kmers", "-- Dump per-base", "Processing sequence")
    rows, err, counters, wall, t, n = timed_run("-dump -mesh 1x1", argv,
                                                marks, "out.dump")
    assert hashlib.sha256(rows).hexdigest() == w["dump_digest"]
    assert [ln for ln in err.splitlines() if ln.count("\t") == 3] == \
        w["dump_lines"]
    assert counters == {c: 0 for c in COUNTERS}, counters
    say(f"  -dump -mesh 1x1: phase 7's {rows.count(b'\n')} rows byte for "
        f"byte; wall {wall:.1f} s ({w['dump_bases'] / wall:.0f} bases/s): "
        f"tables {t[2] - t[0]:.1f} s, dump loop + rows {wall - t[2]:.1f} s; "
        f"sorted_join launches {n} ({where})")

    argv = mode_argv(w["argv"], "polish") + ["-vcf", plan["light_vcf"]]
    marks = ("-- Loading kmers", "Processing sequence", "Bye!")
    out, err, _, wall, t, n = timed_run("-polish -mesh 1x1", argv, marks,
                                        "out", variant_vcf(argv))
    assert out == plan["light_out"], "mesh -polish != phase 8's"
    assert "-- Using fused device scoring (-devscore)." in err
    say(f"  -polish -mesh 1x1 (light.vcf, fused ShardedScorer): phase 8's "
        f"{vcf_records(out)} records byte for byte; wall {wall:.1f} s: tables "
        f"{t[1] - t[0]:.1f} s, variant loop {t[2] - t[1]:.1f} s; "
        f"sorted_join launches {n} ({where})")

    # the API on a 2x4 mesh of one card repeated
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    read_db, asm_db = KmerDB(w["argv"][4]), KmerDB(w["argv"][6])
    t0 = time.perf_counter()
    m = make_mesh(devices=[dev] * 8, data=2)
    rl = ShardedLookup.build(read_db, m)
    al = ShardedLookup.build(asm_db, m)
    engine = ShardedKstarEngine(m, rl, al, w["k"], w["peak"],
                                max_value=w["read_max"], exact_max=True,
                                asm_max_value=int(np.asarray(asm_db.vals).max()))
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    sorted_join_kernel.launches = 0
    out = os.path.join(_mkdir(os.path.join(cwd, "api")), "out.hist")
    log = io.StringIO()
    run_hist(engine, SeqFile(w["argv"][2]), out, log=log)
    if on_card:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches["-hist, API 2x4 mesh on one card"] = n = \
        sorted_join_kernel.launches
    with open(out, "rb") as f:
        assert f.read() == w["hist_out"], "2x4 mesh -hist != phase 5's"
    assert seq_lines_of(log.getvalue()) == seq_lines_of(w["hist_err"])
    assert {c: getattr(engine, c) for c in COUNTERS} == \
        {c: 0 for c in COUNTERS}
    if on_card:
        assert n > 0
    say(f"  -hist on make_mesh(devices=[{dev}] * 8, data=2) "
        f"({m.shape}; one table per shard column): phase 5's histogram; "
        f"tables {t1 - t0:.1f} s, run_hist {t2 - t1:.1f} s; sorted_join "
        f"launches {n} ({where})")
    del engine, rl, al

    rc, err = _run_cli_rc(w["argv"] + ["-mesh", "2x4", "-output", "x.hist"],
                          os.path.join(cwd, "too_big"))
    n_dev = torch.cuda.device_count() if on_card else 1
    assert rc == 1 and err.splitlines()[-1] == (
        f"ERROR: -mesh 2x4 needs 8 devices; {n_dev} available."), err[-500:]
    say(f"  -mesh 2x4 on the CLI: exit 1, '{err.splitlines()[-1]}'")
    return launches


# One rank of phase 11: runs each (cwd, argv) job through the port's CLI.
# A rank that fails exits at once, so its peer fails at its next
# collective instead of waiting out the timeout.
_RANK_SCRIPT = """
import contextlib, json, os, sys, time, traceback
sys.path.insert(0, {repo!r})
from merfin_tpu_torch.cli import main
try:
    for cwd, argv in json.loads(sys.argv[1]):
        t = time.perf_counter()
        os.makedirs(cwd, exist_ok=True)
        with contextlib.chdir(cwd):
            assert main(argv) == 0, argv
        print("JOB", argv[0], round(time.perf_counter() - t, 2), flush=True)
except BaseException:
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)
print("ALLDONE")
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(w: dict, cwd: str, seed: int, bases: int,
                     timeout: int = 420) -> None:
    """Phase 11: striped two-process launches (MERFIN_NUM_PROCESSES=2,
    gloo merges; on a card both ranks on cuda:0): -hist of the full world,
    and -polish, -dump and `count` of a ``bases`` parity world, each
    byte-identical to its one-process output, with no part, checkpoint
    or spill file left behind."""
    import glob

    on_card = _on_card()
    small = materialize(parity_world(seed + 11, bases, k=21),
                        _mkdir(os.path.join(cwd, "world")))
    fasta = small[2]
    polish = vcf_argv(small, "polish") + ["-threads", "2"]
    dump = mode_argv(small, "dump")
    t0 = time.perf_counter()
    ref = {"polish": run_port_inprocess(polish, os.path.join(cwd, "one"),
                                        out="out",
                                        output="out.polish.vcf")[0],
           "dump": run_port_inprocess(dump, os.path.join(cwd, "one"),
                                      out="out.dump")[0]}
    run_db_tool(["count", "k=21", fasta, "output=one.mkdb"], cwd)
    t1 = time.perf_counter()
    two = os.path.join(cwd, "two")
    jobs = [(os.path.join(two, "hist"), w["argv"] + ["-output", "out.hist"]),
            (two, polish + ["-output", "out"]),
            (two, dump + ["-output", "out.dump"]),
            (two, ["count", "k=21", fasta, "output=two.mkdb"])]
    if on_card:
        import torch

        torch.cuda.empty_cache()    # the card's memory for both ranks
        free, total = torch.cuda.mem_get_info()
        say(f"  card memory before the ranks start: {free / 2**30:.1f} of "
            f"{total / 2**30:.1f} GiB free")
    port = _free_port()
    env = dict(os.environ, MERFIN_PLATFORM="cuda" if on_card else "cpu",
               MERFIN_NUM_PROCESSES="2", MERFIN_DIST_TIMEOUT="120",
               MERFIN_COORDINATOR=f"127.0.0.1:{port}")
    src = _RANK_SCRIPT.format(repo=REPO)
    # each rank's output goes to files: a rank blocked on a full pipe
    # that nobody reads would stall the other at its next collective
    logs = [[open(os.path.join(cwd, f"rank{i}.{x}"), "w+")
             for x in ("out", "err")] for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, json.dumps(jobs)],
        env=dict(env, MERFIN_PROCESS_ID=str(i)), stdout=logs[i][0],
        stderr=logs[i][1], text=True) for i in range(2)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for files in logs:
        for f in files:
            f.seek(0)
        outs.append(tuple(f.read() for f in files))
        for f in files:
            f.close()
    wall = time.perf_counter() - t1
    bad = [(i, p.returncode, err[-2500:])
           for i, (p, (out, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0 or "ALLDONE" not in out]
    assert not bad, bad
    for i, (_, err) in enumerate(outs):
        assert f"-- Joined distributed job: process {i} of 2." in err
    with open(os.path.join(two, "hist", "out.hist"), "rb") as f:
        assert f.read() == w["hist_out"], "2-process -hist != phase 5's"
    with open(os.path.join(two, "out.polish.vcf"), "rb") as f:
        assert f.read() == ref["polish"], "2-process -polish != 1-process"
    with open(os.path.join(two, "out.dump"), "rb") as f:
        assert f.read() == ref["dump"], "2-process -dump != 1-process"
    _same_mkdb(os.path.join(cwd, "one.mkdb"), os.path.join(two, "two.mkdb"))
    left = [g for pat in ("*.part*", "*.ckpt.json*", "*.spill*")
            for g in glob.glob(os.path.join(two, "**", pat), recursive=True)]
    assert not left, left
    jobs0 = [ln.split()[1:] for ln in outs[0][0].splitlines()
             if ln.startswith("JOB")]
    say(f"  two processes ({'both on cuda:0' if on_card else 'CPU'}, gloo "
        f"merges): -hist of the full world = phase 5's histogram; -polish "
        f"({vcf_records(ref['polish'])} records), -dump "
        f"({ref['dump'].count(b'\n')} rows) and count of a {bases} bp world "
        f"= one process; no part/spill files left; wall {wall:.1f} s "
        f"(rank 0's jobs: {jobs0}; one-process references "
        f"{t1 - t0:.1f} s)")

if __name__ == "__main__":
    raise SystemExit(main())
