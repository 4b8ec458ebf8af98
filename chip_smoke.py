#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: python3 chip_smoke.py

Drives merfin_tpu_torch's main paths (-hist, -completeness, -dump) end
to end on the GPU and checks them, phase by phase (any failure exits
non-zero with its traceback):

  1. device   nvidia-smi name/power limit, torch/CUDA versions; requires
              compute capability (9, 0);
  2. build    every kernel library from csrc/ with nvcc for sm_90a, one
              nvcc per source in parallel, with ptxas's register and
              spill lines;
  3. kernel   each kernel vs its plain PyTorch version, bit-exact, with
              median times of both taken in turns.  union_join: the full
              world's union table against one dispatch's sorted
              2^20-window query stream with hits, misses and sentinels, a
              ragged length, a k=20 table with palindromes.  sorted_join
              and window_join: the full world's asm table against one
              2^22 block of sorted read-DB keys (the completeness
              dispatch), a v1-ratio table of 2^21 keys against 2^20
              queries with 10% misses and 1% sentinels, a ragged length,
              a k=31 table with keys near 2^62, values near 2^32-1;
  4. oracle   small worlds through the CLI on CUDA: the verify recipe's
              world and a fragmented 200 kb world with a -prob table are
              held byte for byte to tests/refmodel.py:hist_mode; the same
              world with a high-copy repeat (f32 fallback bins, kover
              fallback, bin growth) is held to refmodel on kasm/missing
              and byte for byte to the port's own CPU run.  -completeness
              and -dump on the recipe and -prob worlds are held to
              refmodel's completeness_mode and dump_mode (rows byte for
              byte), and run_completeness on a v1 table gives the CLI's
              lines;
  5. full     a synthetic 64 Mbp assembly (4 large scaffolds, 2,000
              contigs of 1-20 kb, N gaps, 2,000 substitutions; k=21,
              peak 30) against a read DB of the true genome's k-mers at
              Poisson(30) counts plus 128M error k-mers, -hist through the
              CLI: kasm/kmissing against an independent numpy count, the
              kernel's launch count, zero exactness fallbacks, wall time
              and bases/s;
  6. completeness full   -completeness through the CLI on the full
              world's DBs: TOTAL readK/undrcpy against an independent
              numpy sum, the 64 slice lines against the totals,
              sorted_join launches equal to the block count; the same on
              a v1 table (window_join); wall, k-mers/s and the split;
  7. dump full   -dump through the CLI against the full world's DBs (the
              whole union table on the card) for one scaffold and the
              2,000 contigs: per-sequence missing/kasm against the
              independent count, the row count, union_join launches,
              wall and bases/s.

The world is made from --seed with numpy; databases are written with the
shared KmerDB.create.  The last three stdout lines are a JSON object of
the kernels (launches in their main paths, each run with the counts set
to 0 just before it; max |kernel - plain|; median ms of each at the
main path's shape), the card's `nvidia-smi --query-gpu=name,power.limit`
line, and {"ok": true, "device": {...}}.

Without CUDA the script fails (exit 1) and prints no result.  Phases 4
to 7 also run on the CPU at a tiny size in tests/test_torch_hist.py
(``MERFIN_PLATFORM=cpu``), which checks this harness without a card.
"""

from __future__ import annotations

import argparse
import contextlib
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


def recipe_world() -> dict:
    """The world of .claude/skills/verify/SKILL.md (k=15, peak 20)."""
    import random

    random.seed(5)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}
    g = "".join(random.choice("ACGT") for _ in range(2000))
    asm = list(g)
    for p in (300, 900, 1500):
        asm[p] = alt[asm[p]]
    return dict(k=15, peak=20.0, scaffolds=[("chr1", "".join(asm))],
                reads=[g] * 20, prob=None)


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
    for p in rng.choice(np.arange(100, long_len - 100), size=30, replace=False):
        if asm[p] in b"ACGT" and (not repeat or not at <= p < at + repeat + k):
            asm[p] = b"CGTA"[b"ACGT".index(asm[p])]
    scaffolds = [("chrL", asm.decode())] + [
        (f"scaf{i}", s) for i, s in enumerate(shorts)]
    reads = [true_long] + shorts
    for cov, frac in ((1, 1.0), (2, 0.8), (4, 0.6), (6, 0.4), (11, 0.2)):
        reads += [true_long[: int(len(true_long) * frac)]] * cov
    reads.append(_dna(rng, 5_000))
    prob = "1,0.931\n1,0.871\n2,0.773\n2,0.597\n3,0.401\n"
    return dict(k=k, peak=2.0, scaffolds=scaffolds, reads=reads, prob=prob)


def canonical_counts(code_arrays, k: int):
    """Sorted canonical keys (u64) and their counts over code arrays."""
    from merfin_tpu.kcore.pack import kmers_from_codes_np

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
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.kcore.pack import encode_bases

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
    return argv


# ------------------------------------------------------------ CLI drivers

# Runs a package's CLI in a fresh process and prints the engine's
# exactness counters as JSON on stdout (the CLI itself writes only to
# stderr).
_COUNTED_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import {pkg}.modes.engine as eng
made = []
class Recording(eng.KstarEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        made.append(self)
eng.KstarEngine = Recording
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
    """Record every port KstarEngine the CLI creates (for its counters)."""
    import merfin_tpu_torch.modes.engine as eng

    made = []
    base = eng.KstarEngine

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    eng.KstarEngine = Recording
    try:
        yield made
    finally:
        eng.KstarEngine = base


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


def run_port_inprocess(argv, cwd: str, err: io.StringIO | None = None,
                       out: str = "out.hist"):
    """The port's CLI entry point in this process (the device comes from
    MERFIN_PLATFORM) -> (output bytes, stderr text, counters; {} when the
    mode makes no engine)."""
    from merfin_tpu_torch.cli import main

    os.makedirs(cwd, exist_ok=True)
    err = io.StringIO() if err is None else err
    with contextlib.chdir(cwd), recording_engines() as made, \
            contextlib.redirect_stderr(err):
        rc = main(argv + ["-output", out])
    if rc != 0:
        raise RuntimeError(f"port CLI failed:\n{err.getvalue()}")
    counters = {c: getattr(made[-1], c) for c in COUNTERS} if made else {}
    return _read_output(cwd, out), err.getvalue(), counters


# ---------------------------------------------------------------- oracle

def _refmodel():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "refmodel", os.path.join(REPO, "tests", "refmodel.py"))
    refmodel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refmodel)
    return refmodel


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
        seqs, refmodel.count_canonical(world["reads"], k),
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
        refmodel.count_canonical(world["reads"], world["k"]),
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
        world["scaffolds"], refmodel.count_canonical(world["reads"], k),
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
            if platform == "cuda":
                c_hist, c_err, c_counters = run_port_subprocess(
                    argv, _mkdir(os.path.join(d, "cpu")), "cpu")
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
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.io.prob import load_prob_table
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
    The k-mers come from the shared numpy/native extractor; their sorts
    run on ``device``."""
    import torch

    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.kcore.pack import kmers_from_codes_np

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
                           for i in dump_ids])


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
    from merfin_tpu.kcore.pack import kmers_from_codes_np

    fmer, rmer, valid = kmers_from_codes_np(asm_first[: windows + k - 1], k)
    q = np.where(valid, np.minimum(fmer, rmer), np.uint64(2**64 - 1))
    n_miss, n_sent = windows // 10, windows // 100
    at = rng.choice(windows, size=n_miss + n_sent, replace=False)
    q[at[:n_miss]] = rng.integers(0, 1 << (2 * k), size=n_miss,
                                  dtype=np.uint64)
    q[at[n_miss:]] = np.uint64(2**64 - 1)
    return np.sort(q)


def time_pair(kernel_fn, plain_fn, reps: int):
    """Median ms of a kernel and of its plain version, taken in turns
    (plain, kernel, kernel, plain); the lower median of each."""
    p1 = _median_ms(plain_fn, reps)
    k1 = _median_ms(kernel_fn, reps)
    k2 = _median_ms(kernel_fn, reps)
    p2 = _median_ms(plain_fn, reps)
    return min(k1, k2), min(p1, p2)


def _u32_err(a, b) -> int:
    """max |a - b| of two tensors of u32 bit patterns (int32)."""
    import torch

    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def check_kernel(table, q_np: np.ndarray, reps: int):
    """Kernel vs plain on ``table`` for sorted queries: bit-exact check,
    max |diff|, median ms of each (plain, kernel, kernel, plain)."""
    import torch

    q = torch.from_numpy(q_np.view(np.int64)).to(table.device)
    kr, ka = table.lookup2_sorted(q)
    pr, pa = table.lookup2_plain(q)
    torch.cuda.synchronize()
    err = max(_u32_err(kr, pr), _u32_err(ka, pa))
    assert torch.equal(kr, pr) and torch.equal(ka, pa), "kernel != plain"
    hits = int(((pr != 0) | (pa != 0)).sum())
    if reps == 0:
        return err, None, None, hits
    k_ms, p_ms = time_pair(lambda: table.lookup2_sorted(q),
                           lambda: table.lookup2_plain(q), reps)
    return err, k_ms, p_ms, hits


def check_single(table, q_np: np.ndarray, reps: int):
    """check_kernel for a single-value table (SortedJoinTable or the
    window join's SortJoinTable)."""
    import torch

    q = torch.from_numpy(q_np.view(np.int64)).to(table.device)
    got = table.lookup_sorted(q)
    want = table.lookup_plain(q)
    torch.cuda.synchronize()
    err = _u32_err(got, want)
    assert torch.equal(got, want), f"{table.kernel.name} kernel != plain"
    hits = int((want != 0).sum())
    if reps == 0:
        return err, None, None, hits
    k_ms, p_ms = time_pair(lambda: table.lookup_sorted(q),
                           lambda: table.lookup_plain(q), reps)
    return err, k_ms, p_ms, hits


def ratio_queries(rng, keys: np.ndarray, m: int, lo: int, hi: int):
    """``m`` sorted queries: table keys, 10% random mers in [lo, hi)
    (misses, bar chance hits) and 1% sentinels."""
    n_miss, n_sent = m // 10, m // 100
    q = np.concatenate([
        keys[rng.integers(0, keys.size, size=m - n_miss - n_sent)],
        rng.integers(lo, hi, size=n_miss, dtype=np.uint64),
        np.full(n_sent, np.uint64(2**64 - 1))])
    return np.sort(q)


def check_single_kernels(adb, rdb, rng, reps: int) -> dict:
    """Phase 3, the single-value kernels (sorted_join, window_join) vs
    their plain versions, bit-exact: the full world's asm table against
    one 2^22 block of sorted read-DB keys (the completeness dispatch,
    timed), a v1-ratio table of 2^21 keys against 2^20 sorted queries
    (timed) and at a ragged length, a k=31 table with keys near 2^62,
    and values near 2^32-1.  -> {kernel name: report}."""
    import torch

    from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
    from merfin_tpu_torch.ops.window_join import SortJoinTable

    smi = smi_line()
    mid = max(0, rdb.distinct // 2 - (1 << 21))
    cases = [("asm table x 2^22 read-DB keys", adb.keys, adb.vals,
              np.array(rdb.keys[mid: mid + (1 << 22)]), True)]
    k21 = 1 << 42
    rk = np.unique(rng.integers(0, k21, size=(1 << 21) + 4096,
                                dtype=np.uint64))[: 1 << 21]
    rv = rng.integers(1, 1 << 16, size=rk.size).astype(np.uint32)
    rq = ratio_queries(rng, rk, 1 << 20, 0, k21)
    cases += [("v1 ratio: 2^21 keys x 2^20 queries", rk, rv, rq, True),
              ("ragged 2^20-77", rk, rv, rq[: (1 << 20) - 77], False)]
    top = (1 << 62) - 1
    k31 = np.unique(np.uint64(top) - rng.integers(0, 1 << 40, size=1 << 20,
                                                  dtype=np.uint64))
    cases.append(("k=31 keys near 2^62", k31,
                  rng.integers(1, 1000, size=k31.size).astype(np.uint32),
                  ratio_queries(rng, k31, 1 << 19, top - (1 << 40), top),
                  False))
    big = (np.uint32(0xFFFFFFFF)
           - rng.integers(0, 1000, size=rk.size).astype(np.uint32))
    cases.append(("values near 2^32-1", rk, big, rq, False))

    report = {}
    for cls in (SortedJoinTable, SortJoinTable):
        name = cls.kernel.name
        errs, timed = [], None
        for label, keys, vals, q, timing in cases:
            table = cls(keys, vals, "cuda")
            err, k_ms, p_ms, hits = check_single(table, q,
                                                 reps if timing else 0)
            errs.append(err)
            msg = (f"  {name}, {label} ({table.n} keys, {q.size} queries, "
                   f"{hits} hits): bit-exact")
            if timing:
                msg += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                        f"(median of {reps}; {smi})")
                if timed is None:       # the completeness dispatch
                    timed = (k_ms, p_ms)
            say(msg)
            del table
            torch.cuda.empty_cache()
        report[name] = dict(max_abs_err=max(errs), ms=timed[0],
                            plain_ms=timed[1])
    return report


def palindrome_table(rng, k: int = 20, n: int = 1 << 20):
    """A k=20 union table holding palindromic keys, and sorted queries
    that hit them."""
    from merfin_tpu.kcore.pack import revcomp_np

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

    kernels = (union_join_kernel, sorted_join_kernel, window_join_kernel)
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
            from merfin_tpu.io.mkdb import KmerDB

            rdb = KmerDB(w["argv"][4])
            adb = KmerDB(w["argv"][6])
            t0 = time.perf_counter()
            table = UnionTable.from_dbs(rdb.keys, rdb.vals, adb.keys,
                                        adb.vals, "cuda")
            say(f"  union table: {table.n} keys, {table.nbytes() / 1e9:.2f} GB "
                f"on the card ({time.perf_counter() - t0:.1f} s)")
            q = dispatch_queries(w["asm_first"], w["k"], rng, 1 << 20)
            err, k_ms, p_ms, hits = check_kernel(table, q, args.reps)
            say(f"  2^20 sorted queries ({hits} hits): bit-exact; kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (median of {args.reps}; "
                f"{smi})")
            err2, *_ = check_kernel(table, q[: (1 << 20) - 77], 0)
            say("  ragged length 2^20-77: bit-exact")
            del table
            tabs, qp = palindrome_table(rng)
            ptable = UnionTable.from_dbs(*tabs, "cuda")
            err3, *_ = check_kernel(ptable, qp, 0)
            say(f"  k=20 palindrome table ({ptable.n} keys): bit-exact")
            del ptable
            torch.cuda.empty_cache()
            report[union_join_kernel.name] = dict(
                max_abs_err=max(err, err2, err3), ms=k_ms, plain_ms=p_ms)
            report.update(check_single_kernels(adb, rdb, rng, args.reps))

        with phase("4 oracle"):
            check_small_worlds(tmp, args.seed, args.small_bases, args.repeat,
                               "cuda")
            check_small_modes(tmp, args.seed, args.small_bases, "cuda")

        # each main path runs with the launch counts set to 0 just before
        # it and read just after; a kernel reports the sum over its paths
        with phase("5 full"):
            launches = {union_join_kernel.name: _run_full(
                w, os.path.join(tmp, "full", "run"))}

        with phase("6 completeness full"):
            launches.update(_run_completeness_full(
                w, os.path.join(tmp, "full", "compl")))

        with phase("7 dump full"):
            launches[union_join_kernel.name] += _run_dump_full(
                w, os.path.join(tmp, "full", "dump"))

    print(json.dumps({"kernels": [{
        "name": kern.name, "route": "cuda", "source": kern.source,
        "replaces": kern.replaces, "launches": launches[kern.name],
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
    hist, err, counters = run_port_inprocess(w["argv"], cwd, log)
    if on_card:
        torch.cuda.synchronize()
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
    t = [log.stamps[m] for m in marks]
    say(f"  split: start->DB load {t[0]:.1f} s, DB load {t[1] - t[0]:.1f} s, "
        f"union table build+upload {t[2] - t[1]:.1f} s, hist loop "
        f"{t[3] - t[2]:.1f} s, output {wall - t[3]:.1f} s")
    say(f"  -hist wall {wall:.1f} s for {w['bases']} bases: "
        f"{w['bases'] / wall:.0f} bases/s; kernel launches {launches}; "
        f"counters {counters}")
    return launches


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
    from merfin_tpu.io.mkdb import KmerDB
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

    lines = completeness_lines(err)
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
    whole union table on the card) for one scaffold and the contigs:
    per-sequence missing and cumulative kasm against the independent
    count, the row count, and the union-join launches of that run."""
    import torch

    from merfin_tpu_torch.ops.union_join import union_join_kernel

    on_card = _on_card()
    argv = mode_argv(w["argv"], "dump")
    argv[argv.index("-sequence") + 1] = w["dump_fasta"]
    marks = ("-- Loading kmers", "-- Dump per-base", "Processing sequence")
    log = StampedLog(marks)
    union_join_kernel.launches = 0
    rows, err, counters = run_port_inprocess(argv, cwd, log, out="out.dump")
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
    assert counters == {c: 0 for c in COUNTERS}, counters
    if on_card:
        assert launches > 0, "the full -dump run never launched the kernel"
    t = [log.stamps[m] for m in marks]
    say(f"  split: DB load {t[1] - t[0]:.1f} s, union table build+upload "
        f"{t[2] - t[1]:.1f} s, dump loop + rows {wall - t[2]:.1f} s")
    say(f"  -dump wall {wall:.1f} s for {w['dump_bases']} bases "
        f"({len(got)} sequences, {n_rows} rows, {len(rows)} bytes, "
        f"missing {cum_mis}): {w['dump_bases'] / wall:.0f} bases/s; "
        f"union_join launches {launches}")
    return launches


if __name__ == "__main__":
    raise SystemExit(main())
