#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: python3 chip_smoke.py

Drives merfin_tpu_torch's -hist main path end to end on the GPU and
checks it, phase by phase (any failure exits non-zero with its
traceback):

  1. device   nvidia-smi name/power limit, torch/CUDA versions; requires
              compute capability (9, 0);
  2. build    the union-join kernel from csrc/ with nvcc for sm_90a;
  3. kernel   the kernel vs its plain PyTorch version at the main path's
              shapes (the full world's union table, one dispatch's sorted
              2^20-window query stream with hits, misses and sentinels,
              a ragged length, and a k=20 table with palindromes):
              bit-exact, with median times of both;
  4. oracle   small worlds through the CLI on CUDA: the verify recipe's
              world and a fragmented 200 kb world with a -prob table are
              held byte for byte to tests/refmodel.py:hist_mode; the same
              world with a high-copy repeat (f32 fallback bins, kover
              fallback, bin growth) is held to refmodel on kasm/missing
              and byte for byte to the port's own CPU run;
  5. full     a synthetic 64 Mbp assembly (4 large scaffolds, 2,000
              contigs of 1-20 kb, N gaps, 2,000 substitutions; k=21,
              peak 30) against a read DB of the true genome's k-mers at
              Poisson(30) counts plus 128M error k-mers, through the CLI:
              kasm/kmissing against an independent numpy count, the
              kernel's launch count, zero exactness fallbacks, wall time
              and bases/s.

The world is made from --seed with numpy; databases are written with the
shared KmerDB.create.  The last three stdout lines are a JSON object of
the kernels (launches in phase 5, max |kernel - plain|, median ms of
each), the card's `nvidia-smi --query-gpu=name,power.limit` line, and
{"ok": true, "device": {...}}.

Without CUDA the script fails (exit 1) and prints no result.  Phases 4
and 5 also run on the CPU at a tiny size in tests/test_torch_hist.py
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


def run_port_subprocess(argv, cwd: str, platform: str):
    """-> (hist bytes, stderr text, counters) of one port CLI process."""
    env = dict(os.environ, MERFIN_PLATFORM=platform)
    proc = subprocess.run(counted_cli("merfin_tpu_torch") + argv
                          + ["-output", "out.hist"], cwd=cwd, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"port CLI failed ({platform}):\n{proc.stderr}")
    with open(os.path.join(cwd, "out.hist"), "rb") as f:
        hist = f.read()
    return hist, proc.stderr, json.loads(proc.stdout.splitlines()[-1])


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


def run_port_inprocess(argv, cwd: str, err: io.StringIO | None = None):
    """The port's CLI entry point in this process (the device comes from
    MERFIN_PLATFORM) -> (hist bytes, stderr text, counters)."""
    from merfin_tpu_torch.cli import main

    os.makedirs(cwd, exist_ok=True)
    err = io.StringIO() if err is None else err
    with contextlib.chdir(cwd), recording_engines() as made, \
            contextlib.redirect_stderr(err):
        rc = main(argv + ["-output", "out.hist"])
    if rc != 0:
        raise RuntimeError(f"port CLI failed:\n{err.getvalue()}")
    with open(os.path.join(cwd, "out.hist"), "rb") as f:
        hist = f.read()
    return hist, err.getvalue(), {c: getattr(made[-1], c) for c in COUNTERS}


# ---------------------------------------------------------------- oracle

def oracle(world: dict):
    """tests/refmodel.py:hist_mode formatted as tests/test_modes.py
    formats it -> (hist bytes, per-sequence lines, summary lines)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "refmodel", os.path.join(REPO, "tests", "refmodel.py"))
    refmodel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refmodel)

    k, peak = world["k"], world["peak"]
    ck, cp = [], []
    if world["prob"]:
        for line in world["prob"].splitlines():
            a, b = line.split(",")
            ck.append(int(a))
            cp.append(float(b))
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

    # independent expectation (numpy): kasm = valid windows; a window
    # that overlaps no substitution is a window of the true genome, so
    # its mer is a read key; the rest are looked up in the read keys
    kasm = 0
    cand = []
    pos_sorted = np.sort(pos)
    for i, c in enumerate(pieces(asm)):
        fmer, rmer, valid = kmers_from_codes_np(c, k)
        kasm += int(np.count_nonzero(valid))
        lo, hi = np.searchsorted(pos_sorted, [starts[i], starts[i + 1]])
        local = pos_sorted[lo:hi] - starts[i]
        win = (local[:, None] - np.arange(k)[None, :]).reshape(-1)
        win = np.unique(win[(win >= 0) & (win < valid.size)])
        win = win[valid[win]]
        cand.append(np.minimum(fmer[win], rmer[win]))
    q = np.concatenate(cand)
    idx = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    kmissing = int(np.count_nonzero(keys[idx] != q))
    say(f"  full world steps: read DB {t1 - t0:.1f} s, asm DB + writes "
        f"{t2 - t1:.1f} s, expectation {time.perf_counter() - t2:.1f} s")

    fasta = os.path.join(d, "asm.fasta")
    with open(fasta, "wb") as f:
        for i in range(lens.size):
            name = f"scaffold{i}" if i < 4 else f"contig{i - 4}"
            f.write(f">{name}\n".encode())
            f.write(_ACGT[asm[starts[i]: starts[i + 1]]].tobytes())
            f.write(b"\n")
    return dict(argv=["-hist", "-sequence", fasta, "-readmers", read_db,
                      "-seqmers", asm_db, "-peak", str(peak)],
                bases=int(asm.size), n_seqs=int(lens.size), kasm=kasm,
                kmissing=kmissing, read_keys=int(keys.size),
                asm_first=asm[: starts[1]], k=k)


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


def check_kernel(table, q_np: np.ndarray, reps: int):
    """Kernel vs plain on ``table`` for sorted queries: bit-exact check,
    max |diff|, median ms of each (plain, kernel, kernel, plain)."""
    import torch

    q = torch.from_numpy(q_np.view(np.int64)).to(table.device)
    kr, ka = table.lookup2_sorted(q)
    pr, pa = table.lookup2_plain(q)
    torch.cuda.synchronize()
    err = max(int((kr.to(torch.int64) - pr.to(torch.int64)).abs().max()),
              int((ka.to(torch.int64) - pa.to(torch.int64)).abs().max()))
    assert torch.equal(kr, pr) and torch.equal(ka, pa), "kernel != plain"
    hits = int(((pr != 0) | (pa != 0)).sum())
    if reps == 0:
        return err, None, None, hits
    p1 = _median_ms(lambda: table.lookup2_plain(q), reps)
    k1 = _median_ms(lambda: table.lookup2_sorted(q), reps)
    k2 = _median_ms(lambda: table.lookup2_sorted(q), reps)
    p2 = _median_ms(lambda: table.lookup2_plain(q), reps)
    return err, min(k1, k2), min(p1, p2), hits


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
    from merfin_tpu_torch.ops.union_join import (UnionTable,
                                                 union_join_kernel)

    with phase("1 device"):
        smi = smi_line()
        cap = torch.cuda.get_device_capability(0)
        say(f"  nvidia-smi: {smi}")
        say(f"  torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} capability {cap} "
            f"count {torch.cuda.device_count()}")
        assert cap == (9, 0), f"needs compute capability (9, 0), got {cap}"

    with phase("2 build"):
        t0 = time.perf_counter()
        union_join_kernel.build()
        say(f"  built {_build.library_path('union_join').name} in "
            f"{time.perf_counter() - t0:.1f} s")
        for line in _build.BUILD_LOGS.get("union_join", "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")

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
            report = dict(max_abs_err=max(err, err2, err3), ms=k_ms,
                          plain_ms=p_ms)

        with phase("4 oracle"):
            check_small_worlds(tmp, args.seed, args.small_bases, args.repeat,
                               "cuda")

        with phase("5 full"):
            launches = _run_full(w, os.path.join(tmp, "full", "run"))

    print(json.dumps({"kernels": [{
        "name": union_join_kernel.name, "route": "cuda",
        "source": union_join_kernel.source,
        "replaces": union_join_kernel.replaces,
        "launches": launches, **report}]}))
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

    on_card = torch.cuda.is_available() and \
        os.environ.get("MERFIN_PLATFORM") == "cuda"
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


if __name__ == "__main__":
    raise SystemExit(main())
