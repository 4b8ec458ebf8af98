"""The variant modes end to end: the merfin_tpu_torch CLI on the CPU vs
the JAX CLI (bin/merfin-tpu) on the CPU.

Each package runs every case of a world in one process (batch_subprocess
below, stderr captured per run).  The .vcf outputs, the decompressed -debug
logs, the exit codes and stderr must be byte-identical.  Worlds:

  * the verify recipe's (k=15, three true corrections, one spurious call);
  * tests/test_variant_modes.py's (k=11, peak 30);
  * a k=21 chip_parity-style world with a -prob table (-polish and
    -polish -devscore take the f64 fused path in the port, the host
    scorer in the JAX CLI, so their stderr differs by the line naming the
    fused scorer);
  * a het world (k=21): the reads hold both ALT alleles of a 1/2 site,
    so two paths tie on missing k-mers and on totdk, and -polish writes
    a 1/2 record;
  * a heavy-cluster world as in bench.py:_bench_variants_heavy with
    n_vars = 8 (576 paths a cluster), also at -threads 3 (spawned pool).

The f64 fused path (-prob) sums totdk in merfin's order, bit for bit
(tests/test_torch_path_sum.py); the JAX scorers' sums (the host
scorer's pairwise np.sum, the fused two-level prefix difference) differ
in the last bits, and on these worlds no two paths come that close, so
the output is held to bytes here.
"""

import gzip
import io
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from tests.util import random_dna

HOST = ["-nodevscore"]
FUSED = "-- Using fused device scoring (-devscore).\n"


_BATCH_RUN = """
import contextlib, importlib, io, json, os, sys


class Switch(io.TextIOBase):
    # The stderr of every run, set before the CLI is imported: a module
    # binds it as a log=sys.stderr default, so it writes to the current
    # run's file.
    f = sys.__stderr__

    def write(self, s):
        return self.f.write(s)

    def flush(self):
        self.f.flush()


sys.stderr = switch = Switch()
sys.path.insert(0, {repo!r})
main = importlib.import_module("{pkg}.cli").main
rcs = {{}}
for tag, argv in json.loads(sys.argv[1]):
    os.makedirs(tag)
    with open(os.path.join(tag, "stderr"), "w") as f, contextlib.chdir(tag):
        switch.f = f
        try:
            rcs[tag] = main(argv)
        finally:
            switch.f = sys.__stderr__
print(json.dumps(rcs))
"""


def batch_subprocess(pkg: str, runs, cwd: str, env):
    """Start one process that runs ``pkg``'s CLI once for each (tag, argv)
    of ``runs``, each in its own directory ``cwd/tag`` with its stderr in
    ``cwd/tag/stderr``; it prints {tag: exit code}."""
    os.makedirs(cwd, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-c", _BATCH_RUN.format(repo=cs.REPO, pkg=pkg),
         json.dumps(runs)], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_batch(proc, cwd: str) -> dict:
    """{tag: (exit code, stderr, {output file: bytes})} of a
    batch_subprocess, once it has exited 0; .gz outputs are decompressed
    (gzip stamps each member's time)."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"CLI batch failed:\n{stderr[-3000:]}")
    res = {}
    for tag, rc in json.loads(stdout.splitlines()[-1]).items():
        d = os.path.join(cwd, tag)
        outs = {}
        for name in sorted(os.listdir(d)):
            if name != "stderr":
                with open(os.path.join(d, name), "rb") as f:
                    data = f.read()
                outs[name] = gzip.decompress(data) if name.endswith(".gz") \
                    else data
        with open(os.path.join(d, "stderr")) as f:
            res[tag] = (rc, f.read(), outs)
    return res


def tvm_world() -> dict:
    """tests/test_variant_modes.py's world (2 errors, 1 spurious call)."""
    rng = random.Random(123)
    g = random_dna(rng, 600)
    asm = list(g)
    for p in (150, 400):
        asm[p] = cs.ALT_OF[asm[p]]
    asm = "".join(asm)
    vcf = [("chr1", p, asm[p], g[p], "40.7", "1/1") for p in (150, 400)]
    vcf.append(("chr1", 250, asm[250], cs.ALT_OF[asm[250]], "13.2", "1/1"))
    return dict(k=11, peak=30.0, scaffolds=[("chr1", asm)], reads=[g] * 30,
                prob=None, vcf=sorted(vcf, key=lambda r: r[1]))


def het_world() -> dict:
    """Reads of two haplotypes: Y or Z at 300 (the assembly has X), the
    assembly base or W at 700; a true correction at 1000."""
    rng = np.random.default_rng(7)
    g = cs._dna(rng, 1200)
    x = g[300]
    y, z, w = cs.ALT_OF[x], cs.ALT_OF[cs.ALT_OF[x]], cs.ALT_OF[g[700]]
    hap_y = g[:300] + y + g[301:700] + w + g[701:]
    hap_z = g[:300] + z + g[301:]
    asm = g[:1000] + cs.ALT_OF[g[1000]] + g[1001:]
    vcf = [("chr1", 300, x, f"{y},{z}", "50", "1/2"),
           ("chr1", 700, g[700], w, "30", "0/1"),
           ("chr1", 1000, asm[1000], g[1000], "40", "1/1")]
    return dict(k=21, peak=30.0, scaffolds=[("chr1", asm)],
                reads=[hap_y] * 15 + [hap_z] * 15, prob=None, vcf=vcf)


def heavy_world(n_clusters: int = 3, n_vars: int = 8, spacing: int = 8,
                k: int = 21) -> dict:
    """bench.py:_bench_variants_heavy's world: clusters of n_vars
    variants (true correction, spurious SNP, 1/2 site, insertion, ...)."""
    rng = random.Random(17)
    gap = 400
    n = n_clusters * (n_vars * spacing + gap) + 2 * k
    genome = "".join(rng.choice("ACGT") for _ in range(n))
    asm = list(genome)
    rows = []
    for c in range(n_clusters):
        base = c * (n_vars * spacing + gap) + k
        for v in range(n_vars):
            p = base + v * spacing
            kind = v % 4
            if kind == 0:
                asm[p] = cs.ALT_OF[asm[p]]
                rows.append(("c", p, asm[p], genome[p], "30", "1/1"))
            elif kind == 1:
                rows.append(("c", p, asm[p], cs.ALT_OF[asm[p]], "30", "1/1"))
            elif kind == 2:
                a1 = cs.ALT_OF[asm[p]]
                rows.append(("c", p, asm[p], f"{a1},{cs.ALT_OF[a1]}", "30",
                             "1/2"))
            else:
                rows.append(("c", p, asm[p], asm[p] + rng.choice("ACGT"),
                             "30", "1/1"))
    return dict(k=k, peak=30.0, scaffolds=[("c", "".join(asm))],
                reads=[genome] * 30, prob=None, vcf=rows)


WORLDS = {
    "recipe": (cs.recipe_world, {
        "polish_host": ["-polish"] + HOST,
        "loose_host": ["-loose"] + HOST,
        "polish_debug": ["-polish", "-debug"],
        "filter_debug_devscore": ["-filter", "-debug", "-devscore"]}),
    "tvm": (tvm_world, {
        "polish_host": ["-polish"] + HOST,
        "filter_host": ["-filter"] + HOST,
        "strict_host": ["-strict"] + HOST,
        "better_debug": ["-better", "-debug"]}),
    "k21prob": (lambda: cs.parity_world(1, 100_000, k=21), {
        "polish_devscore": ["-polish", "-devscore"],
        "filter_host": ["-filter"] + HOST,
        "polish_debug": ["-polish", "-debug"]}),
    "het": (het_world, {
        "polish_host": ["-polish"] + HOST,
        "loose_host": ["-loose"] + HOST}),
    "heavy": (heavy_world, {
        "polish_t3": ["-polish", "-threads", "3"],
        "filter_t3": ["-filter", "-threads", "3"],
        "polish_host_t3": ["-polish", "-threads", "3"] + HOST}),
}


def _env(tmp_path):
    # TF_CPP_MIN_LOG_LEVEL=3: XLA's own C++ diagnostics (the slow-compile
    # alarm, timed on the wall clock of a loaded machine) stay out of the
    # JAX CLI's stderr, which is compared byte for byte
    return dict(os.environ, JAX_PLATFORMS="cpu", MERFIN_PLATFORM="cpu",
                MERFIN_TPU_CACHE=str(tmp_path / "jax_cache"),
                TF_CPP_MIN_LOG_LEVEL="3")


@pytest.mark.parametrize("name", WORLDS)
def test_variant_modes_port_match_jax_cli(name, tmp_path):
    make, extra = WORLDS[name]
    world = make()
    argv = cs.materialize(world, str(tmp_path / "world"))
    runs = [(m, cs.vcf_argv(argv, m) + ["-threads", "1", "-output", "out"])
            for m in cs.VARIANT_MODES]
    for tag, flags in extra.items():
        mode = flags[0][1:]
        runs.append((tag, cs.vcf_argv(argv, mode) + flags[1:]
                     + (["-threads", "1"] if "-threads" not in flags else [])
                     + ["-output", "out"]))
    procs = {pkg: batch_subprocess(pkg, runs, str(tmp_path / pkg),
                                   _env(tmp_path))
             for pkg in ("merfin_tpu_torch", "merfin_tpu")}
    res = {pkg: wait_batch(p, str(tmp_path / pkg))
           for pkg, p in procs.items()}
    port, jax = res["merfin_tpu_torch"], res["merfin_tpu"]
    assert port.keys() == jax.keys()
    for tag in port:
        got = port[tag]
        if tag == "polish" and world["prob"]:
            # -polish -prob: the port's fused scorer, the JAX CLI's host one
            assert FUSED in got[1] and FUSED not in jax[tag][1]
            got = (got[0], got[1].replace(FUSED, "", 1), got[2])
        assert got == jax[tag], (tag, got[1][-800:], jax[tag][1][-800:])

    rc, err, outs = port["polish"]
    assert rc == 0 and err.endswith("Bye!\n")
    assert FUSED in err
    for tag, (rc, err, outs) in port.items():
        if tag == "filter_debug_devscore":
            assert rc == 1 and "cannot run with -devscore" in err
            assert not outs
        elif tag.endswith("_debug"):
            assert "out.00.debug.gz" in outs
            assert outs["out.00.debug.gz"].count(b"\n") > 0
    n_rec = cs.vcf_records(port["polish"][2]["out.polish.vcf"])
    if name == "recipe":
        assert n_rec == 3 and port["polish_host"][2] == port["polish"][2]
    elif name == "tvm":
        assert n_rec == 2 and port["filter"][2]["out.filter.vcf"].endswith(
            b"\t40.7\tPASS\t.\tGT\t1/1\n")
    elif name == "het":
        pol = port["polish"][2]["out.polish.vcf"].decode()
        assert "chr1\t301\t.\t" in pol and "\t1/2\n" in pol
        assert n_rec == 3
    elif name == "heavy":
        assert n_rec == 6     # the two true corrections of each cluster
        assert port["polish_t3"][2] == port["polish"][2]
        assert port["polish_host_t3"][2] == port["polish"][2]


@pytest.mark.parametrize("scorer", ["fused", "host"])
def test_variants_resume_continues_exactly(scorer, tmp_path):
    """A run cut at a sequence boundary and resumed with -resume ends
    with the output of an uninterrupted run."""
    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.io.prob import load_prob_table
    from merfin_tpu.io.vcf import VcfFile
    from merfin_tpu_torch.modes.variants import run_variants
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    world = cs.parity_world(4, 30_000, k=21)
    argv = cs.materialize(world, str(tmp_path))
    fasta, vcf_path = argv[2], str(tmp_path / "calls.vcf")
    rdb, adb = KmerDB(argv[4]), KmerDB(argv[6])
    prob = load_prob_table(argv[argv.index("-prob") + 1], log=io.StringIO())
    rl, al = build_lookup(rdb, device="cpu"), build_lookup(adb, device="cpu")
    lookups = rl.lookup_np, al.lookup_np

    def run(out, seqs, resume):
        vcf = VcfFile(vcf_path, log=io.StringIO())
        vcf.merge_clusters(21, 15, False, log=io.StringIO())
        sc = DeviceScorer(rl, al, 21, 2.0, prob, max_value=int(rdb.vals.max()),
                          exact_max=True) if scorer == "fused" else None
        log = io.StringIO()
        run_variants("filter", seqs, vcf, 21, *lookups, 2.0, prob,
                     str(tmp_path / out), log=log, resume=resume, scorer=sc)
        return log.getvalue()

    class Interrupted(SeqFile):
        def __iter__(self):
            for i, s in enumerate(super().__iter__()):
                if i == 6:
                    raise KeyboardInterrupt
                yield s

    full_log = run("full", SeqFile(fasta), False)
    with pytest.raises(KeyboardInterrupt):
        run("cut", Interrupted(fasta), True)
    assert os.path.exists(tmp_path / "cut.ckpt.json")
    log = run("cut", SeqFile(fasta), True)
    assert "-- Resuming after 6 sequences." in log
    assert not os.path.exists(tmp_path / "cut.ckpt.json")
    full = (tmp_path / "full.filter.vcf").read_bytes()
    assert (tmp_path / "cut.filter.vcf").read_bytes() == full
    assert cs.vcf_records(full) > 0
    assert log.count("Processing sequence") < full_log.count(
        "Processing sequence")


@pytest.mark.parametrize("flags", [
    ["-polish"], ["-polish", "-nodevscore"], ["-polish", "-debug"],
    ["-filter", "-nodevscore"]])
def test_host_scorer_builds_no_union_table(flags, tmp_path, monkeypatch):
    """The host scorer (-nodevscore, -debug) probes the gather tables'
    lookup_np, as the JAX CLI does, and builds no union table; -polish
    with a -prob table takes the fused scorer, on the CPU's gather
    tables, and builds none either.  The VCF equals the JAX CLI's (whose
    -polish -prob runs the host scorer; stderr is held in
    test_variant_modes_port_match_jax_cli)."""
    from merfin_tpu_torch import cli
    from merfin_tpu_torch.ops import union_join

    def refuse(*a, **kw):
        raise AssertionError("a union table was built")

    world = cs.parity_world(8, 20_000, k=21)
    argv = cs.vcf_argv(cs.materialize(world, str(tmp_path)), flags[0][1:])
    argv += flags[1:] + ["-threads", "1", "-output", "out"]
    port = tmp_path / "port"
    port.mkdir()
    with monkeypatch.context() as m:
        m.setenv("MERFIN_PLATFORM", "cpu")
        m.setattr(union_join.UnionTable, "__init__", refuse)
        m.chdir(port)
        err = io.StringIO()
        m.setattr(sys, "stderr", err)
        assert cli.main(argv) == 0
    assert (FUSED in err.getvalue()) == (flags == ["-polish"])
    jax = str(tmp_path / "jax")
    rc, _, outs = wait_batch(batch_subprocess(
        "merfin_tpu", [("run", argv)], jax, _env(tmp_path)), jax)["run"]
    vcf = cs.variant_vcf(argv)
    assert rc == 0 and (port / vcf).read_bytes() == outs[vcf]
    assert cs.vcf_records(outs[vcf]) > 0


def test_scatter_polish_tool_matches_one_run(tmp_path, monkeypatch):
    """tools/scatter_polish.py: `run` over 2 shards (each scaffold stripe
    with its VCF records, through the port's CLI) then `gather` gives the
    records of one -polish run, and the same file, byte for byte, as
    scripts/scatter_polish.py run on the JAX CLI."""
    from merfin_tpu_torch.cli import main
    from merfin_tpu_torch.tools import scatter_polish as sp

    world = cs.parity_world(9, 30_000, k=21)
    argv = cs.materialize(world, str(tmp_path / "world"))
    opts = ["--mode", "polish", "--shards", "2"]
    run = opts + ["--sequence", argv[2], "--vcf",
                  str(tmp_path / "world" / "calls.vcf"), "--readmers",
                  argv[4], "--seqmers", argv[6], "--peak", argv[8],
                  "--prob", argv[argv.index("-prob") + 1]]
    env = _env(tmp_path)
    for tag in ("port", "jax", "one"):
        (tmp_path / tag).mkdir()
    jax = tmp_path / "jax"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(cs.REPO, "scripts", "scatter_polish.py"),
         "run"] + run + ["--shard", str(i), "--output", str(jax / "sg")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    one = tmp_path / "one" / "out"
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    assert main(cs.vcf_argv(argv, "polish") + ["-threads", "1",
                                                "-output", str(one)]) == 0
    for i in range(2):
        assert sp.main(["run"] + run + ["--shard", str(i), "--output",
                                        str(tmp_path / "port" / "sg")]) == 0
    assert sp.main(["gather"] + opts + ["--output",
                                        str(tmp_path / "port" / "sg")]) == 0
    for p in procs:
        assert p.wait(timeout=600) == 0, p.stderr.read()[-3000:]
    subprocess.run([sys.executable, os.path.join(
        cs.REPO, "scripts", "scatter_polish.py"), "gather"] + opts
        + ["--output", str(jax / "sg")], env=env, check=True,
        capture_output=True)
    got = (tmp_path / "port" / "sg.polish.vcf").read_bytes()
    assert got == (jax / "sg.polish.vcf").read_bytes()
    want = (tmp_path / "one" / "out.polish.vcf").read_bytes()

    def split(vcf: bytes):
        lines = vcf.decode().splitlines(keepends=True)
        return ([ln for ln in lines if ln.startswith("#")],
                sorted(ln for ln in lines if not ln.startswith("#")))

    assert split(got) == split(want) and cs.vcf_records(want) > 0
    for i in range(2):      # both stripes ran (chrL's records are shard 0's)
        assert (tmp_path / "port" / f"sg.shard{i}.polish.vcf").exists()


def light_run_world() -> dict:
    """Two scaffolds of light clusters (fixes, spurious SNPs, 1/2 sites,
    deletions, insertions, 0/1 and ./. calls), with a heavy cluster of 7
    SNPs (128 paths) and a cluster of 9 variants (PANIC-skipped at -comb
    8) inside the first scaffold's runs; reads on a coverage ladder and
    a -prob table, as parity_world's."""
    rng = np.random.default_rng(18)
    k = 21
    true = [cs._dna(rng, 9_000), cs._dna(rng, 3_000)]
    asm = [bytearray(s.encode()) for s in true]
    rows = []
    kinds = ("fix", "snp", "multi", "del", "ins", "het", "fix", "none")
    for si, name in enumerate(("c1", "c2")):
        t = true[si]
        for n, p in enumerate(range(60, len(t) - 60, 110)):
            if si == 0 and n in (30, 47):
                step, nv = (6, 7) if n == 30 else (4, 9)
                for v in range(nv):       # the heavy and the skipped one
                    q = p + v * step
                    rows.append((name, q, t[q], cs.ALT_OF[t[q]], "30", "1/1"))
                continue
            kind = kinds[n % len(kinds)]
            b = t[p]
            if kind == "fix":
                asm[si][p] = ord(cs.ALT_OF[b])
                rows.append((name, p, cs.ALT_OF[b], b, "40.7", "1/1"))
            elif kind == "multi":
                rows.append((name, p, b, f"{cs.ALT_OF[b]},"
                             f"{cs.ALT_OF[cs.ALT_OF[b]]}", "17.2", "1/2"))
            elif kind == "del":
                rows.append((name, p, t[p: p + 3], b, "12.5", "1/1"))
            elif kind == "ins":
                rows.append((name, p, b, b + "G", "8.0", "1/1"))
            else:
                rows.append((name, p, b, cs.ALT_OF[b], "21.9",
                             {"snp": "1/1", "het": "0/1",
                              "none": "./."}[kind]))
    reads = list(true)
    for cov, frac in ((1, 1.0), (2, 0.8), (4, 0.6), (6, 0.4)):
        reads += [s[: int(len(s) * frac)] for s in true] * cov
    return dict(k=k, peak=2.0, reads=reads, vcf=rows,
                scaffolds=[("c1", asm[0].decode()), ("c2", asm[1].decode())],
                prob="1,0.931\n1,0.871\n2,0.773\n2,0.597\n3,0.401\n")


@pytest.mark.parametrize("prob", [False, True])
@pytest.mark.parametrize("mode", ["polish", "filter"])
def test_light_runs_built_as_batches_match_host_scorer(mode, prob, tmp_path,
                                                       monkeypatch):
    """The fused scorer's runs of light clusters, built as one block each
    (a run cut at the batch cap, a heavy cluster between runs, a
    PANIC-skipped cluster inside one), write the host scorer's VCF byte
    for byte at -threads 1 and 3; the enumeration spans count every
    cluster that was not skipped, in fewer spans than clusters."""
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes import variants as mv
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.utils import spans
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    monkeypatch.setattr(mv, "_BATCH_CLUSTERS", 8)
    world = light_run_world()
    argv = cs.materialize(world, str(tmp_path))
    rdb, adb = KmerDB(argv[4]), KmerDB(argv[6])
    table = load_prob_table(argv[argv.index("-prob") + 1],
                            log=io.StringIO()) if prob else None
    rl, al = build_lookup(rdb, device="cpu"), build_lookup(adb, device="cpu")

    def run(tag, threads, fused):
        vcf = VcfFile(str(tmp_path / "calls.vcf"), log=io.StringIO())
        vcf.merge_clusters(21, 15, False, log=io.StringIO())
        sc = DeviceScorer(rl, al, 21, 2.0, table, max_value=int(
            rdb.vals.max()), exact_max=True) if fused else None
        log = io.StringIO()
        mv.run_variants(mode, SeqFile(argv[2]), vcf, 21, rl.lookup_np,
                        al.lookup_np, 2.0, table, str(tmp_path / tag),
                        comb=8, log=log, threads=threads, scorer=sc)
        name = f"{tag}.{'polish' if mode == 'polish' else 'filter'}.vcf"
        return (tmp_path / name).read_bytes(), log.getvalue(), vcf

    host, host_log, vcf = run("host", 1, False)
    n_clusters = sum(len(c) for c in vcf.by_chrom.values())
    assert n_clusters == 108 and host_log.count("PANIC") == 1
    for threads in (1, 3):
        spans.clear()
        spans.enable()
        try:
            fused, log, _ = run(f"fused{threads}", threads, True)
        finally:
            spans.disable()
        assert fused == host and log == host_log
        names = [s.name for s in spans.records()]
        counts = [s.counts["clusters"] for s in spans.records()
                  if s.name == "variants.enumerate"]
        if threads == 1:      # the heavy cluster alone on the build thread
            assert sum(counts) == n_clusters - 1
            assert 1 in counts and "variants.pool_spawn" not in names
        else:                 # the heavy cluster on the pool (recorder off)
            assert sum(counts) == n_clusters - 2
            assert "variants.pool_spawn" in names
        assert max(counts) == 8 and len(counts) < n_clusters / 4
    assert cs.vcf_records(host) > 20
