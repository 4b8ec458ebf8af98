"""The -hist slice end to end: the merfin_tpu_torch CLI on the CPU vs the
JAX CLI (bin/merfin-tpu) on the CPU, each with no route flag (the gather
tables on the CPU), with -sortjoin (the union join) and with -nosortjoin
(the gather tables).

Worlds: the verify recipe's, and chip_parity-style ~100 kb worlds (a
-prob table, odd k=21 and even k=20, short scaffolds for the packed-group
path, a repeat that forces bin growth and the bin/kover fallbacks), and
one whose A homopolymer holds an N run while the read DB counts the
poly-A mer (key 0) past the value map's cap: the gather route probes the
invalid windows' canonical mers (the Ns read as A) before masking them,
so its overflow count differs from the union route's.  For each flag the
hist file, stderr and the exactness counters must be byte-identical to
the JAX CLI's with the same flag.
"""

import io
import json
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SJ_LINE = "-- Using sorted-join lookup kernel for -hist.\n"


def nrun_world() -> dict:
    """parity_world with an N run inside its A homopolymer, and the
    poly-A mer counted 4,200,000 times in the reads (past 2^21, so the
    value map's cap of 2^22 leaves the overflow fallback live)."""
    world = cs.parity_world(3, 60_000, k=21, repeat=5_000)
    name, asm = world["scaffolds"][0]
    at = asm.index("A" * 5_000) + 2_500
    world["scaffolds"][0] = (name, asm[:at] + "N" * 7 + asm[at + 7:])
    world["read_counts"] = {"A" * 21: 4_200_000}
    return world


WORLDS = {
    "recipe": cs.recipe_world,
    "k21": lambda: cs.parity_world(1, 100_000, k=21, repeat=40_000),
    "k20": lambda: cs.parity_world(2, 100_000, k=20, repeat=40_000),
}
HIST_WORLDS = dict(WORLDS, nrun=nrun_world)
FLAGS = {"auto": [], "sortjoin": ["-sortjoin"], "nosortjoin": ["-nosortjoin"]}


def _env(tmp_path):
    # TF_CPP_MIN_LOG_LEVEL=3: XLA's own C++ diagnostics (the slow-compile
    # alarm, timed on the wall clock of a loaded machine) stay out of the
    # JAX CLI's stderr, which is compared byte for byte
    return dict(os.environ, JAX_PLATFORMS="cpu", MERFIN_PLATFORM="cpu",
                MERFIN_TPU_CACHE=str(tmp_path / "jax_cache"),
                TF_CPP_MIN_LOG_LEVEL="3")


@pytest.mark.parametrize("name", HIST_WORLDS)
def test_hist_port_matches_jax_cli(name, tmp_path):
    world = HIST_WORLDS[name]()
    argv = cs.materialize(world, str(tmp_path))
    runs = {(pkg, flag): cs.counted_cli(pkg) + argv + extra
            for pkg in ("merfin_tpu_torch", "merfin_tpu")
            for flag, extra in FLAGS.items()}
    procs = {}
    for tag, cmd in runs.items():
        cwd = tmp_path / "_".join(tag)
        cwd.mkdir()
        procs[tag] = subprocess.Popen(
            cmd + ["-output", "out.hist"], cwd=cwd, env=_env(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for tag, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (tag, stderr[-3000:])
        out[tag] = ((tmp_path / "_".join(tag) / "out.hist").read_bytes(),
                    stderr, stdout.splitlines()[-1])

    for flag in FLAGS:
        assert out["merfin_tpu_torch", flag] == out["merfin_tpu", flag], flag
    hist, err, counters = out["merfin_tpu_torch", "sortjoin"]
    assert err.count(SJ_LINE) == 1
    # no flag takes the gather route on the CPU, as -nosortjoin does
    assert out["merfin_tpu_torch", "auto"] == \
        out["merfin_tpu_torch", "nosortjoin"]
    g_hist, g_err, g_counters = out["merfin_tpu_torch", "nosortjoin"]
    assert g_hist == hist and g_err == err.replace(SJ_LINE, "")
    if name == "nrun":     # the gather route counted the N windows too
        over = [json.loads(c)["overflow_values"] for c in (counters,
                                                           g_counters)]
        assert 0 < over[0] < over[1], over
    else:
        assert g_counters == counters
    if name not in ("recipe", "nrun"):   # growth + fallbacks exercised
        assert "Growing k* histogram" in err
        assert '"bin_fallbacks": 0' not in counters
        assert '"kover_fallbacks": 0' not in counters


def test_resume_continues_exactly(tmp_path):
    """An interrupted run resumed with -resume ends with the same hist
    file and summary as an uninterrupted one."""
    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.modes.engine import KstarEngine
    from merfin_tpu_torch.modes.hist import run_hist

    world = cs.parity_world(4, 30_000, k=21)
    argv = cs.materialize(world, str(tmp_path))
    fasta = argv[2]

    def engine():
        return KstarEngine(
            build_lookup(KmerDB(argv[4]), device="cpu"),
            build_lookup(KmerDB(argv[6]), device="cpu"), 21, 2.0,
            chunk=4096, batch=2)

    full_log = io.StringIO()
    run_hist(engine(), SeqFile(fasta), str(tmp_path / "full.hist"),
             log=full_log)

    class Interrupted(SeqFile):
        def iter_coded(self, window=None):
            for i, s in enumerate(super().iter_coded(window)):
                if i == 12:
                    raise KeyboardInterrupt
                yield s

    out = str(tmp_path / "resumed.hist")
    with pytest.raises(KeyboardInterrupt):
        run_hist(engine(), Interrupted(fasta), out, log=io.StringIO(),
                 resume=True)
    assert os.path.exists(out + ".ckpt.json")
    log = io.StringIO()
    run_hist(engine(), SeqFile(fasta), out, log=log, resume=True)
    assert "-- Resuming after" in log.getvalue()
    assert not os.path.exists(out + ".ckpt.json")
    assert (tmp_path / "full.hist").read_bytes() == open(out, "rb").read()
    assert cs.summary_of(log.getvalue()) == cs.summary_of(full_log.getvalue())
    # every sequence's line appears once across the two runs' logs
    done = len(cs.seq_lines_of(log.getvalue()))
    assert 0 < done < len(cs.seq_lines_of(full_log.getvalue()))


def test_chip_smoke_phases_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's oracle and full-world phases at a tiny size on the
    CPU: the small worlds match tests/refmodel.py (and the recipe's
    variant modes give its 3 corrections); the full world's -hist
    kasm/kmissing, -completeness totals and -dump per-sequence counts
    match the independent numpy counts, and the variant modes give the
    planned records (heavy clusters of 576 paths, 3 pool workers); the
    counter's phase counts the assembly (equal to asm.mkdb) and a read set
    (equal to numpy's count, in RAM and through a 2 MB spilling budget);
    the mesh phase's CLI and API runs equal the single-device phases, and
    the two-process phase's outputs one process's."""
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    # one intra-op thread here and in the subprocesses: the test workers
    # share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _smoke_phases_on_cpu(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _smoke_phases_on_cpu(tmp_path):
    cs.check_small_worlds(str(tmp_path), 0, 30_000, 40_000, "cpu")
    cs.check_small_modes(str(tmp_path), 0, 30_000, "cpu")
    assert cs.check_small_variants(str(tmp_path), 0, 30_000, "cpu") == 0
    w = cs.full_world(str(tmp_path / "full"), 0, 1.0, 1 << 18, "cpu")
    assert w["n_seqs"] > 4 and w["kmissing"] > 0
    assert cs._run_full(w, str(tmp_path / "full" / "run")) == 0
    assert cs._run_completeness_full(w, str(tmp_path / "full" / "c")) == {
        "sorted_join": 0, "window_join": 0}
    assert cs._run_dump_full(w, str(tmp_path / "full" / "d")) == 0
    plan = cs.variant_plan(w, str(tmp_path / "full"), 0, heavy_vars=8)
    assert plan["heavy_paths"] == 576 and plan["n_fixes"] > 1000
    q, packed, n_paths, n_win = cs.heavy_span(w, plan, 1 << 16)
    assert n_paths == 576 and q.size == 1 << 16 and (np.diff(q) >= 0).all()
    assert packed[0] == 1 << 16 and n_win <= packed[0]
    spans = cs.path_sum_spans(w, plan, np.random.default_rng(0), 1 << 16)
    assert [s[0] for s in spans] == ["heavy span", "light span"]
    assert all(v.size == 1 << 16 and e.max() <= v.size and (e >= b).all()
               for _, v, b, e in spans)
    assert cs.check_path_sum(spans, 0, "cpu") == (0.0, {})
    assert cs._run_variants_full(w, plan, str(tmp_path / "full" / "v"),
                                 threads=3) == 0
    assert cs._run_count_full(w, str(tmp_path / "full" / "n"), 0,
                              memory_gb=0.002) == 0
    mesh = cs._run_mesh_full(w, plan, str(tmp_path / "full" / "m"))
    assert len(mesh) == 5 and set(mesh.values()) == {0}
    cs._run_two_process(w, str(tmp_path / "two"), 0, 30_000)


def test_group_and_stream_paths_agree(tmp_path):
    """The same sequences through packed groups and through the
    per-sequence stream give the same per-sequence stats and histograms
    (the engine's two device paths)."""
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.kcore.pack import encode_bases
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.modes.engine import KstarEngine

    world = cs.parity_world(5, 20_000, k=20)
    argv = cs.materialize(world, str(tmp_path))
    eng = KstarEngine(build_lookup(KmerDB(argv[4]), device="cpu"),
                      build_lookup(KmerDB(argv[6]), device="cpu"), 20, 2.0,
                      chunk=8192, batch=2)
    seqs = [encode_bases(s) for _, s in world["scaffolds"][1:8]]
    stats, undr, over, _ = eng.hist_group(seqs)
    u_sum = np.zeros_like(undr)
    o_sum = np.zeros_like(over)
    for st, c in zip(stats, seqs):
        one, u, o = eng.hist_sequence(c)
        assert (one.kasm, one.kmissing) == (st.kasm, st.kmissing)
        u_sum += u
        o_sum += o
    np.testing.assert_array_equal(u_sum, undr)
    np.testing.assert_array_equal(o_sum, over)


@pytest.mark.parametrize("extra,env", [
    (["-dump", "-mesh", "1x2"], {}), (["-hist", "-mesh", "1x2"], {}),
    (["-hist", "-mesh", "1x1"], {"MERFIN_NUM_PROCESSES": "2"}),
    (["-completeness", "-mesh", "1x1"], {"MERFIN_NUM_PROCESSES": "2"}),
    (["-polish", "-vcf", "x.vcf", "-mesh", "1x2"], {}),
    (["-filter", "-vcf", "x.vcf", "-mesh", "1x1"],
     {"MERFIN_NUM_PROCESSES": "2"}),
])
def test_unported_paths_exit_1(extra, env, tmp_path, monkeypatch, capsys):
    """-mesh and multi-process launches, once refused as not ported, now
    run the JAX CLI's mesh checks: a mesh larger than the visible devices,
    and under a multi-process launch (the job's join stubbed: two
    processes of one device each) a mesh that leaves devices out, exit 1
    with the JAX CLI's message."""
    from merfin_tpu_torch.cli import main
    from merfin_tpu_torch.parallel import multihost as mh

    argv = cs.materialize(cs.recipe_world(), str(tmp_path))
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    monkeypatch.delenv("MERFIN_CPU_DEVICES", raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    if env:
        cpu = torch.device("cpu")
        monkeypatch.setattr(mh, "maybe_init_from_env", lambda log=None: True)
        monkeypatch.setattr(mh, "global_devices",
                            lambda: [(0, cpu), (1, cpu)])
    rc = main(extra + argv[1:] + ["-output", "o"])
    err = capsys.readouterr().err
    assert rc == 1 and "not yet ported" not in err
    want = ("ERROR: -mesh 1x1 must use all 2 devices of the multi-host "
            "slice (e.g. -mesh 2x1).") if env else \
        "ERROR: -mesh 1x2 needs 2 devices; 1 available."
    assert err.splitlines()[-1] == want


def test_cuda_platform_without_card_raises(monkeypatch):
    from merfin_tpu_torch.device import get_device

    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        get_device()
    monkeypatch.setenv("MERFIN_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        get_device()
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    assert get_device().type == "cpu"
