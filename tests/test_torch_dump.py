"""-dump: the merfin_tpu_torch CLI on the CPU vs the JAX CLI
(bin/merfin-tpu) on the CPU, and vs tests/refmodel.py:dump_mode.

Both take positional values from their gather tables.  The rows file and stderr
must be byte-identical (for a .gz output, its decompressed rows: gzip
stamps each member with the time), and so must the exactness counters.
Worlds as in tests/test_torch_hist.py: the recipe's, k=21 with a -prob
table (u32 fetch) and k=20 with palindromes (f64 fetch), both with a
repeat and short scaffolds (packed groups)."""

import gzip
import io
import os
import subprocess

import pytest

import chip_smoke as cs
from tests.test_torch_hist import WORLDS, _env


@pytest.mark.parametrize("name,variant", [
    ("recipe", "plain"), ("k21", "plain"), ("k20", "plain"),
    ("k21", "gz"), ("k20", "skipMissing"),
])
def test_dump_port_matches_jax_cli(name, variant, tmp_path):
    world = WORLDS[name]()
    argv = cs.mode_argv(cs.materialize(world, str(tmp_path)), "dump")
    out = "out.dump.gz" if variant == "gz" else "out.dump"
    extra = ["-skipMissing"] if variant == "skipMissing" else []
    procs = {}
    for tag, pkg in (("port", "merfin_tpu_torch"), ("jax", "merfin_tpu")):
        cwd = tmp_path / tag
        cwd.mkdir()
        procs[tag] = subprocess.Popen(
            cs.counted_cli(pkg) + argv + extra + ["-output", out], cwd=cwd,
            env=_env(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    res = {}
    for tag, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (tag, stderr[-3000:])
        res[tag] = (stderr, stdout.splitlines()[-1])
    assert res["port"] == res["jax"]

    files = [tmp_path / tag / out for tag in ("port", "jax")]
    if variant == "skipMissing":
        assert not any(f.exists() for f in files)
        return
    rows = [f.read_bytes() for f in files]
    if variant == "gz":
        assert all(r[:2] == b"\x1f\x8b" for r in rows)
        rows = [gzip.decompress(r) for r in rows]
    assert rows[0] == rows[1]
    assert rows[0] == cs.oracle_dump(world)
    if name == "recipe":
        assert rows[0].count(b"\n") == 1986
        assert "chr1\t45\t45\t1986" in res["port"][0].splitlines()


@pytest.mark.parametrize("k", [21, 20])
def test_dump_stream_path_matches_jax_engine(k, tmp_path):
    """Both packages' run_dump at a 4096-window chunk, so the long
    scaffold takes the chunk stream (2 steps in flight) and the short
    ones pack into groups of the same capacity, on the gather tables:
    the port's are the JAX tables carried across by convert.py.  The A
    homopolymer holds an N run and the reads count the poly-A mer (key
    0) past the value map's cap, so the invalid windows the gather steps
    probe (the Ns read as A) add to the overflow count.  Rows, stderr
    and the count equal; no union table is built."""
    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.io.prob import load_prob_table
    from merfin_tpu.modes.dump import run_dump as jax_run_dump
    from merfin_tpu.modes.engine import KstarEngine as JaxEngine
    from merfin_tpu.table.lookup import build_lookup
    from merfin_tpu_torch import convert
    from merfin_tpu_torch.modes.dump import run_dump
    from merfin_tpu_torch.modes.engine import KstarEngine

    world = cs.parity_world(6, 40_000, k=k, repeat=5_000)
    name, asm = world["scaffolds"][0]
    at = asm.index("A" * 5_000) + 2_000
    world["scaffolds"][0] = (name, asm[:at] + "N" * 5 + asm[at + 5:])
    world["read_counts"] = {"A" * k: 4_200_000}
    argv = cs.materialize(world, str(tmp_path))
    rdb, adb = KmerDB(argv[4]), KmerDB(argv[6])
    prob = load_prob_table(argv[argv.index("-prob") + 1], log=io.StringIO())
    kw = dict(prob_table=prob, chunk=4096, exact_max=True,
              max_value=int(rdb.vals.max()), asm_max_value=int(adb.vals.max()))
    jl = build_lookup(rdb), build_lookup(adb)
    port = KstarEngine(*(convert.device_lookup_from_jax(x, "cpu") for x in jl),
                       k, 2.0, **kw)
    ref = JaxEngine(*jl, k, 2.0, **kw)
    assert not port.sortjoin and port.table is None
    assert (port.batch, port.dump_group_capacity) == (
        ref.batch, ref.dump_group_capacity)
    assert not port._fetch32()
    out = {}
    for tag, eng, fn in (("port", port, run_dump), ("jax", ref, jax_run_dump)):
        log = io.StringIO()
        fn(eng, SeqFile(argv[2]), str(tmp_path / f"{tag}.dump"), log=log)
        out[tag] = ((tmp_path / f"{tag}.dump").read_bytes(), log.getvalue(),
                    eng.overflow_values)
    assert out["port"] == out["jax"]
    assert out["port"][2] > 5_000        # the poly-A windows, N ones too
    assert out["port"][0] == cs.oracle_dump(world)


def test_dump_resume_continues_exactly(tmp_path):
    """An interrupted -dump resumed with -resume ends with the same rows
    file as an uninterrupted run, each sequence's line logged once."""
    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.modes.dump import run_dump
    from merfin_tpu_torch.modes.engine import KstarEngine

    world = cs.parity_world(4, 30_000, k=21)
    argv = cs.materialize(world, str(tmp_path))
    fasta = argv[2]

    def engine():
        return KstarEngine(
            build_lookup(KmerDB(argv[4]), device="cpu"),
            build_lookup(KmerDB(argv[6]), device="cpu"), 21, 2.0,
            chunk=4096, batch=2)

    def dump_lines(log):
        return [ln for ln in log.getvalue().splitlines()
                if ln.count("\t") == 3]

    full_log = io.StringIO()
    run_dump(engine(), SeqFile(fasta), str(tmp_path / "full.dump"),
             log=full_log)

    class Interrupted(SeqFile):
        def iter_coded(self, window=None):
            for i, s in enumerate(super().iter_coded(window)):
                if i == 12:
                    raise KeyboardInterrupt
                yield s

    out = str(tmp_path / "resumed.dump")
    first = io.StringIO()
    with pytest.raises(KeyboardInterrupt):
        run_dump(engine(), Interrupted(fasta), out, log=first, resume=True)
    assert os.path.exists(out + ".ckpt.json")
    log = io.StringIO()
    run_dump(engine(), SeqFile(fasta), out, log=log, resume=True)
    assert "-- Resuming after" in log.getvalue()
    assert not os.path.exists(out + ".ckpt.json")
    assert (tmp_path / "full.dump").read_bytes() == open(out, "rb").read()
    done = dump_lines(first)
    assert 0 < len(done) < len(dump_lines(full_log))
    assert done + dump_lines(log) == dump_lines(full_log)


def test_dump_group_and_stream_paths_agree(tmp_path):
    """The same sequences through one packed group and one at a time
    through the chunk stream give the same values and counts."""
    import numpy as np

    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.kcore.pack import encode_bases
    from merfin_tpu_torch.table.lookup import build_lookup
    from merfin_tpu_torch.modes.engine import KstarEngine

    world = cs.parity_world(5, 20_000, k=20)
    argv = cs.materialize(world, str(tmp_path))
    eng = KstarEngine(build_lookup(KmerDB(argv[4]), device="cpu"),
                      build_lookup(KmerDB(argv[6]), device="cpu"), 20, 2.0,
                      chunk=1024, batch=2)
    seqs, used = [], 0
    for _, s in world["scaffolds"][1:]:
        if used + len(s) + 19 <= eng.dump_group_capacity:
            seqs.append(encode_bases(s))
            used += len(s) + 19
    assert len(seqs) >= 3 and any(len(c) > 1024 for c in seqs)
    for (r, a, m, kasm, kmis), c in zip(eng.dump_group(seqs), seqs):
        parts = list(eng.dump_sequence(c))
        assert [p[0] for p in parts] == list(range(0, len(parts) * 1024,
                                                   1024))
        for got, want in zip((r, a, m), zip(*[p[1:4] for p in parts])):
            np.testing.assert_array_equal(got, np.concatenate(want))
        assert (kasm, kmis) == (sum(p[4] for p in parts),
                                sum(p[5] for p in parts))
