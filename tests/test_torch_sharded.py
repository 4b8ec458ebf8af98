"""The port's multi-device modules (``merfin_tpu_torch/parallel/``, the
mesh -completeness, ``ShardedScorer`` and the CLI's ``-mesh``) against
the JAX package's on the CPU: 8 logical devices on each side
(``MERFIN_CPU_DEVICES=8``; tests/conftest.py's 8 virtual XLA devices).

The same seeded inputs go through both.  Every comparison is exact
(integers, output bytes, stderr lines) except where a tolerance is
named: kover's float fallback sum to 1e-15 relative and the f64 totdk of
the -prob scorer to 1e-9 relative.
"""

import io
import json
import math
import os
import random
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from merfin_tpu.io.mkdb import KmerDB as JKmerDB
from merfin_tpu.kcore.pack import encode_bases
from merfin_tpu.modes.completeness import run_completeness as j_compl
from merfin_tpu.parallel import engine as j_engine
from merfin_tpu.parallel import multichip as j_mc
from merfin_tpu.parallel import sharded as j_sh
from merfin_tpu.score.value_map import ValueMap as JValueMap
from merfin_tpu.variants import device_score as j_ds
from merfin_tpu.variants.score import dispatch_blocks
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.modes.completeness import run_completeness as p_compl
from merfin_tpu_torch.modes.engine import zero_hist_state
from merfin_tpu_torch.parallel import engine as p_engine
from merfin_tpu_torch.parallel import multichip as p_mc
from merfin_tpu_torch.parallel import sharded as p_sh
from merfin_tpu_torch.score.value_map import ValueMap
from merfin_tpu_torch.variants import device_score as p_ds
from tests import refmodel
from tests.test_torch_device_score import PROB, _Capture, _world
from tests.util import db_from_dict, random_dna

K = 9


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    """8 logical CPU devices; one intra-op thread (the test workers share
    the cores)."""
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    monkeypatch.setenv("MERFIN_CPU_DEVICES", "8")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(n=8, data=None):
    return j_sh.make_mesh(n, data=data), p_sh.make_mesh(n, data=data)


def _both(path):
    return JKmerDB(path), KmerDB(path)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """test_sharded.py's world: two scaffolds, reads at 3x plus noise."""
    tmp = tmp_path_factory.mktemp("tsharded")
    rng = random.Random(7)
    scaf = [random_dna(rng, 500) for _ in range(2)]
    reads = scaf * 3 + [random_dna(rng, 200)]
    db_from_dict(refmodel.count_canonical(reads, K), K, str(tmp / "r"))
    db_from_dict(refmodel.count_canonical(scaf, K), K, str(tmp / "a"))
    return str(tmp / "r"), str(tmp / "a"), scaf


@pytest.fixture(scope="module")
def hostile_world(tmp_path_factory):
    """test_sharded.py:hostile_world: read values above the value map's
    cap (max_value=1) and an asm value above the bin table's range."""
    tmp = tmp_path_factory.mktemp("thostile")
    rng = random.Random(11)
    scaf = random_dna(rng, 600)
    mers = sorted(refmodel.count_canonical([scaf], K))
    read_counts = {m: (5, 12, 200)[i % 3] for i, m in enumerate(mers)}
    asm_counts = {m: 1 for m in mers}
    asm_counts[mers[0]] = 9000
    read_counts[mers[0]] = 12
    db_from_dict(read_counts, K, str(tmp / "r"))
    db_from_dict(asm_counts, K, str(tmp / "a"))
    return str(tmp / "r"), str(tmp / "a"), [scaf]


@pytest.mark.parametrize("n,data", [(None, None), (8, 2), (6, None),
                                    (4, None), (1, None), (8, 1)])
def test_make_mesh_matches_jax(n, data):
    jm, pm = _meshes(n, data)
    assert pm.shape == dict(jm.shape)
    assert pm.devices.size == jm.devices.size and not pm.spans_hosts


def test_make_mesh_grids():
    """An explicit device list takes the data rule; a 2-D grid is the
    mesh; a grid may repeat one device."""
    cpu = torch.device("cpu")
    assert p_sh.make_mesh(devices=[cpu] * 8, data=2).shape == {"d": 2, "t": 4}
    assert p_sh.make_mesh(devices=[[cpu] * 3] * 2).shape == {"d": 2, "t": 3}
    with pytest.raises(ValueError):
        p_sh.make_mesh(devices=[cpu] * 6, data=4)


def test_partition_rows_matches_jax():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(1000, size=37, replace=False)).astype(np.uint64)
    vals = (np.arange(37) + 1).astype(np.uint32)
    for shards in (1, 4, 8):
        for a, b in zip(j_sh.partition_rows(keys, vals, shards),
                        p_sh.partition_rows(keys, vals, shards)):
            np.testing.assert_array_equal(a, b)


def _filter_db(tmp_path):
    """A DB whose -min 2 -max 3 filter empties its 4th of 8 shards."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 18, size=3000, dtype=np.uint64))
    vals = rng.integers(1, 6, size=keys.size).astype(np.uint32)
    n = keys.size
    vals[round(3 * n / 8): round(4 * n / 8)] = 1
    JKmerDB.create(str(tmp_path / "f"), K, keys, vals)
    return str(tmp_path / "f"), keys, vals


@pytest.mark.parametrize("fmt", ["plane", "rec"])
@pytest.mark.parametrize("filt", [False, True])
def test_lookup_np_matches_jax(fmt, filt, tmp_path):
    path, keys, vals = _filter_db(tmp_path)
    jdb, pdb = _both(path)
    lim = dict(min_v=2, max_v=3) if filt else {}
    jm, pm = _meshes(8, data=1)
    jl = j_sh.ShardedLookup.build(jdb, jm, fmt=fmt, **lim)
    pl = p_sh.ShardedLookup.build(pdb, pm, **lim)
    assert pl.n == jl.n
    if filt:
        assert [t.n for s in pl.shards for t in s.values()][3] == 0
    rng = np.random.default_rng(4)
    q = np.concatenate([keys, rng.integers(0, 1 << 18, size=999,
                                           dtype=np.uint64),
                        np.asarray([0, 2**64 - 1], np.uint64)])
    q = q[rng.permutation(q.size)]
    got = pl.lookup_np(q)
    np.testing.assert_array_equal(got, jl.lookup_np(q))
    want = np.zeros(q.size, np.uint64)
    idx = np.searchsorted(keys, q).clip(0, keys.size - 1)
    hit = keys[idx] == q
    keep = (vals >= 2) & (vals <= 3) if filt else np.ones(keys.size, bool)
    want[hit] = np.where(keep[idx[hit]], vals[idx[hit]], 0)
    np.testing.assert_array_equal(got, want)
    assert pl.lookup_np(q[:4].reshape(2, 2)).shape == (2, 2)


def test_lookup_rows_and_replicated(dbs):
    path = dbs[0]
    pdb = KmerDB(path)
    mesh = p_sh.make_mesh(8, data=2)
    sl = p_sh.ShardedLookup.build(pdb, mesh)
    keys, vals = np.asarray(pdb.keys), np.asarray(pdb.vals)
    q = torch.from_numpy(np.concatenate([keys[::-7], keys[:5]]).view(np.int64))
    np.testing.assert_array_equal(sl.lookup(q).numpy(),
                                  np.concatenate([vals[::-7], vals[:5]]))
    rows = sl.lookup_sharded([q[:10], q[10:20]])
    np.testing.assert_array_equal(torch.cat(rows).numpy(),
                                  sl.lookup(q[:20]).numpy())


def _engines(world, chunk=256, **kw):
    rpath, apath, _ = world
    (jr, pr), (ja, pa) = _both(rpath), _both(apath)
    jm, pm = _meshes(8, data=2)
    je = j_engine.ShardedKstarEngine(
        jm, j_sh.ShardedLookup.build(jr, jm), j_sh.ShardedLookup.build(ja, jm),
        K, 3.0, chunk=chunk, **kw)
    pe = p_engine.ShardedKstarEngine(
        pm, p_sh.ShardedLookup.build(pr, pm),
        p_sh.ShardedLookup.build(pa, pm), K, 3.0, chunk=chunk, **kw)
    return je, pe


def test_hist_step_matches_jax(dbs):
    """One batch of two chunk rows through make_hist_step (transfer-packed
    input, test_sharded.py's batch) on both sides: all 12 state
    entries."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from merfin_tpu.kcore.pack import pack_transfer_np

    je, pe = _engines(dbs)
    chunk = 256
    codes = encode_bases(dbs[2][0])
    b = np.full((2, chunk + K - 1), 4, dtype=np.uint8)
    b[0, :] = codes[: chunk + K - 1]
    piece = codes[chunk: 2 * chunk + K - 1]
    b[1, : piece.shape[0]] = piece
    planes, vbits = pack_transfer_np(b)
    sh = NamedSharding(je.mesh, P("d", None))
    jstate = je._step(j_mc.zero_hist_state(),
                      jax.device_put(planes, sh), jax.device_put(vbits, sh))
    pstate = zero_hist_state(pe.nbins, pe.bin_table.amax, pe.kover_vmaxp,
                             "cpu")
    pe._step(pstate, p_sh.put_global(planes, pe.mesh),
             p_sh.put_global(vbits, pe.mesh))
    for i, (j, p) in enumerate(zip(jstate, pstate)):
        if i == 2:
            assert float(p) == pytest.approx(float(j), rel=1e-15)
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert int(pstate[0]) > 0


@pytest.mark.parametrize("name", ["dbs", "hostile"])
def test_sharded_engine_matches_jax(name, dbs, hostile_world):
    """ShardedKstarEngine: hist_sequence, the packed group, dump_sequence
    and the exactness counters on both sides."""
    world = dbs if name == "dbs" else hostile_world
    kw = dict(max_value=1) if name == "hostile" else {}
    je, pe = _engines(world, **kw)
    seqs = [encode_bases(s) for s in world[2]]
    codes = encode_bases("N".join(world[2]))
    js, ju, jo = je.hist_sequence(codes)
    ps, pu, po = pe.hist_sequence(codes)
    assert (ps.kasm, ps.kmissing) == (js.kasm, js.kmissing)
    assert ps.kover_cpy == pytest.approx(js.kover_cpy, rel=1e-15)
    np.testing.assert_array_equal(pu, ju)
    np.testing.assert_array_equal(po, jo)
    # a packed group within one batch's capacity (2 rows of 256)
    frags = [c[i: i + 97] for c in seqs for i in range(0, c.size, 97)][:4]
    jg, pg = je.hist_group(frags), pe.hist_group(frags)
    assert [(s.kasm, s.kmissing) for s in pg[0]] == \
        [(s.kasm, s.kmissing) for s in jg[0]]
    for a, b in zip(pg[1:3], jg[1:3]):
        np.testing.assert_array_equal(a, b)
    assert pg[3] == pytest.approx(jg[3], rel=1e-15)
    got, want = list(pe.dump_sequence(codes)), list(je.dump_sequence(codes))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[4:] == w[4:]
        for a, b in zip(g[1:4], w[1:4]):
            np.testing.assert_array_equal(a, b)
    for c in cs.COUNTERS:
        assert getattr(pe, c) == getattr(je, c), c
    if name == "hostile":
        assert pe.overflow_values > 0 and pe.bin_fallbacks > 0


def test_sharded_engine_grows_bins(tmp_path):
    """A high-copy repeat grows the mesh engine's bins (test_sharded_
    engine.py:test_sharded_hist_bin_growth) through run_hist."""
    from merfin_tpu.io.fasta import SeqFile as JSeqFile
    from merfin_tpu.modes.hist import run_hist as j_hist
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.modes.hist import run_hist

    rng = random.Random(31)
    f1, f2 = random_dna(rng, 100), random_dna(rng, 100)
    asm = f1 + "A" * (9_000 + K - 1) + f2
    db_from_dict(refmodel.count_canonical([f1 + "A" * K + f2] * 4, K), K,
                 str(tmp_path / "r"))
    db_from_dict(refmodel.count_canonical([asm], K), K, str(tmp_path / "a"))
    (tmp_path / "asm.fasta").write_text(">chr\n" + asm + "\n")
    je, pe = _engines((str(tmp_path / "r"), str(tmp_path / "a"), None),
                      chunk=4096)
    fa = str(tmp_path / "asm.fasta")
    logs = [io.StringIO(), io.StringIO()]
    res = [j_hist(je, JSeqFile(fa), str(tmp_path / "j.hist"), log=logs[0]),
           run_hist(pe, SeqFile(fa), str(tmp_path / "p.hist"), log=logs[1])]
    assert pe.nbins == je.nbins > 1 << 14
    # the kover float fallback sums its windows in another order: the
    # printed lines and the counters are equal, the floats to 1e-12
    assert logs[0].getvalue() == logs[1].getvalue()
    for key, val in res[0].items():
        assert res[1][key] == pytest.approx(val, rel=1e-12), key
    for c in cs.COUNTERS:
        assert getattr(pe, c) == getattr(je, c), c
    assert pe.kover_fallbacks > 0
    assert (tmp_path / "j.hist").read_bytes() == \
        (tmp_path / "p.hist").read_bytes()


@pytest.fixture(scope="module")
def mode_world(tmp_path_factory):
    """test_mesh_modes.py's world: 800 bp, 3 errors, a spurious call."""
    tmp = tmp_path_factory.mktemp("tmeshmodes")
    rng = random.Random(77)
    g = random_dna(rng, 800)
    asm = list(g)
    errs = [120, 430, 600]
    for p in errs:
        asm[p] = cs.ALT_OF[asm[p]]
    asm = "".join(asm)
    db_from_dict(refmodel.count_canonical([g] * 25, 11), 11,
                 str(tmp / "read"))
    db_from_dict(refmodel.count_canonical([asm], 11), 11, str(tmp / "asm"))
    (tmp / "asm.fasta").write_text(">chr1\n" + asm + "\n")
    rows = sorted([(p + 1, asm[p], g[p], 31.5) for p in errs]
                  + [(250, asm[249], cs.ALT_OF[asm[249]], 9.1)])
    (tmp / "calls.vcf").write_text(
        "##fileformat=VCFv4.2\n##contig=<ID=chr1>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        + "".join(f"chr1\t{p}\t.\t{r}\t{a}\t{q}\tPASS\t.\tGT\t1/1\n"
                  for p, r, a, q in rows))
    return tmp


def _rec_format(monkeypatch):
    orig = j_sh.ShardedLookup.build.__func__
    monkeypatch.setattr(j_sh.ShardedLookup, "build", classmethod(
        lambda cls, *a, **kw: orig(cls, *a, **{**kw, "fmt": "rec"})))


@pytest.mark.parametrize("case", ["plane", "rec", "u16_readk", "peak_zero"])
def test_completeness_mesh_matches_jax(case, mode_world, tmp_path,
                                       monkeypatch):
    """-completeness on a 2x4 mesh: the per-slice lines and totals of
    JAX's mesh run, and of the port's single-device run (test_mesh_modes.
    py:54-63, 168-222)."""
    if case == "rec":
        _rec_format(monkeypatch)
    if case in ("plane", "rec"):
        paths, peak = (str(mode_world / "read"), str(mode_world / "asm")), 25.0
    else:
        k = 5
        canon = [min(s, refmodel.revcomp(s))
                 for s in ("ACGTA", "GGATC", "TTACG")]
        counts = [50, 100, 7] if case == "u16_readk" else [9, 0, 0]
        db_from_dict({c: v for c, v in zip(canon, counts) if v}, k,
                     str(tmp_path / "r"))
        db_from_dict({c: 1 for c, v in zip(canon, counts) if v}, k,
                     str(tmp_path / "a"))
        paths = (str(tmp_path / "r"), str(tmp_path / "a"))
        peak = 0.1 if case == "u16_readk" else 0.0
    (jr, pr), (ja, pa) = _both(paths[0]), _both(paths[1])
    logs = [io.StringIO() for _ in range(3)]
    res = [j_compl(jr, ja, peak, log=logs[0], mesh=j_sh.make_mesh(8, data=2),
                   block=64),
           p_compl(pr, pa, peak, log=logs[1], mesh=p_sh.make_mesh(8, data=2),
                   block=64),
           p_compl(pr, pa, peak, log=logs[2], device="cpu")]
    if case == "peak_zero":
        assert all(math.isnan(r["completeness"]) for r in res)
        assert all(math.isinf(r["total"]) or math.isnan(r["total"])
                   for r in res)
    else:
        assert res[0] == res[1] == res[2]
        assert logs[0].getvalue() == logs[1].getvalue() == logs[2].getvalue()
    if case == "u16_readk":
        assert res[1]["total"] == 500 + 1000 + 70
        assert res[1]["undrc"] == 499 + 999 + 69


@pytest.mark.parametrize("k", [11, 12])
@pytest.mark.parametrize("with_prob", [False, True])
def test_sharded_scorer_matches_jax(k, with_prob, tmp_path):
    """ShardedScorer on a 2x4 mesh: num_m exactly, totdk exactly on the
    integer path and to 1e-9 relative with a -prob table."""
    rdb, adb, blocks = _world(k, 4 + k, tmp_path)
    prob = PROB if with_prob else None
    kw = dict(max_value=int(rdb.vals.max()), exact_max=True)
    jm, pm = _meshes(8, data=2)
    js = j_ds.ShardedScorer(jm, j_sh.ShardedLookup.build(rdb, jm),
                            j_sh.ShardedLookup.build(adb, jm), k, 30.0, prob,
                            **kw)
    ps = p_ds.ShardedScorer(pm, p_sh.ShardedLookup.build(KmerDB(rdb.path), pm),
                            p_sh.ShardedLookup.build(KmerDB(adb.path), pm),
                            k, 30.0, prob, **kw)
    stream = dispatch_blocks(blocks, _Capture(), k)[1]
    nm, td = ps.score_paths(*stream)
    jnm, jtd = js.score_paths(*stream)
    np.testing.assert_array_equal(nm, jnm)
    assert (nm > 0).any() and (nm == 0).any()
    if with_prob:
        np.testing.assert_allclose(td, jtd, rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(td, jtd)
    assert ps.overflow_values == js.overflow_values


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """A k=21 parity world (a -prob table, a VCF) cut to its long scaffold
    and 3 short ones: the mesh -dump runs one padded batch a sequence."""
    tmp = tmp_path_factory.mktemp("tmeshcli")
    world = cs.parity_world(6, 30_000, k=21)
    world["scaffolds"] = world["scaffolds"][:4]
    keep = {name for name, _ in world["scaffolds"]}
    world["vcf"] = [row for row in world["vcf"] if row[0] in keep]
    return cs.materialize(world, str(tmp)), tmp


def _jax_cli(argv, cwd, out):
    """The JAX CLI in a process of its own on 8 virtual XLA devices ->
    (stderr, counters of its engine)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               MERFIN_TPU_CACHE=str(cwd / "jax_cache"))
    proc = subprocess.run(cs.counted_cli("merfin_tpu") + argv
                          + ["-output", out], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr, json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("mode", ["hist", "dump", "completeness", "polish",
                                  "filter", "better", "polish_host"])
def test_cli_mesh_matches_jax_and_single(mode, cli_world, tmp_path):
    """-mesh 2x4 through the port's CLI: output bytes and stderr equal to
    the JAX CLI's -mesh 2x4 run (but for the line naming the fused scorer,
    which the port takes for -polish -prob), output bytes equal to the
    port's single-device run, and the exactness counters equal."""
    argv, _ = cli_world
    base = mode.split("_")[0]
    if base in ("hist", "dump", "completeness"):
        run = cs.mode_argv(argv, base)
        out = output = "out." + base
    else:
        run = cs.vcf_argv(argv, base) + ["-threads", "1"]
        out = "out"
        output = f"out.{'polish' if base == 'polish' else 'filter'}.vcf"
    if mode == "polish_host":
        run = run + ["-nodevscore"]
    mesh = run + ["-mesh", "2x4"]
    got, err, counters = cs.run_port_inprocess(
        mesh, str(tmp_path / "port"), out=out, output=output)
    one, err1, counters1 = cs.run_port_inprocess(
        run, str(tmp_path / "one"), out=out, output=output)
    (tmp_path / "jax").mkdir()
    jerr, jcounters = _jax_cli(mesh, tmp_path / "jax", out)
    jout = cs._read_output(str(tmp_path / "jax"), output)
    assert got == jout == one
    if mode == "polish" and "-prob" in run:
        # -polish -prob: the port's fused scorer, the JAX CLI's host one
        fused = "-- Using fused device scoring (-devscore).\n"
        assert fused in err and fused not in jerr
        err = err.replace(fused, "", 1)
    assert err == jerr
    assert "-- Sharding tables over a 2x4 device mesh." in err
    assert counters == jcounters
    if base in ("hist", "dump"):
        assert counters == counters1 and len(got) > 0
    if base == "completeness":
        assert cs.completeness_lines(err) == cs.completeness_lines(err1)


def test_cli_mesh_validation(cli_world, capsys, monkeypatch):
    """The JAX CLI's -mesh errors (test_mesh_modes.py:155-165) and its
    per-device memory fail-fast with the -mesh hint (:119-132)."""
    from merfin_tpu_torch import cli

    argv = cs.mode_argv(cli_world[0], "hist") + ["-output", "h"]
    monkeypatch.chdir(cli_world[1])
    assert cli.merfin_main(argv + ["-mesh", "nonsense"]) == 1
    assert "is not DxT (e.g. 2x4)." in capsys.readouterr().err
    assert cli.merfin_main(argv + ["-mesh", "9x9"]) == 1
    assert "ERROR: -mesh 9x9 needs 81 devices; 8 available." in \
        capsys.readouterr().err
    monkeypatch.setattr(cli, "_device_hbm_gb", lambda device: 1e-6)
    assert cli.merfin_main(argv) == 1
    err = capsys.readouterr().err
    assert "GB per device" in err and "-mesh 1x8 (up to 8 devices" in err
    assert cli.merfin_main(argv + ["-mesh", "2x4"]) == 1
    assert "Increase the -mesh table axis" in capsys.readouterr().err
