"""Card-only tests of the torch port (marker ``gpu``): each CUDA kernel
(union_join, sorted_join, window_join, and the earlier binary search and
stream designs) vs its plain version on random tables, on the windowed
joins' edge cases and on window tables whose keys repeat, -hist,
-completeness, -dump and the variant modes on CUDA vs on the CPU, the
fused variant scorer on CUDA vs on the CPU, the counter's device
accumulator and device step vs the numpy counter, the sharded tables'
probes (one sorted_join launch a shard, never the plain version), and
-mesh 1x1 on the card vs -mesh 2x4 on 8 logical CPU devices.

They skip where torch.cuda.is_available() is false.  This file imports
no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table_and_queries(rng, k, n_read, n_asm, m, n_sentinel):
    hi = np.iinfo(np.uint64).max if k == 32 else 1 << (2 * k)
    rk = np.unique(rng.integers(0, hi, size=n_read, dtype=np.uint64))
    rv = rng.integers(1, 1 << 31, size=rk.size).astype(np.uint32) * 2
    ak = np.unique(np.concatenate([rk[::3], rng.integers(
        0, hi, size=n_asm, dtype=np.uint64)]))
    av = rng.integers(1, 9, size=ak.size).astype(np.uint32)
    q = np.sort(np.concatenate([
        rk[rng.integers(0, rk.size, size=m // 3)],
        ak[rng.integers(0, ak.size, size=m // 3)],
        rng.integers(0, hi, size=m - 2 * (m // 3) - n_sentinel,
                     dtype=np.uint64),
        np.full(n_sentinel, U64_MAX)]))
    return (rk, rv, ak, av), q


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(21, (1 << 16) - 5), (32, 1 << 16), (15, 1)])
def test_kernel_matches_plain(cuda, k, m):
    from merfin_tpu_torch.ops.union_join import UnionTable, union_join_kernel

    rng = np.random.default_rng(k)
    dbs, q = _table_and_queries(rng, k, 200_000, 50_000, m,
                                min(999, m // 4))
    table = UnionTable.from_dbs(*dbs, cuda)
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    before = union_join_kernel.launches
    got = table.lookup2_sorted(qt)
    want = table.lookup2_plain(qt)
    torch.cuda.synchronize()
    assert union_join_kernel.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the plain version on the CPU agrees with both
    cpu = UnionTable.from_dbs(*dbs, "cpu").lookup2_sorted(qt.cpu())
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["sorted_join", "window_join"])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_single_value_kernels_match_plain(cuda, route, k):
    from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
    from merfin_tpu_torch.ops.window_join import SortJoinTable

    cls = SortedJoinTable if route == "sorted_join" else SortJoinTable
    rng = np.random.default_rng(k)
    keys = np.unique(rng.integers(0, 1 << (2 * k), size=300_000,
                                  dtype=np.uint64))
    vals = rng.integers(0, 1 << 32, size=keys.size).astype(np.uint32)
    m = (1 << 17) - 3
    q = np.sort(np.concatenate([
        keys[rng.integers(0, keys.size, size=m // 2)],
        rng.integers(0, 1 << (2 * k), size=m - m // 2 - 500,
                     dtype=np.uint64),
        np.full(500, U64_MAX)]))
    table = cls(keys, vals, cuda)
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    before = table.kernel.launches
    got = table.lookup_sorted(qt)
    want = table.lookup_plain(qt)
    torch.cuda.synchronize()
    assert table.kernel.name == route
    assert table.kernel.launches == before + 1
    assert torch.equal(got, want)
    cpu = cls(keys, vals, "cpu").lookup_sorted(qt.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["completeness", "dump"])
def test_modes_cuda_match_cpu(cuda, mode, tmp_path, monkeypatch):
    """-completeness and -dump on the repeat world give the same output,
    stderr and counters on CUDA as on the CPU."""
    import chip_smoke as cs

    world = cs.parity_world(3, 60_000, k=21, repeat=40_000)
    argv = cs.mode_argv(cs.materialize(world, str(tmp_path)), mode)
    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    got = cs.run_port_inprocess(argv, str(tmp_path / "cuda"), out="out")
    want = cs.run_port_subprocess(argv, str(tmp_path), "cpu", out="out")
    assert got == want
    if mode == "dump":
        assert got[0].count(b"\n") > 100_000
    else:
        assert "COMPLETENESS" in got[1]


@pytest.mark.gpu
def test_hist_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The repeat world (fallback bins, kover fallback, bin growth,
    packed groups, even k) gives the same hist file, stderr and
    counters on CUDA as on the CPU."""
    import chip_smoke as cs

    world = cs.parity_world(3, 60_000, k=20, repeat=40_000)
    argv = cs.materialize(world, str(tmp_path))
    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    got = cs.run_port_inprocess(argv, str(tmp_path / "cuda"))
    want = cs.run_port_subprocess(argv, str(tmp_path), "cpu")
    assert got == want
    assert got[2]["bin_fallbacks"] > 0


@pytest.mark.gpu
def test_variant_modes_cuda_match_cpu(cuda, tmp_path, monkeypatch):
    """Every variant mode and -polish on the host scorer, on the recipe
    world and a k=21 -prob world: the same VCF and stderr on CUDA as in
    a CPU process (chip_smoke's phase 4 check at another seed)."""
    import chip_smoke as cs

    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    cs.check_small_variants(str(tmp_path), 3, 60_000, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("with_prob", [False, True])
def test_device_scorer_cuda_matches_cpu(cuda, with_prob, tmp_path):
    """The fused scorer on CUDA vs on the CPU over heavy-cluster blocks
    split into several spans: num_m exactly, the integer totdk exactly,
    the f64 totdk (sums in another order on CUDA) to 1e-9 relative; the
    union join ran as the kernel."""
    import chip_smoke as cs
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.variants.enumerate_fast import build_path_block_fast
    from merfin_tpu_torch.variants.score import dispatch_blocks
    from merfin_tpu_torch.ops.union_join import UnionTable, union_join_kernel
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    world = cs.parity_world(5, 60_000, k=21)
    argv = cs.materialize(world, str(tmp_path))
    rdb, adb = KmerDB(argv[4]), KmerDB(argv[6])
    prob = load_prob_table(argv[argv.index("-prob") + 1]) if with_prob \
        else None
    asm = world["scaffolds"][0][1]
    blocks = []
    for base in range(1000, len(asm) - 200, 2500):
        t = asm[base - 20: base + 100]
        if "N" in t:
            continue
        idx = list(range(20, 84, 8))
        haps = [[t[i], cs.ALT_OF[t[i]]] if j % 3 else
                [t[i], cs.ALT_OF[t[i]], cs.ALT_OF[cs.ALT_OF[t[i]]]]
                for j, i in enumerate(idx)]
        blocks.append(build_path_block_fast(t, idx, [1] * len(idx), haps, 21))

    class Capture:
        def dispatch_paths(self, *args):
            return args

    stream = dispatch_blocks(blocks, Capture(), 21)[1]
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        table = UnionTable.from_dbs(rdb.keys, rdb.vals, adb.keys, adb.vals,
                                    dev)
        sc = DeviceScorer(table, 21, 2.0, prob, max_value=int(rdb.vals.max()),
                          exact_max=True)
        sc.MAX_WINDOWS = 1 << 16
        before = union_join_kernel.launches
        out[dev] = sc.score_paths(*stream)
        torch.cuda.synchronize()
        launched[dev] = union_join_kernel.launches - before
    assert launched["cpu"] == 0 and launched["cuda"] > 1, launched
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    if with_prob:
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9,
                                   atol=0)
    else:
        assert out["cuda"][1].dtype == np.int64
        np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_windowed_joins_on_edge_cases(cuda, case):
    """The windowed union and single-value joins, the window join and the
    earlier designs (binary search, stream), each against its plain
    version, on the edge cases of chip_smoke.join_edge_cases at the built
    constants."""
    import chip_smoke as cs
    from merfin_tpu_torch.ops.sorted_join import (SortedJoinTable,
                                                  sorted_join_kernel)
    from merfin_tpu_torch.ops.union_join import (UnionTable,
                                                 bsearch_join_kernel,
                                                 union_join_kernel)
    from merfin_tpu_torch.ops.window_join import (SortJoinTable,
                                                  stream_window_join_kernel)

    cfg = union_join_kernel.config()
    cases = cs.join_edge_cases(np.random.default_rng(case), cfg)
    label, keys, v0, v1, q = cases[case]
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    table = UnionTable(keys, v0, v1, cuda)
    got = table.lookup2_sorted(qt)
    want = table.lookup2_plain(qt)
    old = bsearch_join_kernel(table.keys, table.read_vals, table.asm_vals, qt)
    single = SortedJoinTable(keys, v0, cuda)
    got1 = single.lookup_sorted(qt)
    want1 = single.lookup_plain(qt)
    old1 = bsearch_join_kernel(single.keys, single.vals, None, qt)
    window = SortJoinTable(keys, v0, cuda)
    got_w = window.lookup_sorted(qt)
    old_w = stream_window_join_kernel(window.keys, window.vals, qt)
    torch.cuda.synchronize()
    for g, o, w in zip(got, old, want):
        assert torch.equal(g, w), label
        assert torch.equal(o, w), label
    assert torch.equal(got1, want1) and torch.equal(old1[0], want1), label
    assert torch.equal(got_w, want1) and torch.equal(old_w, want1), label
    assert sorted_join_kernel.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(3))
def test_window_join_on_equal_key_runs(cuda, case):
    """The window join and its earlier stream design against the plain
    version on tables whose keys repeat (chip_smoke.window_edge_cases at
    the built tile, chunk and dense/wide threshold): runs across chunk
    and tile boundaries, a run of 5,000+ keys, wrapping sums, sentinels,
    ragged lengths; bit-exact."""
    import chip_smoke as cs
    from merfin_tpu_torch.ops.window_join import (SortJoinTable,
                                                  stream_window_join_kernel,
                                                  window_join_kernel)

    cfg = window_join_kernel.config()
    cases = cs.window_edge_cases(np.random.default_rng(case), cfg)
    assert len(cases) == 3
    label, keys, vals, q = cases[case]
    assert np.unique(keys).size < keys.size
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    table = SortJoinTable(keys, vals, cuda)
    before = window_join_kernel.launches
    got = table.lookup_sorted(qt)
    want = table.lookup_plain(qt)
    old = stream_window_join_kernel(table.keys, table.vals, qt)
    torch.cuda.synchronize()
    assert window_join_kernel.launches == before + 1
    assert torch.equal(got, want), label
    assert torch.equal(old, want), label
    assert (want != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("k", [21, 32])
def test_device_count_accumulator(cuda, k, overflow, monkeypatch):
    """The counter's device accumulator on the card against the numpy
    counter (_chunk_canonical_counts_np into the host accumulator) over
    a few chunks: collapses of 2 runs at a low minimum capacity, and,
    with a low max_entries, the host overflow; then the budgeted path's
    device step (_count_into) against the same."""
    from merfin_tpu_torch.count.counter import (_Accumulator, _DeviceCountAcc,
                                                _chunk_canonical_counts_np,
                                                _count_into, _packed_chunks)
    from merfin_tpu_torch.io.fasta import CodedSequence

    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    rng = np.random.default_rng(k + overflow)
    chunk = 1 << 14
    codes = []
    for i in range(60):
        c = rng.integers(0, 4, size=int(rng.integers(50, 5000))).astype(np.uint8)
        if i % 4 == 0:
            c[rng.integers(0, c.size, size=5)] = 4
        codes.append(c)
    codes += codes[::3]                    # repeated k-mers: counts > 1

    def seqs():
        return (CodedSequence(f"s{i}", c) for i, c in enumerate(codes))

    dacc = _DeviceCountAcc(k, chunk, collapse_runs=2)
    assert dacc.device.type == "cuda"
    dacc._MIN_CAP = 1 << 10
    if overflow:
        dacc.max_entries = 4 * chunk
    caps = set()
    for buf in _packed_chunks(seqs(), k, chunk):
        dacc.add_codes(buf)
        caps |= set(dacc.buckets)
    assert (dacc._host_keys.size > 0) == overflow
    keys, vals, total = dacc.drain()
    assert len(caps) > 2

    acc = _Accumulator()
    for buf in _packed_chunks(seqs(), k, chunk):
        acc.add(*_chunk_canonical_counts_np(buf, k))
    hk, hv, ht = acc.result()
    np.testing.assert_array_equal(keys, hk)
    np.testing.assert_array_equal(vals, hv)
    assert total == ht and int(hv.max()) > 1
    if k == 32:
        assert int(hk.max()) >= 1 << 63

    step = _Accumulator()
    _count_into(step, seqs(), k, chunk=chunk, use_device=True)
    sk, sv, st = step.result()
    np.testing.assert_array_equal(sk, hk)
    np.testing.assert_array_equal(sv, hv)
    assert st == ht


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_probes_launch_the_kernel(cuda, shape, monkeypatch):
    """Every shard probe of a mesh on the card is one sorted_join launch
    (T a row), never the plain version; -min/-max may empty a shard."""
    from merfin_tpu_torch.ops import sorted_join as sj
    from merfin_tpu_torch.parallel.sharded import ShardedLookup, make_mesh

    def no_plain(*a, **kw):
        raise AssertionError("a shard probe on the card ran the plain version")

    monkeypatch.setattr(sj, "lookup_plain", no_plain)
    monkeypatch.setattr(sj.SortedJoinTable, "lookup_plain", no_plain)
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 42, size=300_000, dtype=np.uint64))
    vals = rng.integers(1, 9, size=keys.size).astype(np.uint32)
    vals[: keys.size // 4] = 1              # the first shard filters empty
    D, T = shape
    mesh = make_mesh(devices=[cuda] * (D * T), data=D)
    sl = ShardedLookup.build((keys, vals, 21), mesh, min_v=2, max_v=7)
    q = np.concatenate([keys[::5], rng.integers(0, 1 << 42, size=9999,
                                                dtype=np.uint64),
                        np.asarray([0, U64_MAX], np.uint64)])
    before = sj.sorted_join_kernel.launches
    got = sl.lookup_np(q)
    torch.cuda.synchronize()
    assert sj.sorted_join_kernel.launches == before + T
    keep = (vals >= 2) & (vals <= 7)
    idx = np.searchsorted(keys, q).clip(0, keys.size - 1)
    want = np.where((keys[idx] == q) & keep[idx], vals[idx], 0)
    np.testing.assert_array_equal(got, want.astype(np.uint64))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["hist", "completeness", "dump", "polish"])
def test_mesh_modes_cuda_match_cpu(cuda, mode, tmp_path, monkeypatch):
    """-mesh 1x1 on the card gives the output and counters of -mesh 2x4
    on 8 logical CPU devices (the repeat world for -hist, -completeness
    and -dump; the -prob VCF world for -polish)."""
    import chip_smoke as cs

    world = cs.parity_world(3, 60_000, k=21,
                            repeat=0 if mode == "polish" else 40_000)
    argv = cs.materialize(world, str(tmp_path))
    argv = cs.vcf_argv(argv, mode) if mode == "polish" else \
        cs.mode_argv(argv, mode)
    out = "out.polish.vcf" if mode == "polish" else "out"
    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    got = cs.run_port_inprocess(argv + ["-mesh", "1x1"],
                                str(tmp_path / "cuda"), out="out",
                                output=out)
    monkeypatch.setenv("MERFIN_CPU_DEVICES", "8")
    cpu = tmp_path / "cpu"
    cpu.mkdir()
    want = cs.run_port_subprocess(argv + ["-mesh", "2x4"], str(cpu), "cpu",
                                  out="out")
    assert got[0] == cs._read_output(str(cpu), out)
    assert got[2] == want[2]
    if mode == "completeness":
        assert cs.completeness_lines(got[1]) == cs.completeness_lines(want[1])
    else:
        assert len(got[0]) > 0
