"""Card-only tests of the torch port (marker ``gpu``): each CUDA kernel
(union_join, sorted_join, window_join, path_sum) vs its plain version on
random tables, on the windowed joins' edge cases and on window tables
whose keys repeat, -hist, -completeness, -dump and the variant modes on
CUDA vs on the CPU (-completeness also through a many-times-wrapped
pinned ring), the fused variant scorer on CUDA (union join and gather
probe) vs on the CPU, the gather tables on CUDA vs HostLookup, the
counter's device accumulator and device step vs the numpy counter, the
sharded tables' probes (one sorted_join launch a shard, never the plain
version), and -mesh 1x1 on the card vs -mesh 2x4 on 8 logical CPU
devices.

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
@pytest.mark.parametrize("part", [1 << 18, 1000], ids=["one_part", "parts"])
def test_completeness_pinned_ring_wraps(cuda, part, tmp_path, monkeypatch):
    """-completeness on CUDA in blocks of 4,096, so its four pinned slots
    are refilled many times (each block copied in one part, or in parts
    of about 1,000 rows), with each block program held up on the host
    and, longer, on the device (a sleep kernel ahead of the next block's
    upload), so that slots come free before their uploads have run: a
    slot refilled before its upload had read it changes the sums (as it
    does with the wait for the slot's event taken out).  The lines equal
    the CPU run's, and every block went through the ring."""
    import io
    import math
    import time

    import chip_smoke as cs
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.modes import completeness as mod
    from merfin_tpu_torch.utils import spans

    world = cs.parity_world(5, 200_000, k=21)
    argv = cs.materialize(world, str(tmp_path))
    read_db = KmerDB(argv[argv.index("-readmers") + 1])
    asm_db = KmerDB(argv[argv.index("-seqmers") + 1])
    block = 4096
    n_blocks = math.ceil(read_db.distinct / block)
    assert n_blocks > 10 * (mod._DEPTH + 2)

    def lines(device):
        log = io.StringIO()
        mod.run_completeness(read_db, asm_db, world["peak"], log=log,
                             block=block, device=device)
        return log.getvalue()

    want = lines("cpu")
    fast = mod.block_stats

    def slow(*args):
        time.sleep(0.0005)
        torch.cuda._sleep(20_000_000)
        return fast(*args)

    monkeypatch.setattr(mod, "block_stats", slow)
    monkeypatch.setattr(mod, "_PART", part)
    spans.clear()
    spans.enable()
    try:
        got = lines(cuda)
    finally:
        spans.disable()
    tot = spans.totals()
    spans.clear()
    assert got == want
    assert tot["completeness.block_upload"]["counts"] == {
        "bytes": 12 * read_db.distinct, "pinned": n_blocks}
    assert tot["completeness.slot_wait"]["calls"] == n_blocks


@pytest.mark.gpu
def test_hist_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The repeat world (fallback bins, kover fallback, bin growth,
    packed groups, even k) gives the same hist file, stderr and
    counters on CUDA as on the CPU, on each route: the CUDA default (the
    union join) against the CPU with -sortjoin, CUDA with -nosortjoin
    against the CPU default (the gather tables)."""
    import chip_smoke as cs

    world = cs.parity_world(3, 60_000, k=20, repeat=40_000)
    argv = cs.materialize(world, str(tmp_path))
    monkeypatch.setenv("MERFIN_PLATFORM", "cuda")
    for cuda_flags, cpu_flags in (([], ["-sortjoin"]), (["-nosortjoin"], [])):
        tag = "".join(cuda_flags)
        got = cs.run_port_inprocess(argv + cuda_flags,
                                    str(tmp_path / f"cuda{tag}"))
        want = cs.run_port_subprocess(argv + cpu_flags,
                                      cs._mkdir(str(tmp_path / f"cpu{tag}")),
                                      "cpu")
        assert got == want, cuda_flags
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
    the f64 totdk (in path order, the path-sum kernel on CUDA) bit for
    bit; the union join ran as the kernel."""
    import chip_smoke as cs
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.variants.enumerate_fast import build_path_blocks
    from merfin_tpu_torch.variants.score import dispatch_blocks
    from merfin_tpu_torch.ops.union_join import union_join_kernel
    from merfin_tpu_torch.table.lookup import DeviceLookup
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
        blocks.append(build_path_blocks([(t, idx, [1] * len(idx), haps)], 21))

    class Capture:
        def dispatch_paths(self, *args):
            return args

    stream = dispatch_blocks(blocks, Capture(), 21)[1]
    out, launched = {}, {}
    for dev, sortjoin in (("cpu", True), ("cuda", True), ("cuda", False)):
        lk = [DeviceLookup(db.keys, db.vals, 21, device=dev)
              for db in (rdb, adb)]
        sc = DeviceScorer(*lk, 21, 2.0, prob, max_value=int(rdb.vals.max()),
                          exact_max=True, sortjoin=sortjoin)
        sc.MAX_WINDOWS = 1 << 16
        before = union_join_kernel.launches
        out[dev, sortjoin] = sc.score_paths(*stream)
        torch.cuda.synchronize()
        launched[dev, sortjoin] = union_join_kernel.launches - before
        assert any(x.placed for x in lk) == (not sortjoin)
    assert launched == {("cpu", True): 0, ("cuda", False): 0,
                        ("cuda", True): launched["cuda", True]}
    assert launched["cuda", True] > 1, launched
    for key in (("cuda", True), ("cuda", False)):
        np.testing.assert_array_equal(out[key][0], out["cpu", True][0])
        if with_prob:
            assert out[key][1].tobytes() == out["cpu", True][1].tobytes()
        else:
            assert out[key][1].dtype == np.int64
            np.testing.assert_array_equal(out[key][1], out["cpu", True][1])


@pytest.mark.gpu
@pytest.mark.parametrize("paths", [1, 1000, 70_000])
def test_path_sum_kernel_matches_cpu_order(cuda, paths):
    """csrc/path_sum.cu vs the plain version (getTotdK's order) bit for
    bit: paths of 0 to 400 windows, values of mixed magnitudes, ties."""
    from merfin_tpu_torch.ops.path_sum import path_sum_kernel, path_sums

    rng = np.random.default_rng(paths)
    lens = rng.integers(0, 400, paths)
    lens[::7] = 21
    gaps = rng.integers(0, 30, paths)
    b_start = np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
    b_end = b_start + lens
    n = int(b_end[-1]) + 5
    vals = rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e4], size=n)
    if paths > 7:                          # paths 0 and 7 tie
        vals[b_start[7]: b_end[7]] = vals[b_start[0]: b_end[0]]
    t = [torch.from_numpy(x) for x in (vals, b_start, b_end)]
    want = path_sums(*t).numpy()
    before = path_sum_kernel.launches
    got = path_sums(*(x.to(cuda) for x in t)).cpu().numpy()
    assert path_sum_kernel.launches == before + 1
    assert got.tobytes() == want.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["block", "slice", "bsearch"])
@pytest.mark.parametrize("k", [21, 32])
def test_gather_table_on_card(cuda, k, strategy):
    """DeviceLookup on CUDA (plain torch ops on the card) vs HostLookup:
    k=32 keys with bit 63, the poly-A key 0, n = 0 and 1, misses."""
    from merfin_tpu_torch.table.lookup import DeviceLookup, HostLookup

    rng = np.random.default_rng(k)
    hi = np.iinfo(np.uint64).max if k == 32 else 1 << (2 * k)
    for n in (0, 1, 1 << 16):
        keys = np.unique(np.concatenate([
            np.zeros(min(n, 1), np.uint64),
            rng.integers(0, hi, size=n, dtype=np.uint64)]))[:max(n, 0)]
        vals = rng.integers(0, 1 << 32, size=keys.size,
                            dtype=np.uint64).astype(np.uint32)
        q = np.concatenate([keys, rng.integers(0, hi, size=5000,
                                               dtype=np.uint64)])
        lk = DeviceLookup(keys, vals, k, device=cuda, strategy=strategy)
        assert not lk.placed
        got = lk.lookup(torch.from_numpy(q.view(np.int64)).to(cuda))
        assert got.is_cuda and lk.tree()[0].is_cuda
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint64),
                                      HostLookup(keys, vals)(q))


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_windowed_joins_on_edge_cases(cuda, case):
    """The windowed union and single-value joins and the window join,
    each against its plain version, on the edge cases of
    chip_smoke.join_edge_cases at the built constants."""
    import chip_smoke as cs
    from merfin_tpu_torch.ops.sorted_join import (SortedJoinTable,
                                                  sorted_join_kernel)
    from merfin_tpu_torch.ops.union_join import UnionTable, union_join_kernel
    from merfin_tpu_torch.ops.window_join import SortJoinTable

    cfg = union_join_kernel.config()
    cases = cs.join_edge_cases(np.random.default_rng(case), cfg)
    label, keys, v0, v1, q = cases[case]
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    table = UnionTable(keys, v0, v1, cuda)
    got = table.lookup2_sorted(qt)
    want = table.lookup2_plain(qt)
    single = SortedJoinTable(keys, v0, cuda)
    got1 = single.lookup_sorted(qt)
    want1 = single.lookup_plain(qt)
    window = SortJoinTable(keys, v0, cuda)
    got_w = window.lookup_sorted(qt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), label
    assert torch.equal(got1, want1), label
    assert torch.equal(got_w, want1), label
    assert sorted_join_kernel.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(3))
def test_window_join_on_equal_key_runs(cuda, case):
    """The window join against the plain version on tables whose keys
    repeat (chip_smoke.window_edge_cases at
    the built tile, chunk and dense/wide threshold): runs across chunk
    and tile boundaries, a run of 5,000+ keys, wrapping sums, sentinels,
    ragged lengths; bit-exact."""
    import chip_smoke as cs
    from merfin_tpu_torch.ops.window_join import (SortJoinTable,
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
    torch.cuda.synchronize()
    assert window_join_kernel.launches == before + 1
    assert torch.equal(got, want), label
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
