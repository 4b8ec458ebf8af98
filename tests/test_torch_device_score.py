"""The port's fused variant scorer vs the JAX package's, on the CPU.

Inputs are made from a seed with numpy; the JAX functions run on their
CPU backend (the union table there is ``_JnpSortJoin2``, the JAX CPU
stand-in of the Pallas union join).  The port's scorers probe the JAX
gather tables carried across by ``convert.device_lookup_from_jax``, by
the union join or by the gather probe.  Tolerances: integers (num_m, the
integer path's totdk, masks, overflow counts) exactly; the f64 path's
per-window deltas to 1e-12 and its totdk to 1e-9 relative; the port's
f64 reduction itself is held to the in-order sum bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from merfin_tpu.io.mkdb import KmerDB
from merfin_tpu.kcore.pack import kmers_from_codes_np
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.score.value_map import ValueMap
from merfin_tpu.table.lookup import HostLookup, build_lookup
from merfin_tpu.variants import device_score as jds
from merfin_tpu.variants.enumerate_fast import build_path_block_fast
from merfin_tpu.variants.score import dispatch_blocks
from merfin_tpu_torch import convert
from merfin_tpu_torch.table.lookup import DeviceLookup
from merfin_tpu_torch.variants import device_score as pds

import chip_smoke as cs

PROB = ProbTable(np.asarray([1, 1, 2, 3], np.uint32),
                 np.asarray([0.93, 0.87, 0.77, 0.6]))
F64 = dict(rtol=1e-9, atol=0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class _Capture:
    """Stands in for a scorer: keeps the packed stream dispatch_blocks
    makes of a batch of PathBlocks."""

    def dispatch_paths(self, *args):
        return args


def _world(k: int, seed: int, tmp_path):
    """Assembly with substitutions (and, for even k, palindromic stems),
    reads at 30x of the true genome plus a few high-count k-mers; the
    read/asm DBs; candidate-path blocks over SNPs, a 1/2 site, an
    insertion and a deletion of several clusters."""
    rng = np.random.default_rng(seed)
    g = cs._dna(rng, 1500)
    if k % 2 == 0:
        for at in (200, 700, 1200):
            stem = cs._dna(rng, k // 2)
            g = g[:at] + stem + cs._revcomp(stem) + g[at + k:]
    asm = list(g)
    errs = [150, 420, 690, 1110]
    for p in errs:
        asm[p] = cs.ALT_OF[asm[p]]
    asm = "".join(asm)
    world = dict(k=k, peak=30.0, scaffolds=[("chr1", asm)],
                 reads=[g] * 30 + [g[600:900]] * 50, prob=None)
    argv = cs.materialize(world, str(tmp_path))
    rdb, adb = KmerDB(argv[4]), KmerDB(argv[6])
    blocks = []
    for c, p in enumerate(errs + [205, 1190, 700]):
        lo = max(0, p - k - 10)
        hi = min(len(asm), p + k + 20)
        t = asm[lo:hi]
        q = p - lo
        idx, lens, haps = [q], [1], [[t[q], g[p]]]
        if c % 2 == 0:                 # a 1/2 site and an insertion
            idx += [q + 6, q + 12]
            lens += [1, 1]
            haps += [[t[q + 6], cs.ALT_OF[t[q + 6]],
                      cs.ALT_OF[cs.ALT_OF[t[q + 6]]]],
                     [t[q + 12], t[q + 12] + "G"]]
        else:                          # a deletion
            idx += [q + 8]
            lens += [3]
            haps += [[t[q + 8: q + 11], t[q + 8]]]
        blocks.append(build_path_block_fast(t, idx, lens, haps, k))
    return rdb, adb, blocks


def _scorers(k, rdb, adb, prob, sortjoin=True, **kw):
    """JAX DeviceScorers (union join and gather) and the port's (the
    union join, or the gather probe), on the JAX gather tables carried
    across; the port's union table is the JAX scorer's."""
    rl, al = build_lookup(rdb), build_lookup(adb)
    j_sj = jds.DeviceScorer(rl, al, k, 30.0, prob, sortjoin=True, **kw)
    j_g = jds.DeviceScorer(rl, al, k, 30.0, prob, sortjoin=False, **kw)
    port = pds.DeviceScorer(convert.device_lookup_from_jax(rl, "cpu"),
                            convert.device_lookup_from_jax(al, "cpu"), k,
                            30.0, prob, sortjoin=sortjoin, **kw)
    if sortjoin:
        want = convert.union_from_device_scorer(j_sj)
        got = (port.table.keys, port.table.read_vals, port.table.asm_vals)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.view(g.numpy().dtype))
    return j_sj, j_g, port


def test_planes_from_bits_matches_jax():
    rng = np.random.default_rng(0)
    for n in (4096, 5000 - 3):
        nb = -(-n // 8)
        adj = rng.integers(0, 256, size=nb, dtype=np.uint8)
        marks = np.packbits(rng.random(nb * 8) < 0.05, bitorder="little")
        for need in (False, True):
            ja, js = jds._planes_from_bits(jnp.asarray(adj),
                                           jnp.asarray(marks), n, need)
            pa, ps = pds._planes_from_bits(_t(adj), _t(marks), n, need)
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
            if need:
                np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
            else:
                assert ps is None and js is None


@pytest.mark.parametrize("branch", ["int", "f64", "f64_prob", "overflow"])
def test_stream_math_matches_jax(branch):
    rng = np.random.default_rng(1)
    n = 8192
    prob = PROB if branch == "f64_prob" else None
    vm = ValueMap(30.0, prob, 4 if branch == "overflow" else 200,
                  exact_max=branch in ("int", "f64_prob"))
    assert vm.int_scorer_ok() == (branch == "int")
    read_v = rng.integers(0, 400, size=n).astype(np.uint64)
    read_v[rng.random(n) < 0.2] = 0
    asm_v = rng.integers(0, 4, size=n).astype(np.uint64)
    valid = rng.random(n) < 0.9
    adjust = rng.random(n) < 0.3
    marks = rng.random(n) < 0.01
    marks[0] = True
    path_start = np.maximum.accumulate(np.where(marks, np.arange(n), 0))

    jout = jds._stream_math(vm, vm.device_arrays_scorer(), jnp.asarray(read_v),
                            jnp.asarray(asm_v), jnp.asarray(valid),
                            jnp.asarray(adjust), jnp.asarray(path_start))
    pout = pds._stream_math(vm, convert.value_map_scorer_tensors(vm, "cpu"),
                            _t(read_v.view(np.int64)),
                            _t(asm_v.view(np.int64)), _t(valid), _t(adjust),
                            _t(path_start))
    np.testing.assert_array_equal(pout[0].numpy(), np.asarray(jout[0]))
    if branch == "int":
        assert pout[1].dtype == torch.int64
        np.testing.assert_array_equal(pout[1].numpy(), np.asarray(jout[1]))
    else:
        np.testing.assert_allclose(pout[1].numpy(), np.asarray(jout[1]),
                                   rtol=1e-12, atol=1e-12)
    assert int(pout[2]) == int(jout[2])
    if branch == "overflow":
        assert int(pout[2]) == int((read_v > vm.vcap).sum()) > 0


@pytest.mark.parametrize("dtype", ["int64", "f64"])
def test_boundary_reduce_matches_jax(dtype):
    rng = np.random.default_rng(2)
    n = 512 * 24
    missing = rng.random(n) < 0.3
    if dtype == "int64":
        dk = rng.integers(-1, 2, size=n).astype(np.int64)
    else:
        dk = rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e3], size=n)
    cuts = np.sort(rng.choice(n, size=200, replace=False))
    b_start = np.concatenate([[0], cuts]).astype(np.int32)
    b_end = np.concatenate([cuts, [n]]).astype(np.int32)
    b_end[5] = b_start[5]                      # an empty path
    jm, jd = jds._boundary_reduce(jnp.asarray(missing), jnp.asarray(dk),
                                  jnp.asarray(b_start), jnp.asarray(b_end))
    pm, pd = pds._boundary_reduce(_t(missing), _t(dk),
                                  _t(b_start).long(), _t(b_end).long())
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    # getTotdK's order: each path's values added one at a time from 0.0
    want = np.asarray([np.add.accumulate(dk[a:b])[-1] if b > a else 0
                       for a, b in zip(b_start, b_end)], dk.dtype)
    if dtype == "int64":
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pd.numpy(), want)
    else:
        # the port sums f64 in path order, bit for bit; the JAX package's
        # two-level prefix difference is off by ~1e-9 relative on paths
        # whose total is small beside the prefix (a deliberate divergence)
        assert pd.numpy().tobytes() == want.tobytes()


def test_pack_inputs_matches_jax(tmp_path):
    _, _, blocks = _world(11, 3, tmp_path)
    stream = dispatch_blocks(blocks, _Capture(), 11)[1]
    for got, want in zip(pds._pack_inputs(*stream, 11),
                         jds._pack_inputs(*stream, 11)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [11, 12])
@pytest.mark.parametrize("with_prob", [False, True])
def test_score_paths_matches_jax(k, with_prob, tmp_path):
    """num_m exactly, totdk exactly on the integer path and to 1e-9 on
    the f64 path; for the union-join and the gather JAX scorers."""
    rdb, adb, blocks = _world(k, 4 + k, tmp_path)
    prob = PROB if with_prob else None
    j_sj, j_g, port = _scorers(k, rdb, adb, prob,
                               max_value=int(rdb.vals.max()), exact_max=True)
    assert port.int_path == (not with_prob)
    stream = dispatch_blocks(blocks, _Capture(), k)[1]
    nm, td = port.score_paths(*stream)
    assert td.dtype == (np.float64 if with_prob else np.int64)
    assert nm.shape == (sum(b.nis.shape[0] for b in blocks),)
    assert (nm > 0).any() and (nm == 0).any() and (td != 0).any()
    for j in (j_sj, j_g):
        jnm, jtd = j.score_paths(*stream)
        np.testing.assert_array_equal(nm, jnm)
        if with_prob:
            np.testing.assert_allclose(td, jtd, **F64)
        else:
            np.testing.assert_array_equal(td, jtd)
    if k % 2 == 0:      # the palindromic stems doubled some values
        fmer, rmer, valid = kmers_from_codes_np(stream[0], k)
        assert (valid & (fmer == rmer)).any()


def test_span_chunking_matches_single_span(tmp_path):
    rdb, adb, blocks = _world(11, 5, tmp_path)
    _, _, one = _scorers(11, rdb, adb, PROB)
    _, _, many = _scorers(11, rdb, adb, PROB)
    many.MAX_WINDOWS = 64
    stream = dispatch_blocks(blocks, _Capture(), 11)[1]
    token = many.dispatch_paths(*stream)
    assert len(token[1]) > 3
    nm, td = many.fetch_paths(token)
    nm1, td1 = one.score_paths(*stream)
    np.testing.assert_array_equal(nm, nm1)
    np.testing.assert_allclose(td, td1, **F64)


def test_integer_totdk_fetched_exactly():
    """Divergence from the JAX scorer, which casts the int64 totdk to
    f64 before its fused fetch: the port fetches int64, so a sum past
    2^53 comes back exact."""
    empty = DeviceLookup(np.zeros(0, np.uint64), np.zeros(0, np.uint32), 11,
                         device="cpu")
    scorer = pds.DeviceScorer(empty, empty, 11, 30.0, None, max_value=100,
                              exact_max=True)
    assert scorer.int_path
    big = (1 << 53) + 1
    dk = torch.zeros(2048, dtype=torch.int64)
    dk[3], dk[700], dk[1500] = big, 2, -big
    missing = torch.zeros(2048, dtype=torch.bool)
    missing[701] = True
    spans = []
    for lo, hi in ((0, 1024), (1024, 2048)):
        nm, td = pds._boundary_reduce(missing[lo:hi], dk[lo:hi],
                                      torch.tensor([0, 600, 0]),
                                      torch.tensor([600, 1024, 0]))
        spans.append((nm, td, torch.zeros((), dtype=torch.int64)))
    num_m, totdk = scorer.fetch_paths(
        (4, [(0, 2, spans[0]), (2, 4, spans[1])]))
    assert totdk.dtype == np.int64
    assert totdk.tolist() == [big, 2, -big, 0]
    assert num_m.tolist() == [0, 1, 0, 0]
    assert float(np.float64(big)) != big       # what an f64 fetch would lose


def test_overflow_counted_once_over_spans(tmp_path):
    """Divergence from the JAX scorer, whose fallback fetch can add a
    span's overflow count twice: every span's count is added once, so
    several spans give the single span's count, the JAX scorer's count,
    and the number of valid windows above the value map's cap."""
    rdb, adb, blocks = _world(11, 6, tmp_path)
    j_sj, _, one = _scorers(11, rdb, adb, None, max_value=4)
    _, _, many = _scorers(11, rdb, adb, None, max_value=4)
    many.MAX_WINDOWS = 64
    stream = dispatch_blocks(blocks, _Capture(), 11)[1]
    j_sj.score_paths(*stream)
    one.score_paths(*stream)
    token = many.dispatch_paths(*stream)
    assert len(token[1]) > 3
    many.fetch_paths(token)
    fmer, rmer, valid = kmers_from_codes_np(stream[0], 11)
    reads = HostLookup(np.asarray(rdb.keys, np.uint64),
                       np.asarray(rdb.vals, np.uint32))
    want = int((valid & (reads(np.minimum(fmer, rmer))
                         > one.value_map.vcap)).sum())
    assert want > 0
    assert many.overflow_values == one.overflow_values == want
    assert j_sj.overflow_values == want


@pytest.mark.parametrize("k", [11, 12])
@pytest.mark.parametrize("with_prob", [False, True])
def test_gather_scorer_matches_jax(k, with_prob, tmp_path):
    """The port's gather probe (``sortjoin=False``, the CPU default) vs
    the JAX gather scorer: the same spans (2^21 windows), num_m and the
    overflow count exactly, totdk exactly on the integer path and to
    1e-9 on the f64 path; no union table is built."""
    rdb, adb, blocks = _world(k, 20 + k, tmp_path)
    prob = PROB if with_prob else None
    kw = dict(max_value=int(rdb.vals.max()), exact_max=True)
    _, j_g, port = _scorers(k, rdb, adb, prob, sortjoin=False, **kw)
    auto = pds.DeviceScorer(port.read_lookup, port.asm_lookup, k, 30.0, prob,
                            **kw)
    assert not auto.sortjoin and auto.table is None and port.table is None
    assert port.MAX_WINDOWS == j_g.MAX_WINDOWS == 1 << 21
    stream = dispatch_blocks(blocks, _Capture(), k)[1]
    nm, td = port.score_paths(*stream)
    jnm, jtd = j_g.score_paths(*stream)
    np.testing.assert_array_equal(nm, jnm)
    if with_prob:
        np.testing.assert_allclose(td, jtd, **F64)
    else:
        np.testing.assert_array_equal(td, jtd)
    assert port.overflow_values == j_g.overflow_values
    assert (nm > 0).any() and (nm == 0).any()


def test_union_scorer_places_no_gather_table(tmp_path):
    """The union route builds its table from the lookups' host rows: a
    scored span leaves both gather tables unplaced; the gather route
    places them at its first span."""
    rdb, adb, blocks = _world(11, 9, tmp_path)
    lk = [DeviceLookup(np.asarray(d.keys), np.asarray(d.vals), 11,
                       device="cpu") for d in (rdb, adb)]
    stream = dispatch_blocks(blocks, _Capture(), 11)[1]
    union = pds.DeviceScorer(*lk, 11, 30.0, None, sortjoin=True)
    union.score_paths(*stream)
    assert union.table is not None and not any(x.placed for x in lk)
    gather = pds.DeviceScorer(*lk, 11, 30.0, None)
    gather.score_paths(*stream)
    assert all(x.placed for x in lk)


def test_value_map_scorer_tensors_follow_int_rule():
    for prob, exact in ((None, True), (PROB, True), (None, False)):
        vm = ValueMap(30.0, prob, 100, exact_max=exact)
        rk, pr = convert.value_map_scorer_tensors(vm, "cpu")
        j_rk, j_pr = vm.device_arrays_scorer()
        assert (rk.dtype == torch.int32) == vm.int_scorer_ok() \
            == (np.asarray(j_rk).dtype == np.int32)
        np.testing.assert_array_equal(rk.numpy(), np.asarray(j_rk))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(j_pr))

