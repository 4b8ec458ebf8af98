"""The port's single-value sorted joins vs the JAX package's (exact,
tolerance 0).

On the CPU the port's tables run their plain versions.  They are held
against the Pallas kernels in interpret mode, as tests/test_join_kernel*.py
run them (``SortJoinTableV4``, ``SortJoinTable``, ``SortJoinTableV5``),
and against the CPU stand-in ``_JnpSortJoin``.  The CUDA kernels vs the
plain versions run on the card only (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfin_tpu.ops.join_kernel import QB, SEG as SEG_V1
from merfin_tpu.ops.join_kernel import SortJoinTable as JaxV1
from merfin_tpu.ops.join_kernel4 import SEG, SortJoinTableV4 as JaxV4
from merfin_tpu.ops.join_kernel5 import SortJoinTableV5 as JaxV5
from merfin_tpu.ops.sortjoin import _JnpSortJoin
from merfin_tpu.table.lookup import HostLookup
from merfin_tpu_torch import convert
from merfin_tpu_torch.ops.sorted_join import (SortedJoinTable,
                                              sorted_join_kernel)
from merfin_tpu_torch.ops.sortjoin import build_sortjoin_table
from merfin_tpu_torch.ops.union_join import u32_to_int64
from merfin_tpu_torch.ops.window_join import (SortJoinTable,
                                              SortJoinTableV5,
                                              window_join_kernel)

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
PORT = {"v4": SortedJoinTable, "v1": SortJoinTable, "v5": SortJoinTableV5}
JAX = {"v4": JaxV4, "v1": JaxV1, "v5": JaxV5}


def _table(n, k, seed, big_values=False):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64))
    lo = (1 << 31) if big_values else 1
    vals = rng.integers(lo, 1 << 32 if big_values else 1000,
                        size=keys.size).astype(np.uint32)
    if big_values and keys.size:
        vals[0] = 0xFFFFFFFF
    return rng, keys, vals


def _queries(rng, keys, m, k, n_sentinel):
    """Sorted: half hits, the rest random mers (mostly misses), then
    ``n_sentinel`` u64::MAX sentinels."""
    hits = keys[rng.integers(0, keys.size, size=m // 2)] if keys.size \
        else np.zeros(0, np.uint64)
    rand = rng.integers(0, 1 << (2 * k), size=m - hits.size - n_sentinel,
                        dtype=np.uint64)
    return np.sort(np.concatenate([hits, rand,
                                   np.full(n_sentinel, U64_MAX)]))


def _port(table, q):
    out = table.lookup_sorted(torch.from_numpy(q.view(np.int64)))
    return u32_to_int64(out).numpy().astype(np.uint64)


@pytest.mark.parametrize("route", ["v4", "v1", "v5"])
@pytest.mark.parametrize("n,m,big", [
    (5000, QB, False), (SEG * 3 + 17, 2 * QB, True), (100, QB, False),
    (40_000, 2 * QB, True),
])
def test_plain_matches_pallas_and_stand_in(route, n, m, big):
    k = 21
    rng, keys, vals = _table(n, k, n + m + big, big_values=big)
    q = _queries(rng, keys, m, k, n_sentinel=QB // 8)

    want = np.asarray(JAX[route](keys, vals, k).lookup_sorted(
        jnp.asarray(q))).astype(np.uint64)
    table = PORT[route](keys, vals, "cpu")
    got = _port(table, q)
    np.testing.assert_array_equal(got, want)
    valid = q != U64_MAX
    np.testing.assert_array_equal(got[valid], HostLookup(keys, vals)(q[valid]))
    assert (got[~valid] == 0).all()
    if big:
        assert (got[valid] >= 1 << 31).any()

    # the JAX CPU stand-in, on a ragged (non-QB-multiple) length
    qr = q[: m - 37]
    stand_in = np.asarray(_JnpSortJoin(keys, vals).lookup_sorted(
        jnp.asarray(qr))).astype(np.uint64)
    np.testing.assert_array_equal(_port(table, qr), stand_in)
    np.testing.assert_array_equal(stand_in, want[: m - 37])


@pytest.mark.parametrize("route", ["v4", "v1", "v5"])
def test_empty_table(route):
    keys = np.zeros(0, np.uint64)
    vals = np.zeros(0, np.uint32)
    rng = np.random.default_rng(0)
    q = _queries(rng, keys, QB, 21, 10)
    got = _port(PORT[route](keys, vals, "cpu"), q)
    assert (got == 0).all()
    want = np.asarray(_JnpSortJoin(keys, vals).lookup_sorted(jnp.asarray(q)))
    np.testing.assert_array_equal(got, want.astype(np.uint64))


def _runs_table(rng, k, case):
    """Keys with repeats and their values: "short" runs of at most 3
    keys; "long", one run longer than JAX v1's SEG (5,000 keys, across
    three of its segments) among runs of 1-5, values near 2^32 so every
    sum of a run wraps."""
    base = np.unique(rng.integers(0, 1 << (2 * k), size=3000,
                                  dtype=np.uint64))
    if case == "short":
        keys = np.sort(np.concatenate([base, base[::5], base[::7]]))
        return base, keys, rng.integers(1 << 30, 1 << 32,
                                        size=keys.size).astype(np.uint32)
    reps = rng.integers(1, 6, size=base.size)
    reps[base.size // 2] = 5000
    assert reps.max() > SEG_V1
    keys = np.repeat(base, reps)
    return base, keys, (np.uint32(0xFFFFFFFF) - rng.integers(
        0, 1 << 20, size=keys.size).astype(np.uint32))


@pytest.mark.parametrize("route,case", [
    pytest.param(r, c, id=r if c == "short" else f"{r}-{c}")
    for c in ("short", "long") for r in ("v1", "v5")])
def test_window_join_sums_equal_keys(route, case):
    """v1/v5's contract sums the values of equal keys, wrapping in u32;
    the window table allows them (the binary-search table refuses).
    Runs of at most 3 keys, and a run longer than JAX's segment with
    sums that wrap (the long run queried by many queries)."""
    k = 15
    rng = np.random.default_rng(7)
    base, keys, vals = _runs_table(rng, k, case)
    q = _queries(rng, base, 2 * QB, k, 50)
    if case == "long":
        long_key = base[base.size // 2]
        q = np.sort(np.concatenate([q[: 2 * QB - 100],
                                    np.full(100, long_key)]))
    want = np.asarray(JAX[route](keys, vals, k).lookup_sorted(
        jnp.asarray(q))).astype(np.uint64)
    got = _port(PORT[route](keys, vals, "cpu"), q)
    np.testing.assert_array_equal(got, want)
    if case == "long":
        i = np.searchsorted(q, long_key)
        run = vals[keys == long_key].astype(np.uint64).sum()
        assert got[i] == run % (1 << 32) and run >= 1 << 32
    with pytest.raises(ValueError):
        SortedJoinTable(keys, vals, "cpu")


@pytest.mark.parametrize("case", range(3))
def test_window_edge_cases_plain_matches_numpy(case):
    """chip_smoke.window_edge_cases (the card's equal-key cases, built
    here at small constants): the plain window join equals a numpy sum
    of each query's equal keys, mod 2^32."""
    import chip_smoke as cs

    cfg = {"tile": 128, "chunk": 64, "wide": 8}
    label, keys, vals, q = cs.window_edge_cases(
        np.random.default_rng(case), cfg)[case]
    got = _port(SortJoinTable(keys, vals, "cpu"), q)
    uk, first = np.unique(keys, return_index=True)
    sums = np.add.reduceat(vals.astype(np.uint64), first) % (1 << 32)
    idx = np.minimum(np.searchsorted(uk, q), uk.size - 1)
    want = np.where((uk[idx] == q) & (q != U64_MAX), sums[idx], 0)
    np.testing.assert_array_equal(got, want, err_msg=label)
    runs = np.diff(np.append(first, keys.size))
    assert (runs[idx][want != 0] > 1).any()


@pytest.mark.parametrize("prefer,query_windows,cls", [
    ("v4", 1, SortedJoinTable), ("v1", 1 << 30, SortJoinTable),
    ("auto", 2500, SortJoinTable), ("auto", 2499, SortedJoinTable),
])
def test_builder_routes(prefer, query_windows, cls):
    """The JAX ratio rule: v1 when table/query <= 2 (5000 keys here)."""
    rng, keys, vals = _table(5000, 21, 3)
    keys, vals = keys[:5000], vals[:5000]
    table = build_sortjoin_table(keys, vals, 21, query_windows,
                                 prefer=prefer, device="cpu")
    assert type(table) is cls and table.device.type == "cpu"
    q = _queries(rng, keys, QB, 21, 5)
    np.testing.assert_array_equal(
        _port(table, q),
        np.asarray(_JnpSortJoin(keys, vals).lookup_sorted(
            jnp.asarray(q))).astype(np.uint64))


@pytest.mark.parametrize("route", ["stand_in", "v4", "v1", "v5"])
def test_convert_round_trips(route):
    k = 21
    rng, keys, vals = _table(SEG * 2 + 77, k, 11, big_values=True)
    if route == "stand_in":
        got = convert.single_from_tree(_JnpSortJoin(keys, vals).tree())
    elif route == "v4":
        t = JaxV4(keys, vals, k)
        for n in (t.n, None):
            got = convert.single_from_rec(np.asarray(t.rec),
                                          np.asarray(t.seg_first), n=n)
            for g, w in zip(got, (keys, vals)):
                np.testing.assert_array_equal(g, w)
    else:
        got = convert.single_from_tree(JAX[route](keys, vals, k).tree())
    for g, w in zip(got, (keys, vals)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # the decoded state builds a port table that answers as the original
    q = _queries(rng, keys, QB, k, 3)
    np.testing.assert_array_equal(_port(SortedJoinTable(*got, "cpu"), q),
                                  HostLookup(keys, vals)(q))


def test_lookup_sorted_with_foreign_tree():
    rng, keys, vals = _table(2000, 17, 5)
    other = SortJoinTable(keys[::2], vals[::2], "cpu")
    q = torch.from_numpy(_queries(rng, keys, 500, 17, 3).view(np.int64))
    for cls in (SortedJoinTable, SortJoinTable):
        t = cls(keys, vals, "cpu")
        assert torch.equal(t.lookup_sorted_with(other.tree(), q),
                           other.lookup_sorted(q))


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.zeros(4, dtype=torch.int64)
    for kern, index in ((sorted_join_kernel, [z[:1]]),
                        (window_join_kernel, [])):
        with pytest.raises(ValueError):
            kern(z, z.to(torch.int32), *index, z)
        assert kern.launches == 0
