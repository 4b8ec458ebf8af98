"""The port's union sorted join vs the JAX package's (exact, tolerance 0).

On the CPU the port's table runs its plain version; it is held against
``SortJoinUnionV4.lookup2_sorted`` (the Pallas ``_kernel2`` in interpret
mode, as tests/test_join_kernel4.py runs it), ``_JnpSortJoin2`` and
``HostLookup``.  The CUDA kernel vs the plain version runs on the card
only (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfin_tpu.ops.join_kernel4 import QB, SEG, SortJoinUnionV4
from merfin_tpu.ops.join_kernel4 import union_merge_np as jax_union_merge
from merfin_tpu.ops.sortjoin import _JnpSortJoin2
from merfin_tpu.table.lookup import HostLookup
from merfin_tpu_torch import convert
from merfin_tpu_torch.ops.union_join import (UnionTable, lookup2_plain,
                                             u32_to_int64, union_join_kernel,
                                             union_merge_np)

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _dbs(n_read, n_asm, k, seed):
    rng = np.random.default_rng(seed)
    rk = np.unique(rng.integers(0, 1 << (2 * k), size=n_read,
                                dtype=np.uint64))
    rv = rng.integers(1, 70000, size=rk.size).astype(np.uint32)
    ak = np.unique(np.concatenate([
        rk[::3], rng.integers(0, 1 << (2 * k), size=n_asm, dtype=np.uint64)]))
    av = rng.integers(1, 9, size=ak.size).astype(np.uint32)
    return rng, rk, rv, ak, av


def _queries(rng, rk, ak, m, k, n_sentinel=0):
    q = np.concatenate([
        rk[rng.integers(0, rk.size, size=m // 3)],
        ak[rng.integers(0, ak.size, size=m // 3)],
        rng.integers(0, 1 << (2 * k), size=m - 2 * (m // 3) - n_sentinel,
                     dtype=np.uint64),
        np.full(n_sentinel, U64_MAX)])
    return np.sort(q)


def _port(table, q):
    r, a = table.lookup2_sorted(torch.from_numpy(q.view(np.int64)))
    return (u32_to_int64(r).numpy().astype(np.uint64),
            u32_to_int64(a).numpy().astype(np.uint64))


@pytest.mark.parametrize("n_read,n_asm,m", [
    (5000, 3000, QB), (SEG * 3 + 17, SEG + 5, 2 * QB), (100, 80, QB),
])
def test_union_plain_matches_pallas_and_host(n_read, n_asm, m):
    k = 21
    rng, rk, rv, ak, av = _dbs(n_read, n_asm, k, n_read * 7 + n_asm)
    q = _queries(rng, rk, ak, m, k, n_sentinel=QB // 4)

    v4 = SortJoinUnionV4(rk, rv, ak, av, k)
    jr, ja = v4.lookup2_sorted(jnp.asarray(q))
    table = UnionTable.from_dbs(rk, rv, ak, av, "cpu")
    pr, pa = _port(table, q)

    np.testing.assert_array_equal(pr, np.asarray(jr).astype(np.uint64))
    np.testing.assert_array_equal(pa, np.asarray(ja).astype(np.uint64))
    valid = q != U64_MAX
    np.testing.assert_array_equal(pr[valid], HostLookup(rk, rv)(q[valid]))
    np.testing.assert_array_equal(pa[valid], HostLookup(ak, av)(q[valid]))
    assert (pr[~valid] == 0).all() and (pa[~valid] == 0).all()

    # the JAX CPU stand-in, on a ragged (non-QB-multiple) length
    qr = q[: m - 37]
    js = _JnpSortJoin2(*jax_union_merge(rk, rv, ak, av))
    jr2, ja2 = js.lookup2_sorted(jnp.asarray(qr))
    pr2, pa2 = _port(table, qr)
    np.testing.assert_array_equal(pr2, np.asarray(jr2).astype(np.uint64))
    np.testing.assert_array_equal(pa2, np.asarray(ja2).astype(np.uint64))


def test_union_sentinels_and_pads():
    """Sentinel queries never pick up a value, including from the TPU
    layout's pad key 0x7FFFFFFF_FFFFFFFF (test_union_v4_sentinels)."""
    k = 15
    rng = np.random.default_rng(2)
    rk = np.unique(rng.integers(0, 1 << (2 * k), size=3000, dtype=np.uint64))
    rv = rng.integers(1, 9, size=rk.size).astype(np.uint32)
    q = np.sort(np.concatenate([
        rk[: QB // 2], np.full(QB // 2 - 1, U64_MAX),
        np.array([0x7FFFFFFF_FFFFFFFF], np.uint64)]))
    v4 = SortJoinUnionV4(rk, rv, rk, rv + 1, k)
    jr, ja = v4.lookup2_sorted(jnp.asarray(q))
    pr, pa = _port(UnionTable.from_dbs(rk, rv, rk, rv + 1, "cpu"), q)
    np.testing.assert_array_equal(pr, np.asarray(jr).astype(np.uint64))
    np.testing.assert_array_equal(pa, np.asarray(ja).astype(np.uint64))
    assert (pr[QB // 2:] == 0).all() and (pa[QB // 2:] == 0).all()
    np.testing.assert_array_equal(pr[: QB // 2], rv[: QB // 2])


def test_union_k32_bit63_keys():
    """k=32 keys use bit 63: the plain version's searchsorted must order
    them unsigned."""
    rng = np.random.default_rng(32)
    rk = np.unique(rng.integers(0, np.iinfo(np.uint64).max, size=4000,
                                dtype=np.uint64, endpoint=False))
    assert (rk >= np.uint64(1 << 63)).any()
    rv = rng.integers(1, 100, size=rk.size).astype(np.uint32)
    q = np.sort(np.concatenate([rk[::2], rng.integers(
        0, np.iinfo(np.uint64).max, size=500, dtype=np.uint64),
        np.full(10, U64_MAX)]))
    pr, pa = _port(UnionTable.from_dbs(rk, rv, rk[:0], rv[:0], "cpu"), q)
    valid = q != U64_MAX
    np.testing.assert_array_equal(pr[valid], HostLookup(rk, rv)(q[valid]))
    assert (pa == 0).all() and (pr[~valid] == 0).all()


def test_union_merge_matches_jax():
    rng = np.random.default_rng(99)
    for _ in range(30):
        na, nb = rng.integers(0, 300, size=2)
        ka = np.unique(rng.integers(0, 600, size=na).astype(np.uint64))
        kb = np.unique(rng.integers(0, 600, size=nb).astype(np.uint64))
        va = rng.integers(1, 1000, size=ka.size).astype(np.uint32)
        vb = rng.integers(1, 1000, size=kb.size).astype(np.uint32)
        for got, want in zip(union_merge_np(ka, va, kb, vb),
                             jax_union_merge(ka, va, kb, vb)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("n_read,n_asm", [(SEG * 3 + 17, SEG + 5), (50, 0)])
def test_convert_round_trips_v4_rec(n_read, n_asm):
    k = 21
    _, rk, rv, ak, av = _dbs(n_read, n_asm, k, 5)
    v4 = SortJoinUnionV4(rk, rv, ak, av, k)
    want = jax_union_merge(rk, rv, ak, av)
    for n in (v4.n, None):
        got = convert.union_from_rec2(np.asarray(v4.rec),
                                      np.asarray(v4.seg_first), n=n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    tree = _JnpSortJoin2(*want).tree()
    for g, w in zip(convert.union_from_tree(tree), want):
        np.testing.assert_array_equal(g, w)


def test_lookup2_plain_empty_table():
    z = torch.zeros(0, dtype=torch.int64)
    q = torch.tensor([1, 2, -1], dtype=torch.int64)
    r, a = lookup2_plain(z, z.to(torch.int32), z.to(torch.int32), q)
    assert r.tolist() == [0, 0, 0] and a.tolist() == [0, 0, 0]


def test_cuda_wrapper_refuses_cpu_tensors():
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        union_join_kernel(z, z.to(torch.int32), z.to(torch.int32), z[:1], z)
    assert union_join_kernel.launches == 0

