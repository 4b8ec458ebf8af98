"""The port's gather tables (``merfin_tpu_torch/table/lookup.py``) vs the
JAX package's ``DeviceLookup`` and ``HostLookup``, on the CPU, and the
routes that place them.

Tables and queries are made from a seed with numpy: keys of k = 15, 20,
21, 31 and 32 (k=32 keys with bit 63), tables of 0, 1 and thousands of
keys with the poly-A mer (key 0) present and absent, a skewed table
whose buckets force the binary search, hits, misses and the pad key 0.
Values are exact, so every comparison is exact.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from merfin_tpu.io.mkdb import KmerDB as JaxKmerDB
from merfin_tpu.table import lookup as jl
from merfin_tpu_torch import convert
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.table import lookup as pl

import chip_smoke as cs

STRATEGIES = ("block", "slice", "bsearch")


def _table(rng, k: int, n: int, with_zero: bool):
    """Sorted unique k-mer keys (u64) and u32 values, full range."""
    if k == 32:
        keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * 2 + 1
    else:
        keys = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    keys = np.unique(keys)
    if with_zero and keys.size:
        keys[0] = 0
        keys = np.unique(keys)
    vals = rng.integers(0, 1 << 32, size=keys.size,
                        dtype=np.uint64).astype(np.uint32)
    return keys, vals


def _queries(rng, k: int, keys: np.ndarray) -> np.ndarray:
    top = 1 << (2 * k)
    miss = rng.integers(0, top, size=700, dtype=np.uint64) if k < 32 else \
        rng.integers(0, 1 << 64, size=700, dtype=np.uint64)
    return np.concatenate([keys, keys[::-1], miss, np.zeros(3, np.uint64),
                           np.full(2, top - 1, np.uint64)])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [15, 20, 21, 31, 32])
def test_lookup_matches_jax(k, strategy):
    rng = np.random.default_rng(k)
    for n, with_zero in ((0, False), (1, True), (1, False), (5, True),
                         (3000, True), (3000, False)):
        keys, vals = _table(rng, k, n, with_zero)
        q = _queries(rng, k, keys)
        want = jl.HostLookup(keys, vals)(q)
        j = jl.DeviceLookup(keys, vals, k, strategy=strategy)
        p = pl.DeviceLookup(keys, vals, k, device="cpu", strategy=strategy)
        assert (p.bits, p.shift, p.rows, p.strategy, p.nblocks) == (
            j.bits, j.shift, j.rows, j.strategy, j.nblocks)
        np.testing.assert_array_equal(
            np.asarray(j.lookup(q)).astype(np.uint64), want)
        got = p.lookup_np(q)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pl.HostLookup(keys, vals)(q))
        if with_zero and n:      # a true hit on the poly-A mer
            assert got[0] == vals[0] and keys[0] == 0
        t = p.lookup(torch.from_numpy(q.view(np.int64)).reshape(-1, 1))
        assert t.shape == (q.size, 1) and t.dtype == torch.int64


@pytest.mark.parametrize("k", [21, 32])
def test_skewed_table_takes_bsearch(k):
    """A dense run of keys in one bucket: buckets cannot shrink under
    2*WINDOW by 24 bits, so both packages take the binary search."""
    rng = np.random.default_rng(3)
    base = np.uint64(0xF000_0000_0000_0000) if k == 32 else np.uint64(0)
    keys, _ = _table(rng, k, 3000, True)
    keys = np.unique(np.concatenate([keys, base + np.arange(400,
                                                            dtype=np.uint64)]))
    vals = rng.integers(1, 1 << 32, size=keys.size,
                        dtype=np.uint64).astype(np.uint32)
    j = jl.DeviceLookup(keys, vals, k)
    p = pl.DeviceLookup(keys, vals, k, device="cpu")
    assert p.strategy == j.strategy == "bsearch" and not p.windowed
    assert (p.rows, p.search_iters, p.bits) == (j.rows, j.search_iters,
                                                j.bits)
    q = _queries(rng, k, keys)
    np.testing.assert_array_equal(p.lookup_np(q), jl.HostLookup(keys, vals)(q))
    np.testing.assert_array_equal(
        p.lookup_np(q), np.asarray(j.lookup(q)).astype(np.uint64))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_jax_table_carried_across(strategy):
    """convert.device_lookup_from_jax keeps the JAX table's geometry,
    padding and offsets, and answers as it does."""
    rng = np.random.default_rng(11)
    keys, vals = _table(rng, 32, 5000, True)
    j = jl.DeviceLookup(keys, vals, 32, strategy=strategy)
    p = convert.device_lookup_from_jax(j, "cpu")
    assert not p.placed
    for got, want in zip(p.tree(), j.tree()):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy(),
                                      want.view(got.numpy().dtype))
    np.testing.assert_array_equal(p.keys_np, keys)
    q = _queries(rng, 32, keys)
    np.testing.assert_array_equal(
        p.lookup_np(q), np.asarray(j.lookup(q)).astype(np.uint64))


@pytest.mark.parametrize("lo,hi", [(0, 2**64 - 1), (5, 40), (1, 1), (60, 99)])
def test_build_lookup_filters_as_jax(lo, hi, tmp_path):
    """-min/-max drop rows at build, in both packages and in both table
    kinds; the gather table is placed only at its first probe."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 30, size=4000, dtype=np.uint64))
    vals = rng.integers(0, 50, size=keys.size).astype(np.uint32)
    KmerDB.create(str(tmp_path / "db"), 15, keys, vals)
    q = np.concatenate([keys, rng.integers(0, 1 << 30, size=999,
                                           dtype=np.uint64)])
    want = jl.build_lookup(JaxKmerDB(str(tmp_path / "db")), min_v=lo,
                           max_v=hi, host=True)(q)
    j = jl.build_lookup(JaxKmerDB(str(tmp_path / "db")), min_v=lo, max_v=hi)
    p = pl.build_lookup(KmerDB(str(tmp_path / "db")), min_v=lo, max_v=hi,
                        device="cpu")
    h = pl.build_lookup(KmerDB(str(tmp_path / "db")), min_v=lo, max_v=hi,
                        host=True)
    assert isinstance(p, pl.DeviceLookup) and isinstance(h, pl.HostLookup)
    assert p.n == j.n and not p.placed
    np.testing.assert_array_equal(p.keys_np, j.keys_np)
    np.testing.assert_array_equal(p.lookup_np(q), want)
    np.testing.assert_array_equal(h(q), want)
    assert p.placed


def test_device_default_follows_platform(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    p = pl.DeviceLookup(np.zeros(0, np.uint64), np.zeros(0, np.uint32), 21)
    assert p.device.type == "cpu"
    assert p.lookup_np(np.arange(4, dtype=np.uint64)).tolist() == [0] * 4
    assert p.memory_bytes() == ((1 << p.bits) + 1) * 4


@pytest.mark.parametrize("mode,flags,refused", [
    ("hist", ["-sortjoin"], "gather"),
    ("hist", ["-nosortjoin"], "union"),
    ("hist", [], "union"),
    ("dump", [], "union"),
])
def test_routes_build_only_their_tables(mode, flags, refused, tmp_path,
                                        monkeypatch):
    """The union route of -hist places no gather table; -dump and the
    gather route of -hist (the CPU default) build no union table."""
    from merfin_tpu_torch import cli
    from merfin_tpu_torch.ops import union_join

    argv = cs.mode_argv(cs.materialize(cs.recipe_world(), str(tmp_path)),
                        mode) + flags + ["-output", "out"]
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    owner, name = (pl.DeviceLookup, "tree") if refused == "gather" else \
        (union_join.UnionTable, "__init__")

    def refuse(*a, **kw):
        raise AssertionError(f"{owner.__name__}.{name} was called")

    monkeypatch.setattr(owner, name, refuse)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    assert ("-- Using sorted-join lookup kernel for -hist."
            in err.getvalue()) == (flags == ["-sortjoin"])
    assert "chr1\t45\t45\t1986" in err.getvalue()
