"""Score tails of the port vs the JAX package's jnp functions.

Value map, bin table and kover parts on the same numpy inputs from a
seed: integer outputs exact, f64/f32-derived outputs bit-equal.  The
kover fallback sum is the one order-dependent float: it is compared to
1e-12 relative (it sums the same terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfin_tpu.score.bin_table import BinTable
from merfin_tpu.score.kover import kover_parts as jax_kover_parts
from merfin_tpu.score.kover import kover_vmaxp
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.score.value_map import ValueMap
from merfin_tpu_torch import convert
from merfin_tpu_torch.score import bin_table as t_bin
from merfin_tpu_torch.score import value_map as t_vm
from merfin_tpu_torch.score.kover import kover_parts

PROB = ProbTable(np.asarray([1, 1, 2, 2, 3], np.uint32),
                 np.asarray([0.931, 0.871, 0.773, 0.597, 0.401]))


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype.kind == "f":      # bit patterns, so -0.0/NaN count too
        bits = f"u{want.itemsize}"
        np.testing.assert_array_equal(got.astype(want.dtype).view(bits),
                                      want.view(bits))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


@pytest.mark.parametrize("peak,prob,max_value,exact", [
    (2.0, None, 40, True), (4.4, PROB, 100, True), (30.0, None, 3_000_000,
                                                     True),
    (2.0, PROB, 300, False)])
def test_value_map_lookup(peak, prob, max_value, exact):
    vm = ValueMap(peak, prob, max_value, exact_max=exact)
    rng = np.random.default_rng(int(peak * 10))
    v = np.concatenate([np.arange(0, 64), rng.integers(
        0, 3 * vm.vcap, size=500)]).astype(np.uint64)
    jr, jp, jo = vm.lookup_jnp(jnp.asarray(v))
    tr, tp, to = t_vm.lookup(vm, torch.from_numpy(v.view(np.int64)),
                             convert.value_map_tensors(vm, "cpu"))
    _bits_equal(tr, jr)
    _bits_equal(tp, jp)
    assert int(to) == int(jo)


def _kvals(rng, n):
    """Integer-valued readK/asmK with in-range, out-of-range, ratio-edge
    and zero entries."""
    r = np.concatenate([rng.integers(0, 70, size=n), [0, 1, 2, 3, 64, 65,
                        1000, 2, 3]]).astype(np.float64)
    a = np.concatenate([rng.integers(0, 9000, size=n // 2),
                        rng.integers(0, 12, size=n - n // 2),
                        [5, 0, 3, 2, 8192, 8193, 1, 9000, 50000]]
                       ).astype(np.float64)
    return r, a


def test_bin_table_lookup():
    bt = BinTable()
    r, a = _kvals(np.random.default_rng(1), 4000)
    ju, jo, je = bt.lookup_jnp(jnp.asarray(r), jnp.asarray(a))
    tu, to, te = t_bin.lookup(bt, torch.from_numpy(r), torch.from_numpy(a),
                              convert.bin_table_tensors(bt, "cpu"))
    _bits_equal(tu, ju)
    _bits_equal(to, jo)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (~te.numpy()).any() and te.numpy().any()


@pytest.mark.parametrize("prob,bounds", [
    (None, True), (None, False), (PROB, False)])
def test_kover_parts(prob, bounds):
    rng = np.random.default_rng(7)
    n = 5000
    vm = ValueMap(2.0, prob, 200, exact_max=True)
    read_v = rng.integers(0, 40, size=n).astype(np.uint64)
    read_v[:50] = rng.integers(100, 200, size=50)
    read_k, _, prob_v = vm.read_k_host[read_v], None, vm.prob_host[read_v]
    asm_k = rng.integers(1, 12, size=n).astype(np.float64)
    asm_k[-40:] = rng.integers(8000, 9000, size=40)   # beyond amax: fallback
    is_undr = (read_k > 0) & (asm_k > read_k)
    vmaxp = kover_vmaxp(prob)
    amax = BinTable().amax
    kw = dict(r_max=vm.readk_bound(), a_max=12) if bounds else {}
    if bounds:
        asm_k = np.minimum(asm_k, 12)
        is_undr = (read_k > 0) & (asm_k > read_k)

    want = jax_kover_parts(jnp.asarray(read_v), jnp.asarray(read_k),
                           jnp.asarray(asm_k), jnp.asarray(prob_v),
                           jnp.asarray(is_undr), vmaxp, amax, **kw)
    got = kover_parts(torch.from_numpy(read_v.view(np.int64)),
                      torch.from_numpy(read_k), torch.from_numpy(asm_k),
                      torch.from_numpy(prob_v), torch.from_numpy(is_undr),
                      vmaxp, amax, **kw)
    for g, w in zip(got[:3], want[:3]):        # C, N, R: exact integers
        _bits_equal(g, w)
    assert int(got[4]) == int(want[4])           # fallback count
    if not bounds:
        assert int(got[4]) > 0
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-12)
