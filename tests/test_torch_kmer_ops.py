"""merfin_tpu_torch.ops.kmer_ops vs merfin_tpu.ops.kmer_ops (exact).

Same numpy inputs from a seed through the jnp functions and their torch
ports; every output is integer or boolean, so the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfin_tpu.kcore.pack import pack_transfer_np
from merfin_tpu.modes.engine import pack_group_transfer as jax_pack_group
from merfin_tpu.ops import kmer_ops as jops
from merfin_tpu_torch.modes.engine import pack_group_transfer
from merfin_tpu_torch.ops import kmer_ops as tops


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k", [15, 20, 21, 32])
def test_kmer_windows_and_canonical(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(3, 700)).astype(np.uint8)
    codes[0, 100:130] = 4                       # an N run
    codes[1, rng.integers(0, 700, size=20)] = 4  # scattered Ns
    # an even-k palindrome (fmer == rmer) in the last row
    stem = rng.integers(0, 4, size=k // 2).astype(np.uint8)
    codes[2, 50: 50 + 2 * (k // 2)] = np.concatenate([stem, 3 - stem[::-1]])

    jf, jr, jv = jops.kmer_windows(jnp.asarray(codes), k)
    tf, tr, tv = tops.kmer_windows(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(_u64(tf), np.asarray(jf))
    np.testing.assert_array_equal(_u64(tr), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    jc, jm = jops.canonical_and_mult(jf, jr)
    tc, tm = tops.canonical_and_mult(tf, tr)
    np.testing.assert_array_equal(_u64(tc), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    if k % 2 == 0:
        assert (tm.numpy() == 2).any()
    if k == 32:   # bit 63 in use: the unsigned order matters
        assert (np.asarray(jc) >= np.uint64(1 << 63)).any() or \
            (np.asarray(jf) >= np.uint64(1 << 63)).any()


def test_umin_and_bias_order_u64():
    vals = np.array([0, 1, (1 << 62), (1 << 63) - 1, 1 << 63,
                     (1 << 64) - 2, (1 << 64) - 1], dtype=np.uint64)
    t = torch.from_numpy(vals.view(np.int64))
    order = torch.argsort(tops.bias(t)).numpy()
    np.testing.assert_array_equal(vals[order], np.sort(vals))
    a, b = np.meshgrid(vals, vals)
    got = tops.umin(torch.from_numpy(a.view(np.int64)),
                    torch.from_numpy(b.view(np.int64)))
    np.testing.assert_array_equal(_u64(got), np.minimum(a, b))


@pytest.mark.parametrize("L", [37, 64, 541])
def test_unpack_transfer(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 6, size=(2, L)).astype(np.uint8)
    planes, vbits = pack_transfer_np(codes)
    want = np.asarray(jops.unpack_transfer(jnp.asarray(planes),
                                           jnp.asarray(vbits), L))
    got = tops.unpack_transfer(torch.from_numpy(planes),
                               torch.from_numpy(vbits), L).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.where(codes < 4, codes, 4))


def test_seg_from_marks_and_pack_group():
    rng = np.random.default_rng(3)
    k, chunk, rows = 9, 256, 4
    seqs = [rng.integers(0, 5, size=n).astype(np.uint8)
            for n in rng.integers(1, 200, size=12)]
    got = pack_group_transfer(seqs, k, chunk, rows, rows * chunk)
    want = jax_pack_group(seqs, k, chunk, rows, rows * chunk)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    _, _, marks, base, _ = got
    seg_j = np.asarray(jops.seg_from_marks(jnp.asarray(marks),
                                           jnp.asarray(base), chunk))
    seg_t = tops.seg_from_marks(torch.from_numpy(marks),
                                torch.from_numpy(base), chunk).numpy()
    np.testing.assert_array_equal(seg_t, seg_j.astype(np.int64))
