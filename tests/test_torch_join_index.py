"""The kernels' table-side indexes (CPU side): the union and
single-value tables keep the fence index keys[::16] on their device and
count it in nbytes(); the window join's table keeps the wrapped u32
prefix column of its values instead.  The kernels themselves run on the
card only (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
from merfin_tpu_torch.ops.union_join import (FENCE_STRIDE, UnionTable,
                                             fence_index, union_join_kernel)
from merfin_tpu_torch.ops.window_join import SortJoinTable


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    top = np.iinfo(np.uint64).max
    keys = np.unique(rng.integers(0, top, size=n + 64, dtype=np.uint64))
    return keys[:n], rng.integers(0, 1 << 32, size=n).astype(np.uint32)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1000])
def test_union_table_fences(n):
    keys, vals = _keys(n)
    t = UnionTable(keys, vals, vals[::-1].copy(), "cpu")
    want = keys[::FENCE_STRIDE]
    assert t.index.is_contiguous() and t.index.dtype == torch.int64
    np.testing.assert_array_equal(t.index.numpy().view(np.uint64), want)
    assert t.nbytes() == 16 * n + 8 * want.size


@pytest.mark.parametrize("n", [0, 1, 16, 33, 1000])
def test_single_value_table_fences(n):
    keys, vals = _keys(n, seed=1)
    t = SortedJoinTable(keys, vals, "cpu")
    want = keys[::FENCE_STRIDE]
    np.testing.assert_array_equal(t.index.numpy().view(np.uint64), want)
    assert t.nbytes() == 12 * n + 8 * want.size
    w = SortJoinTable(keys, vals, "cpu")
    pre = np.concatenate([[0], np.cumsum(vals, dtype=np.uint32)])
    assert w.index.dtype == torch.int32 and w.index.is_contiguous()
    np.testing.assert_array_equal(w.index.numpy().view(np.uint32), pre)
    assert w.nbytes() == 12 * n + 4 * (n + 1)


def test_kernel_wrapper_rejects_a_wrong_fence_index():
    keys = torch.arange(100, dtype=torch.int64)
    with pytest.raises(ValueError, match="fence index"):
        union_join_kernel.windows(keys, fence_index(keys)[:-1], keys)
