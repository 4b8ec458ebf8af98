"""The single-value sorted-join table builder (port of
``merfin_tpu/ops/sortjoin.py:build_sortjoin_table``): the kernel choice in
one place.

The JAX rule is kept as it is: the window join (v1) when the table has
at most twice as many keys as one dispatch has queries (the TPU's v1
streams each query block's whole window), the sorted join (v4)
otherwise; ``prefer`` pins either.  On the card both are windowed
kernels (``csrc/window_join.cu``, ``csrc/union_join.cu``); PERF.md §7
records how the rule's choice fits them.  The device is explicit; on the
CPU either table runs its plain version.
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
from merfin_tpu_torch.ops.window_join import SortJoinTable


def build_sortjoin_table(keys: np.ndarray, vals: np.ndarray, k: int,
                         query_windows: int, prefer: str = "auto",
                         device=None):
    """Table for host (keys, vals) given the caller's per-dispatch query
    count; ``prefer`` is "v1", "v4" or "auto" (the ratio rule).  ``k`` is
    kept for the JAX signature: the port's tables take any key width."""
    from merfin_tpu_torch.device import get_device

    if prefer == "v1":
        cls = SortJoinTable
    elif prefer == "v4":
        cls = SortedJoinTable
    elif prefer == "auto":
        ratio = np.asarray(keys).size / max(int(query_windows), 1)
        cls = SortJoinTable if ratio <= 2 else SortedJoinTable
    else:
        raise ValueError(f"prefer={prefer!r}: expected 'v1', 'v4' or 'auto'")
    return cls(keys, vals, get_device() if device is None else device)
