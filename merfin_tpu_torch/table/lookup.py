"""Exact k-mer lookup on the host — the host half of
``merfin_tpu/table/lookup.py`` (``HostLookup`` and ``build_lookup``'s
host branch).  The port's device tables are the sorted joins of
``merfin_tpu_torch/ops``.

``value(mer) == 0`` for absent mers, matching merylExactLookup.  -min/-max
filtering (read DB only, merfin-globals.C:136) happens at build by
dropping rows, so filtered mers read as absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from merfin_tpu_torch.io.mkdb import KmerDB


@dataclasses.dataclass
class HostLookup:
    """Numpy fallback with identical semantics (used by tests/tools)."""

    keys: np.ndarray   # uint64 sorted
    vals: np.ndarray   # uint32

    def __call__(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        if self.keys.size == 0:
            return np.zeros(q.shape, dtype=np.uint64)
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, self.keys.size - 1)
        hit = self.keys[idx_c] == q
        return np.where(hit, self.vals[idx_c].astype(np.uint64), np.uint64(0))


def build_lookup(
    db: KmerDB,
    min_v: int = 0,
    max_v: int = 2**64 - 1,
    host: bool = True,
) -> HostLookup:
    """Load an MKDB into a host lookup table, applying value filters.

    Mirrors merylExactLookup::load(db, mem, 0, minV, maxV)
    (merfin-globals.C:156-159): entries outside [min_v, max_v] are absent.
    Only the host table exists here (``host`` must be True).
    """
    if not host:
        raise ValueError("merfin_tpu_torch builds host lookups only")
    keys = np.asarray(db.keys)
    vals = np.asarray(db.vals)
    if min_v > 0 or max_v < 2**64 - 1:
        m = (vals >= min_v) & (vals <= max_v)
        keys, vals = keys[m], vals[m]
    return HostLookup(keys.astype(np.uint64), vals.astype(np.uint32))
