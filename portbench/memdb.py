"""Databases held in memory, handed to the program as ``KmerDB`` handles.

A world's DB arrays take 4-5 GiB, so they are never written: ``MemDB``
sets the attributes ``merfin_tpu_torch.io.mkdb.KmerDB.__init__`` sets,
from arrays, with the 64 prefix slices ``KmerDB.create`` would write.
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.io.mkdb import FORMAT, SLICES, KmerDB


class MemDB(KmerDB):
    """A read-only MKDB handle on sorted unique ``keys`` and ``vals``."""

    def __init__(self, name: str, k: int, keys: np.ndarray,
                 vals: np.ndarray):
        keys = np.ascontiguousarray(keys, np.uint64)
        vals = np.ascontiguousarray(vals, np.uint32)
        shift = np.uint64(max(0, 2 * k - 6))
        offsets = np.searchsorted((keys >> shift).astype(np.int64),
                                  np.arange(SLICES + 1), side="left")
        self.path = name
        self.k = int(k)
        self.distinct = int(keys.size)
        self.total = int(vals.sum(dtype=np.uint64))
        self.slice_offsets = offsets.astype(np.int64)
        self.meta = {"format": FORMAT, "k": self.k, "distinct": self.distinct,
                     "total": self.total,
                     "slice_offsets": [int(x) for x in offsets]}
        self.keys = keys
        self.vals = vals
