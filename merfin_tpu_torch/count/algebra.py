"""Set algebra over MKDB databases (a copy of
``merfin_tpu/count/algebra.py``) — the meryl operations merfin's
companion scripts rely on (scripts/qv.sh:33-41 uses intersect,
divide-round, subtract, print, statistics).

All operations are sorted-array merges over the globally sorted key
arrays; results are new MKDBs.  Value conventions follow meryl:
  intersect     kmers present in ALL inputs; value from the FIRST input
  union_sum     kmers present in ANY input; values summed
  subtract      kmers of the first input; value minus the sum of the
                others' values; dropped when <= 0
  divide_round  value = round(value / d); dropped when it rounds to 0
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.io.mkdb import KmerDB


def _load(db: KmerDB) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(db.keys, dtype=np.uint64), np.asarray(db.vals, dtype=np.uint64)


def _values_in(keys: np.ndarray, other_keys, other_vals) -> np.ndarray:
    """Value of each of `keys` in the other db (0 if absent)."""
    if other_keys.size == 0:
        return np.zeros(keys.size, dtype=np.uint64)
    idx = np.searchsorted(other_keys, keys)
    idx_c = np.minimum(idx, other_keys.size - 1)
    hit = other_keys[idx_c] == keys
    return np.where(hit, other_vals[idx_c], np.uint64(0))


def intersect(out_path: str, first: KmerDB, *others: KmerDB) -> KmerDB:
    keys, vals = _load(first)
    mask = np.ones(keys.size, dtype=bool)
    for db in others:
        ok, ov = _load(db)
        mask &= _values_in(keys, ok, ov) > 0
    return KmerDB.create(out_path, first.k, keys[mask], vals[mask].astype(np.uint32))


def union_sum(out_path: str, *dbs: KmerDB) -> KmerDB:
    assert dbs
    keys = np.zeros(0, np.uint64)
    vals = np.zeros(0, np.uint64)
    for db in dbs:
        ok, ov = _load(db)
        allk = np.concatenate([keys, ok])
        allv = np.concatenate([vals, ov])
        order = np.argsort(allk, kind="stable")
        allk, allv = allk[order], allv[order]
        if allk.size:
            b = np.empty(allk.size, dtype=bool)
            b[0] = True
            b[1:] = allk[1:] != allk[:-1]
            starts = np.flatnonzero(b)
            keys = allk[starts]
            vals = np.add.reduceat(allv, starts)
        else:
            keys, vals = allk, allv
    return KmerDB.create(out_path, dbs[0].k, keys, vals.astype(np.uint32))


def subtract(out_path: str, first: KmerDB, *others: KmerDB) -> KmerDB:
    keys, vals = _load(first)
    vals = vals.astype(np.int64)
    for db in others:
        ok, ov = _load(db)
        vals = vals - _values_in(keys, ok, ov).astype(np.int64)
    mask = vals > 0
    return KmerDB.create(out_path, first.k, keys[mask], vals[mask].astype(np.uint32))


def divide_round(out_path: str, db: KmerDB, d: float) -> KmerDB:
    keys, vals = _load(db)
    newv = np.floor(vals.astype(np.float64) / d + 0.5)  # round half away (v >= 0)
    mask = newv > 0
    return KmerDB.create(out_path, db.k, keys[mask], newv[mask].astype(np.uint32))


def statistics(db: KmerDB) -> dict:
    vals = np.asarray(db.vals, dtype=np.uint64)
    return {
        "k": db.k,
        "unique": int(np.count_nonzero(vals == 1)),
        "distinct": int(vals.size),
        "present": int(vals.sum()),
    }


def histogram(db: KmerDB) -> dict[int, int]:
    vals = np.asarray(db.vals, dtype=np.int64)
    uniq, counts = np.unique(vals, return_counts=True)
    return {int(v): int(c) for v, c in zip(uniq, counts)}
