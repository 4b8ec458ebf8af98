"""Out-of-core support for k-mer counting and import (a copy of
``merfin_tpu/count/spill.py``).

meryl's role in the reference includes out-of-core counting: a human 30x
read set has ~2-3G distinct k-mers, more than host RAM alongside the rest
of the pipeline (SURVEY.md §2.2).  Two pieces provide the same property
here:

  * SpillStore — sorted (key, value) runs on disk, each partitioned by
    the 64-way MKDB prefix so the final merge works slice by slice in
    bounded memory.
  * MkdbStreamWriter — writes an MKDB without ever holding the full
    key/value arrays: raw appends to temp files, then a streamed convert
    to .npy plus the mkdb.json metadata.

The merge order is deterministic (runs in creation order, then the
in-memory remainder), so spilled and in-memory counting produce
byte-identical databases.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from merfin_tpu_torch.io.mkdb import SLICES, FORMAT, KmerDB


def slice_offsets_of(keys: np.ndarray, k: int) -> np.ndarray:
    """65 offsets partitioning sorted keys by the top-6-bit prefix."""
    shift = np.uint64(max(0, 2 * k - 6))
    prefixes = (keys >> shift).astype(np.int64) if keys.size else np.zeros(0, np.int64)
    return np.searchsorted(prefixes, np.arange(SLICES + 1), side="left")


class SpillStore:
    """Sorted runs on disk, sliceable by MKDB prefix."""

    def __init__(self, base_dir: str | None = None, k: int = 21):
        self.k = k
        self._own = base_dir is None
        self.dir = base_dir or tempfile.mkdtemp(prefix="mkdb_spill_")
        os.makedirs(self.dir, exist_ok=True)
        # wipe stale run files (a previous crashed run would otherwise
        # silently merge into the new database via the meta sidecars)
        for name in os.listdir(self.dir):
            if name.startswith("run") and name.split(".", 1)[-1] in (
                    "keys", "vals", "meta.json"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        self.runs: list[tuple[str, np.ndarray]] = []   # (prefix, offsets[65])

    def spill(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Write one sorted run (uint64 keys, uint64 vals)."""
        import json

        i = len(self.runs)
        prefix = os.path.join(self.dir, f"run{i:04d}")
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.uint64)
        keys.tofile(prefix + ".keys")
        vals.tofile(prefix + ".vals")
        offs = slice_offsets_of(keys, self.k)
        # sidecar so another process (multi-host rank 0) can gather runs
        with open(prefix + ".meta.json", "w") as f:
            json.dump([int(x) for x in offs], f)
        self.runs.append((prefix, offs))

    @classmethod
    def gather(cls, dirs: list[str], k: int) -> "SpillStore":
        """A read-only store over every run found under ``dirs`` (in dir
        order, run order) — the multi-host gather: each rank spilled its
        stripe's runs to a shared filesystem, rank 0 merges them all."""
        import json

        store = cls.__new__(cls)
        store.k = k
        store._own = False
        store.dir = dirs[0] if dirs else "."
        store.runs = []
        for d in dirs:
            for name in sorted(os.listdir(d)):
                if name.endswith(".meta.json"):
                    prefix = os.path.join(d, name[: -len(".meta.json")])
                    with open(os.path.join(d, name)) as f:
                        offs = np.asarray(json.load(f), dtype=np.int64)
                    store.runs.append((prefix, offs))
        return store

    def run_slice(self, run: int, s: int) -> tuple[np.ndarray, np.ndarray]:
        prefix, offs = self.runs[run]
        a, b = int(offs[s]), int(offs[s + 1])
        n = b - a
        if n == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        keys = np.fromfile(prefix + ".keys", dtype=np.uint64, count=n, offset=a * 8)
        vals = np.fromfile(prefix + ".vals", dtype=np.uint64, count=n, offset=a * 8)
        return keys, vals

    def cleanup(self) -> None:
        if self._own:
            shutil.rmtree(self.dir, ignore_errors=True)
        else:
            for prefix, _ in self.runs:
                for ext in (".keys", ".vals", ".meta.json"):
                    try:
                        os.remove(prefix + ext)
                    except OSError:
                        pass
        self.runs = []


def _merge_slice(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Merge sorted (keys, vals) parts, summing duplicate keys."""
    keys = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    if keys.size == 0:
        return keys, vals
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    boundary = np.empty(keys.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(boundary)
    return keys[starts], np.add.reduceat(vals, starts)


class MkdbStreamWriter:
    """Write an MKDB from ascending sorted (keys, vals) appends.

    Appends go to raw temp files; finish() converts them to the .npy
    layout in bounded chunks and writes mkdb.json — the full arrays are
    never resident.
    """

    def __init__(self, path: str, k: int):
        self.path = path
        self.k = k
        os.makedirs(path, exist_ok=True)
        self._kf = open(os.path.join(path, "keys.raw"), "wb")
        self._vf = open(os.path.join(path, "vals.raw"), "wb")
        self._n = 0
        self._last_key: int | None = None
        self._prefix_counts = np.zeros(SLICES, dtype=np.int64)
        self._shift = np.uint64(max(0, 2 * k - 6))

    def append(self, keys: np.ndarray, vals: np.ndarray) -> None:
        if keys.size == 0:
            return
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals32 = np.ascontiguousarray(vals, dtype=np.uint32)
        if np.asarray(vals).max(initial=0) > 0xFFFFFFFF:
            raise ValueError("k-mer count exceeds uint32 (unsupported)")
        assert keys.size < 2 or bool(np.all(keys[1:] > keys[:-1]))
        if self._last_key is not None:
            assert int(keys[0]) > self._last_key, "appends must be ascending"
        self._last_key = int(keys[-1])
        keys.tofile(self._kf)
        vals32.tofile(self._vf)
        self._n += keys.size
        self._prefix_counts += np.bincount(
            (keys >> self._shift).astype(np.int64), minlength=SLICES)

    def finish(self, total: int) -> KmerDB:
        import json

        self._kf.close()
        self._vf.close()
        for name, dtype in (("keys", np.uint64), ("vals", np.uint32)):
            raw = os.path.join(self.path, f"{name}.raw")
            out = os.path.join(self.path, f"{name}.npy")
            with open(out, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                        "fortran_order": False, "shape": (self._n,)})
                with open(raw, "rb") as r:
                    shutil.copyfileobj(r, f, 1 << 24)
            os.remove(raw)
        offsets = np.concatenate([[0], np.cumsum(self._prefix_counts)])
        meta = {
            "format": FORMAT,
            "k": int(self.k),
            "distinct": int(self._n),
            "total": int(total),
            "slice_offsets": [int(x) for x in offsets],
        }
        with open(os.path.join(self.path, "mkdb.json"), "w") as f:
            json.dump(meta, f)
        return KmerDB(self.path)


def merge_to_mkdb(
    path: str,
    k: int,
    store: SpillStore,
    mem_parts: list[tuple[np.ndarray, np.ndarray]],
    total: int,
) -> KmerDB:
    """Slice-by-slice merge of spilled runs + in-memory remainder parts
    into a new MKDB; peak memory is one merged slice, not the database."""
    mem_offs = [slice_offsets_of(p[0], k) for p in mem_parts]
    writer = MkdbStreamWriter(path, k)
    for s in range(SLICES):
        parts = [store.run_slice(r, s) for r in range(len(store.runs))]
        for (mk, mv), offs in zip(mem_parts, mem_offs):
            a, b = int(offs[s]), int(offs[s + 1])
            parts.append((mk[a:b], mv[a:b]))
        keys, vals = _merge_slice(parts)
        writer.append(keys, vals)
    db = writer.finish(total)
    store.cleanup()
    return db
