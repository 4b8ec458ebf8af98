"""Ordered merge of per-process output shards (a copy of
``merfin_tpu/utils/partmerge.py``).

Multi-host -dump/-variants stripe sequences across processes
(``merfin_tpu_torch/parallel/multihost.py``); each process writes its
rows to a part file with a sequence-indexed extent table, and rank 0
merges the parts back into the single ordered output the reference's in-order writer produces
(merfin.C:384).  Replaces the Slurm scripts' `bcftools concat` gather
(scripts/parallel1/consensus.sh:20-31) with an exact, offset-based merge
over the shared filesystem.

For -resume, a part file is restartable: the owning rank's checkpoint
records (n_extents, byte offset) and the extent table is flushed to the
sidecar `.idx.json` at the same cadence (flush_idx() before each
checkpoint save), so a resumed rank truncates both back to the last
checkpointed state and appends.  The final merge is atomic (tmp +
rename); ranks drop their checkpoints before it runs, so a crash during
the merge re-runs the mode from scratch rather than resuming against
already-consumed parts.
"""

from __future__ import annotations

import json
import os


def _load_idx(path: str) -> list:
    try:
        with open(path + ".idx.json") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return []


def can_resume_part(out_name: str, pid: int, n_ext: int, offset: int) -> bool:
    """True when the on-disk part/idx state can honor a checkpoint that
    recorded (n_ext extents, offset bytes).  Callers must fall back to a
    FRESH run of the rank's work when this is False — resuming the skip
    while silently truncating the part would drop the checkpointed rows
    from the merged output."""
    if n_ext == 0:
        return True
    path = f"{out_name}.part{pid}"
    if not os.path.exists(path) or os.path.getsize(path) < offset:
        return False
    loaded = _load_idx(path)
    if len(loaded) < n_ext:
        return False
    return loaded[n_ext - 1][2] == offset


class PartWriter:
    """One process's shard: appended bytes + per-sequence extents.

    ``resume_state`` is (n_extents, offset) from the rank's checkpoint;
    when given, the extent table and the file are truncated back to that
    state and writing appends.  Callers validate with can_resume_part()
    first; an unusable state raises rather than silently starting over
    (the caller's sequence skip would otherwise lose rows).
    """

    def __init__(self, out_name: str, pid: int,
                 resume_state: tuple[int, int] | None = None):
        self.path = f"{out_name}.part{pid}"
        self.extents: list[list[int]] = []   # [seq_idx, start, end]
        if resume_state is not None and resume_state[0] > 0:
            n_ext, offset = resume_state
            loaded = _load_idx(self.path)
            if (not os.path.exists(self.path)
                    or os.path.getsize(self.path) < offset
                    or len(loaded) < n_ext
                    or loaded[n_ext - 1][2] != offset):
                raise ValueError(
                    f"part file {self.path} cannot honor resume state "
                    f"(n_extents={n_ext}, offset={offset}); "
                    f"re-run the rank fresh")
            self.extents = [list(e) for e in loaded[:n_ext]]
            with open(self.path, "rb+") as f:
                f.truncate(offset)
            self._f = open(self.path, "ab")
            return
        self._f = open(self.path, "wb")

    @property
    def offset(self) -> int:
        return self._f.tell()

    def write_seq(self, seq_idx: int, data: bytes) -> None:
        start = self._f.tell()
        self._f.write(data)
        self.extents.append([seq_idx, start, self._f.tell()])

    def flush_idx(self) -> None:
        """Persist the extent table (atomically) so a checkpoint taken
        now can be resumed against it."""
        self._f.flush()
        tmp = self.path + ".idx.json.tmp"
        with open(tmp, "w") as f:
            json.dump(self.extents, f)
        os.replace(tmp, self.path + ".idx.json")

    def close(self) -> None:
        self._f.flush()
        self._f.close()
        with open(self.path + ".idx.json", "w") as f:
            json.dump(self.extents, f)


def merge_parts(out_name: str, nparts: int, header: bytes = b"") -> None:
    """Concatenate part files in ascending sequence order into out_name
    (atomic: tmp + rename), then remove the parts.  Caller must barrier
    all writers first."""
    rows: list[tuple[int, int, int, int]] = []   # (seq_idx, part, start, end)
    for p in range(nparts):
        idx_path = f"{out_name}.part{p}.idx.json"
        with open(idx_path) as f:
            for seq_idx, start, end in json.load(f):
                rows.append((seq_idx, p, start, end))
    rows.sort()
    handles = [open(f"{out_name}.part{p}", "rb") for p in range(nparts)]
    tmp_out = out_name + ".tmpmerge"
    try:
        with open(tmp_out, "wb") as out:
            out.write(header)
            for _, p, start, end in rows:
                handles[p].seek(start)
                remaining = end - start
                while remaining > 0:
                    chunk = handles[p].read(min(remaining, 1 << 24))
                    if not chunk:
                        raise IOError(f"short part file {out_name}.part{p}")
                    out.write(chunk)
                    remaining -= len(chunk)
    finally:
        for h in handles:
            h.close()
    os.replace(tmp_out, out_name)
    for p in range(nparts):
        os.remove(f"{out_name}.part{p}")
        os.remove(f"{out_name}.part{p}.idx.json")
