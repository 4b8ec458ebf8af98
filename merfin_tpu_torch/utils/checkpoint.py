"""Checkpoint / resume at the per-sequence boundary.

The reference's only resume machinery is file-existence guards in its
Slurm scripts (scripts/parallel1/merfin.sh:55-108: whole array-task
granularity).  Here every mode driver can checkpoint after each
sequence: a sidecar `<out>.ckpt.json` records the number of sequences
completed, the byte offset of the (text) output stream, and the mode's
accumulator state.  Resume truncates the output to the recorded offset
(dropping any partial tail) and restores the accumulators, so a killed
run continues exactly where it left off.

Multi-host runs checkpoint too (the shared filesystem is the same
contract partmerge.py already relies on):

  * striped shape — each rank keeps its own `<out>.rankN.ckpt.json`
    plus its own resumable part file; ranks resume independently (no
    collectives run inside the striped loops).
  * host-spanning mesh shape — every rank drives the same sequences, so
    rank 0's checkpoint is the authoritative shared state: all ranks
    `load()` the same file, only the `writer` rank saves/removes it.
  * All ranks drop their checkpoints at a barrier BEFORE rank 0 merges
    part files: a crash inside the merge window degrades to a full
    (correct) re-run instead of resuming against consumed parts.

The checkpoint write is atomic (tmp + rename).
"""

from __future__ import annotations

import json
import os
from typing import Any


class Checkpoint:
    def __init__(self, out_name: str, mode: str, enabled: bool = True,
                 writer: bool = True):
        self.path = f"{out_name}.ckpt.json" if out_name else None
        self.mode = mode
        self.enabled = enabled and self.path is not None
        self.writer = writer
        self.state: dict[str, Any] | None = None

    def load(self) -> dict[str, Any] | None:
        """State from a previous run of the same mode, if any."""
        if not self.enabled or not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                st = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if st.get("mode") != self.mode:
            return None
        self.state = st
        return st

    def save(self, seqs_done: int, output_offset: int, accum: dict[str, Any]) -> None:
        if not self.enabled or not self.writer:
            return
        st = {
            "mode": self.mode,
            "seqs_done": seqs_done,
            "output_offset": output_offset,
            "accum": accum,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, self.path)

    def done(self) -> None:
        """Remove the checkpoint on successful completion."""
        if self.enabled and self.writer and os.path.exists(self.path):
            os.remove(self.path)


def truncate_to(path: str, offset: int) -> None:
    """Drop any partially-written tail beyond the checkpointed offset."""
    if os.path.exists(path) and offset >= 0:
        with open(path, "rb+") as f:
            f.truncate(offset)
