"""-completeness: each pass is ``modes/completeness.py:run_completeness``,
streaming the whole read DB through the single-value sorted join
against an assembly table built once in set-up
(``build_asm_table``, ``asm_table_s``), as the CLI does for one job.
No union table and no engine step: the bypass cell of both.

A pass's work is the read DB's k-mers.  Each pass's per-slice lines and
totals are checked against ``reference/completeness.py``.
"""

from __future__ import annotations

import io

from portbench.memdb import MemDB

RATE = ("completeness_kmers_per_s", "kmers/s")


def wrap(spans) -> None:
    """To name the trace's idle gaps: each block's device program, and
    the waits for the next block from the prefetch thread."""
    from merfin_tpu_torch.modes import completeness

    spans.wrap(completeness, "block_stats", "block program")
    spans.wrap(completeness, "prefetch_iter", "block wait")


def unwrap(spans) -> None:
    spans.unwrap()


class Bench:
    def __init__(self, ctx, world, config, traffic):
        from merfin_tpu_torch.modes.completeness import build_asm_table

        self.ctx = ctx
        self.block = int(traffic["block"])
        with ctx.stage("load_s"):
            self.read_db = MemDB("read.mkdb", world.k, world.read_keys,
                                 world.read_vals)
            self.asm_db = MemDB("asm.mkdb", world.k, world.asm_keys,
                                world.asm_vals)
        with ctx.stage("asm_table_s"):
            self.table = build_asm_table(self.asm_db, world.k, self.block,
                                         ctx.device)
        self.peak = world.peak
        self.work = self.read_db.distinct
        self.outputs: list = []

    def one_pass(self) -> int:
        from merfin_tpu_torch.modes.completeness import run_completeness

        log = io.StringIO()
        res = run_completeness(self.read_db, self.asm_db, self.peak,
                               log=log, block=self.block,
                               asm_table=self.table)
        self.ctx.sync()
        self.outputs.append((log.getvalue(), res["completeness"]))
        return self.work

    def counters(self) -> dict:
        t = self.table
        return {"asm_table": type(t).__name__,
                "asm_table_bytes": t.nbytes()}

    def close(self) -> None:
        self.table = None


def setup(ctx, world, config, traffic) -> Bench:
    return Bench(ctx, world, config, traffic)


def compare(expected: dict, got) -> dict:
    log, completeness = got
    lines = [ln for ln in log.splitlines() if ln.strip()]
    want = expected["lines"]
    off = sum(a != b for a, b in zip(lines, want)) + abs(len(lines)
                                                         - len(want))
    ref = expected["completeness"]
    return {"lines_off": off,
            "completeness_gap": abs(completeness - ref) / abs(ref)}


def judge(world, outputs, traffic, device) -> list[dict]:
    """The compared numbers of each pass against the reference's."""
    from portbench.reference.completeness import expected_completeness

    exp = expected_completeness(world, device)
    return [compare(exp, got) for got in outputs]


def control(world, traffic, device) -> dict:
    """The numbers of the control, the reference in the program's place
    with lookups by 32-bit key fingerprints, against the exact
    reference."""
    from portbench.reference.completeness import (as_output,
                                                  expected_completeness)

    exp = expected_completeness(world, device)
    return {"fingerprint": compare(exp, as_output(
        expected_completeness(world, device, control="fp32")))}
