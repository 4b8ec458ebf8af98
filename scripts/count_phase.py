#!/usr/bin/env python3
"""The counter's phase of chip_smoke.py alone, repeated, on one CUDA card:

    python3 scripts/count_phase.py [--reps 2] [--seed 0] [--mbp 64]

Makes chip_smoke.py's full world (the 64 Mbp assembly and its DBs),
runs its -completeness phase once (whose lines the counted DB must
reproduce), then phase 9 --reps times: the assembly counted by
-completeness without -seqmers, a 256 Mbp read set counted in RAM and
with memory=0.25, each checked as chip_smoke.py checks it, with walls
and the split of each count (chip_smoke.py:count_split).  Repeating it
in one call gives the run-to-run spread on one card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=float, default=64.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("count_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    os.environ["MERFIN_PLATFORM"] = "cuda"
    cs.say(f"  {cs.smi_line()}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        w = cs.full_world(os.path.join(d, "full"), args.seed, args.mbp,
                          128 << 20, "cuda")
        cs.say(f"  full world ({time.perf_counter() - t0:.1f} s)")
        cs._run_completeness_full(w, os.path.join(d, "compl"))
        for rep in range(args.reps):
            with cs.phase(f"9 count full, run {rep}"):
                cs._run_count_full(w, os.path.join(d, f"count{rep}"),
                                   args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
