"""-prob lookup table parser (merfin-globals.C:21-62).

The file is comma-separated ``readK,probability`` lines; line N (1-based
among *valid* lines) gives readK/prob for raw read-DB value N.  Invalid
lines are reported and skipped, exactly like the reference.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from merfin_tpu_torch.io.compressed import open_read_text
from merfin_tpu_torch.score.kstar import ProbTable


def load_prob_table(path: str, log=sys.stderr) -> ProbTable:
    if not os.path.exists(path):
        print(f"ERROR: Probability table (-prob) file '{path}' doesn't exist!", file=log)
        raise SystemExit(1)

    print(f"-- Loading probability table '{path}'.\n", file=log)

    copy_k: list[int] = []
    copy_p: list[float] = []
    line_num = 0
    with open_read_text(path) as f:
        for raw in f:
            line = raw.rstrip("\n").rstrip("\r")
            words = line.split(",")
            if len(words) == 2:
                try:
                    k = int(words[0])
                    p = float(words[1])
                except ValueError:
                    print(f"Copy-number: invalid line {line_num}:  '{line}'", file=log)
                    continue
                copy_k.append(k)
                copy_p.append(p)
                line_num += 1
                print(f"Copy-number: {line_num}\t\tReadK: {k}\tProbability: {p:f}", file=log)
            else:
                print(f"Copy-number: invalid line {line_num}:  '{line}'", file=log)

    return ProbTable(np.asarray(copy_k, np.uint32), np.asarray(copy_p, np.float64))
