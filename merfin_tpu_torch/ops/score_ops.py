"""Device-side K*/QV scoring math (port of ``merfin_tpu/ops/score_ops.py``,
the torch twin of ``score/kstar.py``'s numpy functions).

Float64 throughout so results track the reference's C++ doubles.  No
mode calls these: the engines gather getK from the host-exact value map
(``score/value_map.py``); they are kept for parity with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from merfin_tpu_torch.score.kstar import ProbTable


def prob_table_arrays(prob_table: ProbTable | None, device=None):
    """(copy_k int64, copy_p f64, length) of the -prob override on
    ``device``, padded to at least one entry."""
    if prob_table is None or len(prob_table) == 0:
        return (torch.zeros(1, dtype=torch.int64, device=device),
                torch.ones(1, dtype=torch.float64, device=device), 0)
    return (torch.from_numpy(prob_table.copy_k.astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(prob_table.copy_p,
                                        np.float64)).to(device),
            len(prob_table))


def get_k(seq_value, asm_value, peak: float, copy_k, copy_p,
          table_len: int):
    """getK (merfin-globals.C:66-98), elementwise: int64 raw DB values
    -> (readK, asmK, prob) f64."""
    v = seq_value.to(torch.float64)
    asm_k = asm_value.to(torch.float64)
    if peak != 0:
        ratio = v / peak
    else:
        ratio = torch.where(v > 0, float("inf"), 0.0).to(torch.float64)
    read_k = torch.floor(ratio + 0.5)   # C round(): half away from zero, v >= 0
    read_k = torch.where(v < peak, 1.0, read_k)
    read_k = torch.where(v == 0, 0.0, read_k)
    prob = torch.ones_like(read_k)
    if table_len > 0:
        iv = seq_value.to(torch.int64)
        in_table = (iv > 0) & (iv <= table_len)
        idx = (iv - 1).clamp(0, table_len - 1)
        read_k = torch.where(in_table, copy_k[idx].to(torch.float64), read_k)
        prob = torch.where(in_table, copy_p[idx], prob)
    return read_k, asm_k, prob


def k_metric(read_k, asm_k):
    """getKmetric (merfin-globals.H:248-261)."""
    under = -(asm_k / read_k - 1.0)
    over = read_k / asm_k - 1.0
    out = torch.where(asm_k > read_k, under,
                      torch.where(asm_k < read_k, over, 0.0))
    return torch.where(read_k == 0, 0.0, out)
