"""Host-precomputed histogram bin tables and their device lookup (port of
``merfin_tpu/score/bin_table.py``).

The -hist bin index trunc((asmK/readK - 1 + 0.1) / 0.2)
(merfin-histogram.C:72,85) is decided by IEEE f64 division.  Both readK
and asmK are integer-valued, so ``BinTable`` (a copy of the JAX
package's host half) tabulates the decision on the host with exact
semantics:

    undr_table[r, a] = C bin of (readK=r, asmK=a)   r in [0,RMAX], a in [0,AMAX]
    over_table[a, r] = C bin of (readK=r, asmK=a)   (the readK>asmK side)

``lookup`` (the port of ``BinTable.lookup_jnp``) gathers them on the
device.  In-range (readK, asmK) pairs take the exact C bins; the rest
take the IEEE **f32** fallback trunc((a/r - 0.9)/0.2), which is what the
JAX package computes on every backend.  torch's f32 division is
correctly rounded on the CPU and on CUDA; the fallback stays f32 on
purpose (it may sit one bin from the reference's f64, and is counted).
"""

from __future__ import annotations

import numpy as np
import torch

RMAX = 64       # readK range covered exactly (peak-normalized copies)
AMAX = 8192     # asmK range covered exactly

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


class BinTable:
    def __init__(self, rmax: int = RMAX, amax: int = AMAX):
        self.rmax = rmax
        self.amax = amax
        r = np.arange(rmax + 1, dtype=np.float64)[:, None]
        a = np.arange(amax + 1, dtype=np.float64)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            undr = np.trunc((a / r - 1.0 + 0.1) / 0.2)
            over = np.trunc((r / a - 1.0 + 0.1) / 0.2)
        # clamp negatives to 0: a (r, a) entry is negative only on the
        # side that never selects it (undr needs a > r -> value > 0 and
        # vice versa), so the clamp is unobservable — and it lets the
        # device planes be u16 (max undr bin ~(amax-1+0.1)/0.2 < 2^16),
        # halving the per-window gather bandwidth of the bin lookups
        self.undr_host = np.maximum(
            np.nan_to_num(undr, nan=0.0, posinf=0.0), 0.0).astype(np.int32)
        self.over_host = np.maximum(
            np.nan_to_num(over, nan=0.0, posinf=0.0), 0.0).astype(np.int32)
        assert int(self.undr_host.max()) <= 0xFFFF
        assert int(self.over_host.max()) <= 0xFFFF


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating float -> int32 cast (XLA's convert semantics; a plain
    torch cast of an out-of-range float is undefined)."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def lookup(bin_table, read_k: torch.Tensor, asm_k: torch.Tensor, arrays):
    """(undr_idx int32, over_idx int32, in_range bool) for integer-valued
    f64 readK/asmK; ``arrays`` = ``convert.bin_table_tensors``."""
    undr_t, over_t = arrays
    rmax, amax = bin_table.rmax, bin_table.amax
    r = _to_i32(read_k)
    a = _to_i32(asm_k)
    in_range = ((read_k <= rmax) & (asm_k <= amax)
                & (read_k == r.to(read_k.dtype))
                & (asm_k == a.to(asm_k.dtype)))
    flat = r.clamp(0, rmax).to(torch.int64) * (amax + 1) \
        + a.clamp(0, amax).to(torch.int64)
    exact_undr = undr_t[flat]
    exact_over = over_t[flat]

    rf = read_k.to(torch.float32)
    af = asm_k.to(torch.float32)
    one = _f32(1.0, rf)
    safe_r = torch.where(rf > 0, rf, one)
    safe_a = torch.where(af > 0, af, one)
    c09, c02 = _f32(0.9, rf), _f32(0.2, rf)
    fb_undr = _to_i32(torch.trunc((af / safe_r - c09) / c02))
    fb_over = _to_i32(torch.trunc((rf / safe_a - c09) / c02))

    undr_idx = torch.where(in_range, exact_undr, fb_undr)
    over_idx = torch.where(in_range, exact_over, fb_over)
    return undr_idx, over_idx, in_range
