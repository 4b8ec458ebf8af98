"""Host-precomputed getK value map and its device lookup (port of
``merfin_tpu/score/value_map.py``).

merfin's readK is boundary-sensitive (merfin-globals.C:84-97), so the
whole v -> (readK, prob) function is evaluated ONCE on the host with
exact IEEE semantics for every possible raw value (``ValueMap``, a copy
of the JAX package's host half) and gathered on the device (``lookup``,
the port of ``ValueMap.lookup_jnp``); nothing boundary-sensitive is
recomputed on the device.  Values above the cap (possible only via
palindrome doubling beyond the largest DB count) fall back to a
device-side computation and are counted so callers can warn.
"""

from __future__ import annotations

import numpy as np
import torch

from merfin_tpu_torch.score.kstar import ProbTable, get_k_np


class ValueMap:
    """Gather tables: raw read-DB value -> (readK, prob)."""

    def __init__(self, peak: float, prob_table: ProbTable | None,
                 max_value: int, hard_cap: int = 1 << 22,
                 exact_max: bool = False):
        self.peak = float(peak)
        # fmer+rmer palindrome doubling can reach 2 * max DB value;
        # quantize to a power of two for compiled-program reuse
        vcap = int(min(max(2 * max_value, 2), hard_cap))
        self.vcap = max(2, 1 << (vcap - 1).bit_length())
        # exact_max: the caller asserts max_value is the TRUE DB maximum
        # (the CLI scans the DB); then no raw value can exceed vcap and
        # the device fallback division + overflow counter compile away.
        # Callers passing a guessed max keep the counted fallback.
        self.never_overflows = bool(exact_max) and self.vcap >= 2 * max_value
        v = np.arange(self.vcap + 1, dtype=np.uint64)
        read_k, _, prob = get_k_np(v, np.zeros_like(v), peak, prob_table)
        self.read_k_host = read_k          # float64, integer-valued (or inf)
        self.prob_host = prob
        # prob == 1.0 everywhere without a -prob table: consumers skip
        # the stale-prob forward-fill scans entirely then
        self.has_prob = prob_table is not None and len(prob_table) > 0

    def fits_u32(self, k: int) -> bool:
        """True when readK/asmK provably fit uint32 so positional
        fetches can ride the wire as u32 instead of f64.

        Requires never_overflows: when the overflow fallback can fire
        (raw value > vcap), readK = round(v/peak) is unbounded and a
        u32 cast would silently corrupt output.  With the fallback
        compiled away, table readK <= vcap/peak <= 2^22/0.01 < 2^32,
        and odd k forbids palindrome fmer+rmer doubling of asm_v
        beyond the single DB value (itself < 2^32).
        """
        return self.never_overflows and self.peak >= 0.01 and k % 2 == 1

    def f32_map_ok(self) -> bool:
        """True when the readK plane can ship as f32 without loss:
        every value is a finite integer < 2^24 (f32-exact) and the
        overflow fallback is compiled away.  Halves the bandwidth of
        the per-window readK gather; the consumer casts back to f64
        after the gather, bit-exactly."""
        return (self.never_overflows
                and bool(np.isfinite(self.read_k_host).all())
                and float(self.read_k_host.max()) < 2**24)

    def _int_map_ok(self) -> bool:
        """Every readK in the map is finite and fits int32."""
        return (bool(np.isfinite(self.read_k_host).all())
                and float(self.read_k_host.max()) < 2**31)

    def readk_bound(self) -> int | None:
        """Largest readK this map can emit, or None when unbounded
        (overflow fallback live or non-finite entries).  Trace-time
        bound for integer-only device paths."""
        if self.never_overflows and self._int_map_ok():
            return int(self.read_k_host.max())
        return None

    def int_scorer_ok(self) -> bool:
        """True when the fused scorers can run their integer fast path:
        no prob table (prob == 1 everywhere), no overflow fallback, and
        every readK fits int32 (_int_map_ok).  Then missing/K-delta
        math is pure integer arithmetic — EXACTLY equal to the host
        scorer's f64 sums of the same integers, and ~an order of
        magnitude cheaper than emulated-f64 on TPU (docs/PERF.md r4)."""
        return (not self.has_prob and self.never_overflows
                and self._int_map_ok())


def lookup(value_map, seq_value: torch.Tensor, arrays):
    """(readK f64, prob f64, overflow count) for raw summed DB values.

    seq_value: int64 raw values (already fmer+rmer summed);
    arrays: ``convert.value_map_tensors(value_map, device)``.  Values
    above ``vcap`` take the float fallback floor(v/peak + 0.5) and are
    counted, exactly as the JAX package does.
    """
    rk_map, pr_map = arrays
    v = seq_value.to(torch.int64)
    idx = v.clamp(max=value_map.vcap)
    read_k = rk_map[idx]
    if value_map.has_prob:
        prob = pr_map[idx]
    else:
        prob = torch.ones_like(read_k)
    if value_map.never_overflows:
        return read_k, prob, torch.zeros((), dtype=torch.int64,
                                          device=v.device)
    over = v > value_map.vcap
    if value_map.peak != 0:
        fb = torch.floor(v.to(torch.float64) / value_map.peak + 0.5)
    else:
        fb = torch.where(v > 0, float("inf"), 0.0).to(torch.float64)
    read_k = torch.where(over, fb, read_k)
    prob = torch.where(over, torch.ones_like(prob), prob)
    return read_k, prob, over.sum()
