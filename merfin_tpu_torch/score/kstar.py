"""K* / QV scoring math — the exact reference semantics, vectorized.

This module is the single source of truth for the score layer of the
torch port, a copy of ``merfin_tpu/score/kstar.py``.  The device paths
take readK from host tables built with these formulas (``ValueMap``,
``BinTable``); tests assert they agree bit-for-bit on float64.

Reference semantics:
  * getK        — merfin-globals.C:66-98
  * getKmetric  — merfin-globals.H:248-261
  * histoQV     — merfin-histogram.C:22-31 (the Merqury QV formula)
  * histogram binning — merfin-histogram.C:71-90
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ProbTable:
    """The -prob lookup table (GenomeScope-fitted copy numbers).

    ``copy_k[v-1]`` / ``copy_p[v-1]`` give readK and probability for a raw
    read-DB value ``v`` in [1, len(table)] (merfin-globals.C:93-97).
    """

    copy_k: np.ndarray  # uint32
    copy_p: np.ndarray  # float64

    @classmethod
    def empty(cls) -> "ProbTable":
        return cls(np.zeros(0, np.uint32), np.zeros(0, np.float64))

    def __len__(self) -> int:
        return int(self.copy_k.shape[0])


def get_k_np(
    seq_value: np.ndarray,
    asm_value: np.ndarray,
    peak: float,
    prob_table: ProbTable | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized getK (merfin-globals.C:66-98).

    seq_value: raw read-DB counts (integer array)
    asm_value: raw assembly-DB counts (integer array)
    Returns (readK, asmK, prob) float64 arrays:
      readK = 0 if v==0; 1 if v<peak; round-half-away(v/peak) otherwise,
      overridden by the prob table when 1 <= v <= len(table).
      asmK  = asm_value as float; prob defaults to 1.0.
    """
    v = np.asarray(seq_value, dtype=np.float64)
    asm_k = np.asarray(asm_value, dtype=np.float64)

    # C round() is round-half-away-from-zero; v/peak >= 0 so floor(x+0.5).
    # peak == 0 (allowed in -filter mode, merfin.C:168) gives v/0 == +inf in
    # C too; the v==0 / v<peak overrides below reproduce the branch order.
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = v / peak if peak != 0 else np.where(v > 0, np.inf, 0.0)
    read_k = np.floor(ratio + 0.5)
    read_k = np.where(v < peak, 1.0, read_k)
    read_k = np.where(v == 0, 0.0, read_k)
    prob = np.ones_like(read_k)

    if prob_table is not None and len(prob_table) > 0:
        iv = np.asarray(seq_value, dtype=np.int64)
        in_table = (iv > 0) & (iv <= len(prob_table))
        idx = np.clip(iv - 1, 0, len(prob_table) - 1)
        read_k = np.where(in_table, prob_table.copy_k[idx].astype(np.float64), read_k)
        prob = np.where(in_table, prob_table.copy_p[idx], prob)

    return read_k, asm_k, prob


def k_metric_np(read_k: np.ndarray, asm_k: np.ndarray) -> np.ndarray:
    """Vectorized getKmetric (merfin-globals.H:248-261): 0-centered K*.

    readK==0 -> 0; asmK>readK -> -(asmK/readK-1); asmK<readK -> readK/asmK-1.
    """
    read_k = np.asarray(read_k, dtype=np.float64)
    asm_k = np.asarray(asm_k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        under = -(asm_k / read_k - 1.0)   # assembly has extra copies
        over = read_k / asm_k - 1.0       # assembly is missing copies
    out = np.where(asm_k > read_k, under, np.where(asm_k < read_k, over, 0.0))
    return np.where(read_k == 0, 0.0, out)


def histo_qv(kval: float, ktot: float, k: int) -> float:
    """QV of kval 'error' k-mers among ktot (merfin-histogram.C:22-31)."""
    if ktot <= 0:
        return float("nan")
    base = kval / ktot
    kinv = 1.0 / k
    with np.errstate(divide="ignore", invalid="ignore"):
        # C pow/log10 semantics: log10(0) = -inf (kval == 0 -> QV inf);
        # negative pow base -> nan.
        inner = 1.0 - np.float64(1.0 - base) ** kinv
        return float(-10.0 * np.log10(inner))


def hist_bin_np(
    read_k: np.ndarray, asm_k: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Histogram bucket per k-mer (merfin-histogram.C:66-90).

    Returns (missing, undr_idx, over_idx) where exactly one of the three
    applies per element:
      missing        : readK == 0
      undr (asmK>readK): idx = trunc((asmK/readK - 1 + 0.1) / 0.2)
      over (else)     : idx = trunc((readK/asmK - 1 + 0.1) / 0.2)
    Non-applicable entries hold -1.  Truncation is the C uint32 cast
    (toward zero; operands are non-negative).
    """
    read_k = np.asarray(read_k, dtype=np.float64)
    asm_k = np.asarray(asm_k, dtype=np.float64)
    missing = read_k == 0

    with np.errstate(divide="ignore", invalid="ignore"):
        undr = np.trunc((asm_k / read_k - 1.0 + 0.1) / 0.2).astype(np.int64)
        over = np.trunc((read_k / asm_k - 1.0 + 0.1) / 0.2).astype(np.int64)

    is_undr = (~missing) & (asm_k > read_k)
    is_over = (~missing) & ~is_undr
    undr_idx = np.where(is_undr, undr, -1)
    over_idx = np.where(is_over, over, -1)
    return missing, undr_idx, over_idx


def kover_cpy_np(read_k: np.ndarray, asm_k: np.ndarray, prob: np.ndarray) -> np.ndarray:
    """Per-kmer QV* excess term for undr k-mers (merfin-histogram.C:81):
    (1 - readK/asmK) * prob where asmK > readK and readK > 0, else 0."""
    read_k = np.asarray(read_k, dtype=np.float64)
    asm_k = np.asarray(asm_k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        term = (1.0 - read_k / asm_k) * np.asarray(prob, dtype=np.float64)
    return np.where((read_k > 0) & (asm_k > read_k), term, 0.0)
