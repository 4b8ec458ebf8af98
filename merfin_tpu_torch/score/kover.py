"""Integer QV* excess parts on the device and their exact host finish
(port of ``merfin_tpu/score/kover.py``).

Each undr window's term (1 - readK/asmK) * prob is a function of small
integers, so the device only COUNTS (``kover_parts``): windows per (raw
v, asmK) for values inside the prob table, and per asmK the window count
and readK sum for the rest.  ``finish_kover`` (a copy of the JAX
package's) turns the parts into koverCpy in exact IEEE on the host.
Windows outside the covered ranges keep the counted f64 fallback sum,
whose value depends on summation order.

The counts come from one key sort plus a prefix sum read at the key
boundaries: no scatter, no atomics, exact integers.
"""

from __future__ import annotations

import numpy as np
import torch

VMAXP_CAP = 16   # prob-table rows covered exactly (GenomeScope tables
                 # are ~4-10 rows; longer tables fall back per-window)
RMAX_PLAIN = 1 << 30   # readK payload must fit the sort's int lane


def kover_vmaxp(prob_table) -> int:
    """Exact-v rows for this table (0 without a table)."""
    if prob_table is None or len(prob_table) == 0:
        return 0
    return min(VMAXP_CAP, len(prob_table))


def finish_kover(C: np.ndarray, N: np.ndarray, R: np.ndarray,
                 fb_sum: float, prob_table, vmaxp: int,
                 amax: int) -> float:
    """Host: exact IEEE finish of the integer parts (+ the fallback)."""
    A1 = amax + 1
    a = np.arange(A1, dtype=np.float64)
    total = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        if vmaxp:
            Cm = np.asarray(C, dtype=np.float64).reshape(vmaxp, A1)
            ck = prob_table.copy_k[:vmaxp].astype(np.float64)[:, None]
            cp = np.asarray(prob_table.copy_p[:vmaxp],
                            dtype=np.float64)[:, None]
            terms = (1.0 - ck / a[None, :]) * cp
            total += float(np.sum(np.where(Cm > 0, Cm * terms, 0.0)))
        Nf = np.asarray(N, dtype=np.float64)
        Rf = np.asarray(R, dtype=np.float64)
        total += float(np.sum(np.where(Nf > 0, Nf - Rf / a, 0.0)))
    return total + float(fb_sum)


def kover_parts(read_v, read_k, asm_k, prob, is_undr, vmaxp: int,
                amax: int, r_max: int | None = None,
                a_max: int | None = None):
    """Returns (C [vmaxp*(amax+1)] i64, N [amax+1] i64, R [amax+1] i64,
    fb_sum f64, fb_count i64) — the JAX function's contract.  ``r_max``/
    ``a_max`` bound readK/asmK; when they prove the fallback unreachable
    its per-window term is not built."""
    A1 = amax + 1
    v = read_v.reshape(-1).to(torch.int64)
    r = read_k.reshape(-1)
    a = asm_k.reshape(-1)
    undr = is_undr.reshape(-1)

    no_fb = (vmaxp == 0 and r_max is not None and r_max < RMAX_PLAIN
             and a_max is not None and a_max <= amax)
    if no_fb:
        exact_v = torch.zeros_like(undr)
        plain = undr
        fb = None
    else:
        a_ok = undr & (a <= amax)
        if vmaxp:
            exact_v = a_ok & (v >= 1) & (v <= vmaxp)
        else:
            exact_v = torch.zeros_like(a_ok)
        plain = a_ok & ~exact_v & (v > vmaxp) & (r < RMAX_PLAIN)
        plain = plain & (prob.reshape(-1) == 1.0)
        fb = undr & ~exact_v & ~plain

    # asmK <= amax wherever a key uses it; clamp keeps the cast defined
    a_i = a.clamp(0, A1).to(torch.int64)
    sentinel = vmaxp * A1 + A1
    key = torch.where(exact_v, (v - 1) * A1 + a_i,
                      torch.where(plain, vmaxp * A1 + a_i,
                                  torch.full_like(a_i, sentinel)))
    r_pay = torch.where(plain, r, torch.zeros_like(r)).to(torch.int64)

    ks, order = torch.sort(key)
    rs = r_pay[order]
    bounds = torch.searchsorted(
        ks, torch.arange(sentinel + 2, dtype=torch.int64, device=ks.device))
    counts = bounds[1:] - bounds[:-1]
    csr = torch.cat([torch.zeros(1, dtype=torch.int64, device=rs.device),
                     torch.cumsum(rs, 0)])
    rsum = csr[bounds[1:]] - csr[bounds[:-1]]

    C = counts[: vmaxp * A1]
    N = counts[vmaxp * A1: vmaxp * A1 + A1]
    R = rsum[vmaxp * A1: vmaxp * A1 + A1]

    if fb is None:
        zero = torch.zeros((), dtype=torch.int64, device=v.device)
        return C, N, R, torch.zeros((), dtype=torch.float64,
                                    device=v.device), zero
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    term = (1.0 - r / safe_a) * prob.reshape(-1)
    fb_sum = torch.where(fb, term, torch.zeros_like(term)).sum()
    return C, N, R, fb_sum, fb.sum()
