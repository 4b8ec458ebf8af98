"""The plain reference of -completeness (merfin-completeness.C:49-143),
in plain torch on the world's arrays: every read-DB k-mer's readK
(getK, no -prob table), its assembly value, and the per-slice sums of
readK and of the copies the assembly lacks (64 slices by the top 6 bits
of the key), in int64.

The control, ``"fp32"``, looks the read k-mers up in the assembly by
their low 32 bits only, a lossy key fingerprint in place of the exact
lookup the configuration states.  (Sums accumulated in float32, the
precision below merfin's float64 totals, would be exact here: a
slice's sum stays under 2^24.)
"""

from __future__ import annotations

import torch

from portbench.reference.values import db_values, get_k, to_device

SLICES = 64
BLOCK = 1 << 24


def expected_completeness(world, device, control=None) -> dict:
    """{"lines": the program's stderr lines without blank ones,
    "completeness": the COMPLETENESS value}."""
    rk = to_device(world.read_keys, device)
    rv = to_device(world.read_vals, device)
    ak = to_device(world.asm_keys, device)
    av = to_device(world.asm_vals, device)
    if control == "fp32":
        ak, order = torch.sort(ak & 0xFFFFFFFF, stable=True)
        av = av[order]
        first = torch.ones_like(ak, dtype=torch.bool)
        first[1:] = ak[1:] != ak[:-1]
        ak, av = ak[first], av[first]
    shift = max(0, 2 * world.k - 6)
    total = torch.zeros(SLICES, dtype=torch.int64, device=device)
    undrc = torch.zeros(SLICES, dtype=torch.int64, device=device)
    for lo in range(0, rk.numel(), BLOCK):
        q = rk[lo: lo + BLOCK]
        r = get_k(rv[lo: lo + BLOCK], world.peak, torch.float64) \
            .to(torch.int64)
        a = db_values(ak, av, q & 0xFFFFFFFF if control == "fp32" else q)
        u = torch.clamp(r - a, min=0)
        s = q >> shift
        total.index_add_(0, s, r)
        undrc.index_add_(0, s, u)
    total = total.double().cpu().tolist()
    undrc = undrc.double().cpu().tolist()
    lines = []
    for ii in range(SLICES):
        c = 1.0 - undrc[ii] / total[ii] if total[ii] else float("nan")
        lines.append(f"thread {ii:2d} total {total[ii]:12.2f} underc "
                     f"{undrc[ii]:15.5f} completeness {c:0.8f}")
    t, u = float(sum(total)), float(sum(undrc))
    comp = 1.0 - u / t if t else float("nan")
    lines += [f"TOTAL readK:   {t:15.2f}", f"TOTAL undrcpy:    {u:15.5f}",
              f"COMPLETENESS:             {comp:0.5f}"]
    return {"lines": lines, "completeness": comp}


def as_output(exp: dict):
    """The reference's numbers in the program's output form."""
    return "\n".join(exp["lines"]) + "\n", exp["completeness"]
