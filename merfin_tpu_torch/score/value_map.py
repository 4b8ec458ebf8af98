"""Device getK via the host-exact value map (port of
``merfin_tpu/score/value_map.py:ValueMap.lookup_jnp``).

readK/prob for every raw value up to ``vcap`` come from the shared
``ValueMap``'s host tables (exact IEEE getK, merfin-globals.C:84-97);
nothing boundary-sensitive is recomputed on the device.
"""

from __future__ import annotations

import torch


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
