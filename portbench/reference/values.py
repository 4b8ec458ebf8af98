"""What the plain references share, in plain torch on the world's own
arrays: a DB's values by ``searchsorted`` in its sorted keys, and getK
(merfin-globals.C:66-98, no -prob table)."""

from __future__ import annotations

import numpy as np
import torch


def db_values(keys: torch.Tensor, vals: torch.Tensor, q: torch.Tensor):
    """Values of ``q`` in the sorted DB (keys < 2^63), 0 where absent."""
    if keys.numel() == 0:
        return torch.zeros_like(q)
    i = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return torch.where(keys[i] == q, vals[i], torch.zeros_like(q))


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device: a host scalar would let
    CUDA divide by multiplying with its reciprocal, which rounds
    differently from the division merfin makes."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def get_k(v: torch.Tensor, peak: float, dtype) -> torch.Tensor:
    """readK of raw read values (merfin-globals.C:72-84): 0, 1 under the
    peak, else C round(v / peak)."""
    x = v.to(dtype)
    r = torch.floor(x / const(peak, x) + 0.5)
    return torch.where(v == 0, torch.zeros_like(x),
                       torch.where(x < peak, torch.ones_like(x), r))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64,
                                                           copy=False)
                            ).to(device)
