"""Device choice — the port's counterpart of ``merfin_tpu.config``'s
platform knob.

``MERFIN_PLATFORM`` (the variable the JAX package already honours) picks
``cuda`` (the default) or ``cpu``.  Asking for CUDA where no card is
visible raises: the port never carries on on the CPU by itself.
"""

from __future__ import annotations

import os

import torch

PLATFORMS = ("cuda", "cpu")


def get_device() -> torch.device:
    plat = (os.environ.get("MERFIN_PLATFORM") or "cuda").lower()
    if plat not in PLATFORMS:
        raise ValueError(
            f"MERFIN_PLATFORM={plat!r}: the torch port runs on 'cuda' or 'cpu'")
    if plat == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "MERFIN_PLATFORM=cuda but torch.cuda.is_available() is false "
            "(set MERFIN_PLATFORM=cpu to run on the CPU)")
    return torch.device(plat)
