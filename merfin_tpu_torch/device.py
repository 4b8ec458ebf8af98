"""Device choice — the port's counterpart of ``merfin_tpu.config``'s
platform knob.

``MERFIN_PLATFORM`` (the variable the JAX package already honours) picks
``cuda`` (the default) or ``cpu``.  Asking for CUDA where no card is
visible raises: the port never carries on on the CPU by itself.

``devices()`` lists the devices a ``-mesh`` may use: every visible card,
or on the CPU ``MERFIN_CPU_DEVICES`` logical host devices (default 1),
the counterpart of the JAX tests' ``--xla_force_host_platform_device_count``.
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


def devices() -> list[torch.device]:
    """This process's mesh devices: ``cuda:0..n-1``, or
    ``MERFIN_CPU_DEVICES`` logical host devices (all ``cpu``)."""
    dev = get_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    n = int(os.environ.get("MERFIN_CPU_DEVICES", "1") or "1")
    if n < 1:
        raise ValueError(f"MERFIN_CPU_DEVICES={n}: needs at least 1")
    return [dev] * n
