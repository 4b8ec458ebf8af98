"""Share of the diploid -polish window with no kernel, copy or set on the
card (torch.profiler over the traced window)."""

from portbench.readers import device_idle

UNIT = "%"


def read(r):
    return device_idle(r, "polish_dip")
