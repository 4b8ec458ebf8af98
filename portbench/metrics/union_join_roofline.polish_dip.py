"""The union join's share of its bytes roofline in the diploid -polish
window: join_bytes of every call's queries and table over 3.35 TB/s,
divided by the device time of the kernels matched by
kernels/union_join/."""

from portbench.readers import roofline

UNIT = "%"


def read(r):
    return roofline(r, "polish_dip", "union_join")
