"""The single-value sorted join's share of its bytes roofline in the
completeness window: join_bytes of every block against the assembly
table over 3.35 TB/s, divided by the device time of the kernels matched
by kernels/sorted_join/."""

from portbench.readers import roofline

UNIT = "%"


def read(r):
    return roofline(r, "completeness", "sorted_join")
