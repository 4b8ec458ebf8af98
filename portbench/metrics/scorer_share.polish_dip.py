"""Percent of the diploid -polish window's host time inside the fused
scorer's entry methods that run_variants calls (DeviceScorer.dispatch_paths,
fetch_paths); the rest is run_variants' enumeration, selection
and waits."""

from portbench.readers import span_share

UNIT = "%"


def read(r):
    return span_share(r, "polish_dip", ("dispatch_paths", "fetch_paths"))
