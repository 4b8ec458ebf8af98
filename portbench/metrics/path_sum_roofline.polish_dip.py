"""The path-sum kernel's share of its bytes roofline in the diploid
-polish window: the bytes its calls in the window must move (8 B a path
window read, 8 B a path written, 16 B of its bounds read; counted by
the driver's wrap of ``PathSumKernel.__call__``, ``path_sum_work``) over
3.35 TB/s, divided by the device time of the kernels matched by
kernels/path_sum/.  None where the program has no such kernel."""

from pathlib import Path

from portbench.readers import hbm_bytes_per_s
from portbench.trace import kernel_patterns

UNIT = "%"
BASE = Path(__file__).resolve().parents[1]


def read(r):
    work = getattr(r.spans, "path_sum_work", None)
    if r.mode != "polish_dip" or r.trace is None or work is None:
        return None
    nbytes = sum(b for t, b in work.log if r.t0 <= t <= r.t1)
    pats = kernel_patterns(BASE, "path_sum")
    seconds = sum(t for n, t in r.trace["by_name"].items()
                  if any(p.search(n) for p in pats))
    bw = hbm_bytes_per_s(r.device_name)
    if not nbytes or seconds <= 0 or bw is None:
        return None
    return 100.0 * nbytes / bw / seconds
