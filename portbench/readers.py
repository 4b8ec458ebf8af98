"""What the metric readers under ``metrics/`` share: the device's idle
share and a join's share of its bytes roofline, from a traced window.
A reader that finds nothing to read returns None, and the run leaves
that metric out of its line."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def hbm_bytes_per_s(device_name: str) -> float | None:
    """The card's published memory bandwidth (peaks.json), by name."""
    for name, peak in json.loads(PEAKS.read_text())["cards"].items():
        if name in device_name:
            return float(peak["hbm_bytes_per_s"])
    return None


def device_idle(r, mode: str) -> float | None:
    """Percent of the window in which nothing ran on the card."""
    if r.mode != mode or r.trace is None or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def roofline(r, mode: str, join: str) -> float | None:
    """Percent of the bytes bound: the bytes the join's calls in the
    window must move over the card's bandwidth, divided by the device
    time of the kernels that kernels/<join>/ matches."""
    if r.mode != mode or r.trace is None:
        return None
    nbytes = r.join_bytes.get(join, 0)
    seconds = r.trace["joins"].get(join, 0.0)
    bw = hbm_bytes_per_s(r.device_name)
    if not nbytes or seconds <= 0 or bw is None:
        return None
    return 100.0 * nbytes / bw / seconds


def span_share(r, mode: str, keys) -> float | None:
    """Percent of the window's host time inside the host spans ``keys``
    (the layer's entry methods); None where no such span ran."""
    if r.mode != mode or not any(k in keys for k, _, _ in r.spans.intervals):
        return None
    return 100.0 * r.spans.seconds(r.t0, r.t1, keys) / r.window_s
