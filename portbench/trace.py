"""The device trace of the window, and the work of the joins in it.

``Trace`` runs ``torch.profiler`` (CUDA activity) over the window and
reads from it: the seconds in which a kernel, copy or set ran on the
card (``busy_s``), each kernel's device time by name, the device time of
the kernels that a join's pattern files match, and the idle gaps named
by the host span running at their middle.

``JoinWork`` counts the bytes each sorted join must move, from the
queries and the table of every call (``join_bytes``), in the warm pass:
a mix's passes repeat the same calls, so the window does no extra work
on the card to count them.

Provenance: ``join_bytes`` and the union of device intervals are frozen
copies of chip_smoke.py:join_bytes and device_ms.
"""

from __future__ import annotations

import bisect
import re
import time
from pathlib import Path

import torch

_SIGN = -(1 << 63)
U64_MAX = -1


def _bias(x):
    return x ^ _SIGN


def join_bytes(keys, q, nv: int) -> int:
    """The bytes a sorted join must move for sorted queries ``q`` against
    sorted ``keys`` with ``nv`` u32 value columns (tensors on the card):
    8 B a query read, 4 * nv B a result written, the 32-byte sector
    holding each distinct query's lower-bound key, and, for each hit,
    the 32-byte sector of its value in each column; each sector counted
    once, so where the queries are dense this is the window's contiguous
    8 + 4 * nv bytes a key."""
    m, n = q.numel(), keys.numel()
    total = (8 + 4 * nv) * m
    uq = torch.unique(q[q != U64_MAX])
    if n == 0 or uq.numel() == 0:
        return total
    lb = torch.searchsorted(_bias(keys), _bias(uq)).clamp_(max=n - 1)
    hit = keys[lb] == uq
    total += 32 * torch.unique(lb // 4).numel()
    total += 32 * nv * torch.unique(lb[hit] // 8).numel()
    return int(total)


class JoinWork:
    """Bytes of the union join (``UnionTable.lookup2_sorted``) and the
    single-value join (``SortedJoinTable.lookup_sorted``) in the window.

    The warm pass records each call's bytes, and a call in the window
    counts the recorded bytes of its place in the cycle (the mix repeats
    the same calls every pass); ``calls`` says how many calls the window
    made, to be held against the passes times the warm pass's."""

    JOINS = {"union_join": ("merfin_tpu_torch.ops.union_join", "UnionTable",
                            "lookup2_sorted", 2),
             "sorted_join": ("merfin_tpu_torch.ops.sorted_join",
                             "SortedJoinTable", "lookup_sorted", 1)}

    def __init__(self):
        self.recording = True
        self.recorded = {j: [] for j in self.JOINS}
        self.calls = {j: 0 for j in self.JOINS}
        self.bytes = {j: 0 for j in self.JOINS}
        self._saved = []

    def install(self) -> None:
        import importlib

        for join, (mod, cls, meth, nv) in self.JOINS.items():
            owner = getattr(importlib.import_module(mod), cls)
            fn = getattr(owner, meth)
            self._saved.append((owner, meth, fn))
            owner_fn = self._wrapper(join, fn, nv)
            setattr(owner, meth, owner_fn)

    def _wrapper(self, join, fn, nv):
        def call(table, q):
            if self.recording:
                self.recorded[join].append(join_bytes(table.keys, q, nv))
            else:
                rec = self.recorded[join]
                if rec:
                    self.bytes[join] += rec[self.calls[join] % len(rec)]
                self.calls[join] += 1
            return fn(table, q)
        return call

    def start_window(self) -> None:
        self.recording = False

    def uninstall(self) -> None:
        for owner, meth, fn in reversed(self._saved):
            setattr(owner, meth, fn)
        self._saved.clear()


def kernel_patterns(base: Path, join: str) -> list:
    """The regular expressions of every file under kernels/<join>/: one
    a line, each matched against a kernel's name in the trace."""
    pats = []
    for f in sorted((base / "kernels" / join).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                pats.append(re.compile(line))
    return pats


def _merge(spans):
    """Sorted, merged intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The profiler over the window; ``read`` after the window."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        # the marker: the first device event, launched at t_mark, ties the
        # trace's clock to the host's
        self._sync()
        self.t_mark = time.perf_counter()
        torch.full((7,), 7, device=self.device)
        self._sync()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.prof.__exit__(*exc)

    def read(self, t0: float, t1: float, spans, base: Path) -> dict:
        """busy_s, window_s, kernel seconds by name, the seconds of each
        join's kernels, and idle seconds by host span, over [t0, t1]."""
        from torch.autograd import DeviceType

        ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in self.prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda x: x[0])
        if not ev:
            return dict(busy_s=0.0, window_s=t1 - t0, by_name={},
                        joins={}, idle={})
        off = ev[0][0] - self.t_mark * 1e6          # us: device - host
        lo, hi = t0 * 1e6 + off, t1 * 1e6 + off
        by_name: dict[str, float] = {}
        spans_dev = []
        for a, b, name in ev:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            spans_dev.append((a, b))
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        merged = _merge(spans_dev)
        busy = sum(b - a for a, b in merged) / 1e6
        joins = {}
        for join in JoinWork.JOINS:
            pats = kernel_patterns(base, join)
            s = sum(t for n, t in by_name.items()
                    if any(p.search(n) for p in pats))
            if pats and s > 0:
                joins[join] = s
        # idle gaps, each named by the innermost host span at its middle;
        # the passes fill the window, so a gap in no other span found
        # within the lookback is the mode's driver outside the wrapped calls
        iv = sorted(spans.intervals, key=lambda x: x[1])
        starts = [a for _, a, _ in iv]
        idle: dict[str, float] = {}
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = ((a + b) / 2 - off) / 1e6
            j = bisect.bisect_right(starts, mid) - 1
            label = "driver"
            stop = max(-1, j - 4096)
            while j > stop:
                key, s0, s1 = iv[j]
                if s1 > mid and key != "pass":
                    label = key
                    break
                j -= 1
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        return dict(busy_s=busy, window_s=t1 - t0, by_name=by_name,
                    joins=joins, idle=idle)
