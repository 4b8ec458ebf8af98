"""Host spans taken from outside the program: a method of the program is
wrapped for the traced window, and each call's start and end on the host
clock are kept, so that a metric can read the share of the window spent
inside a layer's entry methods and the trace's idle gaps can be named
by what the host was doing.

Provenance: the wrapping of chip_smoke.py:timers (a generator's time is
that of its steps), with the intervals kept instead of a sum.
"""

from __future__ import annotations

import inspect
import time


class Spans:
    """Intervals (key, start, end) of the wrapped calls, host seconds."""

    def __init__(self):
        self.intervals: list[tuple[str, float, float]] = []
        self._saved: list = []

    def wrap(self, owner, name: str, key: str | None = None) -> None:
        """Record every call of ``owner.name`` (a class's method or a
        module's function) under ``key``, until ``unwrap``."""
        key = key or name
        saved = inspect.getattr_static(owner, name)
        fn = getattr(owner, name)
        out = self.intervals

        def steps(gen):
            while True:
                t = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                finally:
                    out.append((key, t, time.perf_counter()))
                yield item

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                res = fn(*a, **kw)
            finally:
                out.append((key, t, time.perf_counter()))
            return steps(res) if inspect.isgenerator(res) else res

        setattr(owner, name,
                staticmethod(run) if isinstance(saved, staticmethod) else run)
        self._saved.append((owner, name, saved))

    def unwrap(self) -> None:
        for owner, name, saved in reversed(self._saved):
            setattr(owner, name, saved)
        self._saved.clear()

    def clear(self) -> None:
        self.intervals.clear()

    def seconds(self, t0: float, t1: float, keys=None) -> float:
        """Seconds of the wrapped calls (of ``keys``) inside [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0))
                   for k, a, b in self.intervals
                   if keys is None or k in keys)
