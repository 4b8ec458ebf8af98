"""Host spans and counts inside the program, off unless enabled.

A span is a named interval of one thread's work on ``time.perf_counter``
(the clock a profiler run ties its device trace to), with counts such as
the bytes or k-mers it handled:

    with span("completeness.block_upload") as h:
        ...
        h.count("bytes", n)

Off (the default), ``span`` returns one shared object that does nothing:
no clock read, no allocation.  On, each closed span is kept with its
name, start, end, thread (``threading.get_ident``), its id and its
parent's id: the span open on the same thread, or, for work handed to
another thread through ``carry``, the span that handed it over.  Past
``CAP`` kept spans only the per-name totals grow (seconds, calls,
counts, which cover every span) and ``dropped`` counts the rest, so a
whole-genome job stays bounded.  Spawned worker processes start with the
recorder off.

``write_chrome`` saves the spans as Chrome trace-event JSON (Perfetto
opens it).  This module imports neither torch nor numpy: the spawned
enumeration workers import the modules that use it.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

CAP = 1 << 20        # spans kept before only the totals grow

_on = False
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_records: list = []
_totals: dict[str, dict] = {}
_dropped = 0


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, key: str, n) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One recorded span: ``name``, ``start`` and ``end`` (perf_counter
    seconds), ``tid``, ``id``, ``parent`` (an id or None), ``counts``."""

    __slots__ = ("name", "start", "end", "tid", "id", "parent", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: dict[str, int] = {}

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else getattr(_local, "carried", None)
        self.id = next(_ids)
        self.tid = threading.get_ident()
        st.append(self.id)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _stack().pop()
        _keep(self)
        return None

    def count(self, key: str, n) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        t = _totals.get(s.name)
        if t is None:
            t = _totals[s.name] = {"seconds": 0.0, "calls": 0, "counts": {}}
        t["seconds"] += s.end - s.start
        t["calls"] += 1
        for k, n in s.counts.items():
            t["counts"][k] = t["counts"].get(k, 0) + n
        if len(_records) < CAP:
            _records.append(s)
        else:
            _dropped += 1


def span(name: str):
    """A context manager timing the block as span ``name``; its value
    takes counts (``.count(key, n)``)."""
    return Span(name) if _on else _OFF


def carry(fn):
    """``fn`` to run on another thread with the calling thread's open
    span as the parent of the spans it opens there; ``fn`` itself while
    the recorder is off."""
    if not _on:
        return fn
    st = _stack()
    parent = st[-1] if st else getattr(_local, "carried", None)

    def run(*args, **kwargs):
        saved = getattr(_local, "carried", None)
        _local.carried = parent
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = saved

    return run


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Forget every kept span, the totals and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _totals.clear()
        _dropped = 0


def records() -> list[Span]:
    """The kept spans, in the order they closed."""
    with _lock:
        return list(_records)


def totals() -> dict[str, dict]:
    """{name: {"seconds", "calls", "counts"}} over every span since the
    last ``clear``, kept or dropped."""
    with _lock:
        return {n: {"seconds": t["seconds"], "calls": t["calls"],
                    "counts": dict(t["counts"])} for n, t in _totals.items()}


def dropped() -> int:
    """Spans closed past ``CAP``, in the totals only."""
    return _dropped


def write_chrome(path: str, counters: dict | None = None) -> None:
    """The kept spans as Chrome trace events (``ph`` "X", microseconds
    on perf_counter, one ``tid`` a thread; id, parent and counts under
    ``args``), each name's totals as a counter event, and ``counters``
    ({name: {key: value}}) as counter events at the last span's end."""
    recs = records()
    pid = os.getpid()
    t_end = max((s.end for s in recs), default=time.perf_counter())
    ev = [{"name": "thread_name", "ph": "M", "pid": pid,
           "tid": threading.main_thread().ident, "args": {"name": "main"}}]
    for s in recs:
        ev.append({"name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                   "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
                   "args": {"id": s.id, "parent": s.parent, **s.counts}})
    for name, t in sorted(totals().items()):
        ev.append({"name": f"{name} totals", "ph": "C", "pid": pid,
                   "ts": t_end * 1e6,
                   "args": {"seconds": t["seconds"], "calls": t["calls"],
                            **t["counts"]}})
    for name, vals in sorted((counters or {}).items()):
        ev.append({"name": name, "ph": "C", "pid": pid, "ts": t_end * 1e6,
                   "args": dict(vals)})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                   "otherData": {"clock": "time.perf_counter",
                                 "dropped_spans": dropped()}}, f)
