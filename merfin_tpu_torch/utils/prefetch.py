"""Host-side prefetch pipeline — the sweatShop loader analog.

The reference overlaps input parsing with compute via its loader thread
(sweatShop, merfin.C:366-413).  Here a single background thread runs the
(FASTA-parsing, code-building) generator ahead of the consumer so host
IO overlaps device dispatches.  Bounded queue, exception-propagating.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from merfin_tpu_torch.utils.spans import carry, span

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], depth: int = 2,
                  wait: str = "prefetch.wait") -> Iterator[T]:
    """Iterate `it` on a background thread, `depth` items ahead.  The
    consumer's wait for each item is the span named `wait`; the
    thread's spans take the consumer's open span as their parent."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=carry(worker), daemon=True)
    t.start()
    while True:
        with span(wait):
            item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
