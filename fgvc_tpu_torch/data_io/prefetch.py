"""Background-thread prefetch of an iterator (fgvc_tpu/data_io/prefetch.py):
the training loop's host-side loader pipeline.  The synthetic datasets' numpy
and the Lab conversion release the GIL, so one worker thread keeping a small
queue full overlaps batch n+1's preparation with step n on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_iter(iterable: Iterable, depth: int = 2) -> Iterator:
    """Yield from `iterable`, producing up to `depth` items ahead on a
    worker thread.  Exceptions from the producer re-raise at the consumer;
    abandoning the iterator stops the worker promptly."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: queue.Queue = queue.Queue(depth)
    stop = threading.Event()
    exc = []

    def _put(item) -> bool:
        """Queue-put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            exc.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(
        target=worker, daemon=True, name="fgvc-prefetch"
    )
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if exc:
                    raise exc[0]
                return
            yield item
    finally:
        stop.set()
