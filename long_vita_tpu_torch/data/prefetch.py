"""Background-thread batch prefetcher.

Counterpart of long_vita_tpu/data/prefetch.py (the reference's DataLoader
worker processes, legacy/data/data_samplers.py:52-101): packing and image
preprocessing run on a host thread (the native feedworker releases the GIL
in C++) and stay ``depth`` batches ahead of the card. An error raised in the
worker is raised again in the consumer, after the items before it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator


class _Stop:
    pass


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread, keeping `depth` items ready."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            error.append(e)
        finally:
            q.put(_Stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()

    while True:
        item = q.get()
        if item is _Stop:
            if error:
                raise error[0]
            return
        yield item
