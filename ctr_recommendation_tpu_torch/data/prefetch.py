"""Host-side input prefetching: the JAX package's data/prefetch.py.

One background thread runs the batch iterator (and a per-item transform,
e.g. the trainer's upload to the card) and stays ``depth`` items ahead of
the consumer, so that batch assembly, the host-to-device copy and the
step overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(
    iterator: Iterator[T],
    transform: Callable[[T], T] | None = None,
    depth: int = 2,
) -> Iterator[T]:
    """Run ``iterator`` (and the optional per-item ``transform``) in a
    daemon thread named "prefetch", keeping ``depth`` items ready; items
    arrive in order, and an exception of the worker is raised in the
    consumer.

    Shutdown-safe: when the consumer abandons the generator (an exception
    in the step, KeyboardInterrupt, break), closing it tells the worker to
    stop. The worker then drops the item it holds, closes ``iterator`` and
    exits, and the queue is drained: without this the worker would block
    forever in ``q.put`` holding ``depth + 1`` batches, on the card device
    memory."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for item in iterator:
                put(transform(item) if transform else item)
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — raised again in the consumer
            err.append(e)
        finally:
            try:
                close = getattr(iterator, "close", None)
                if close is not None:  # a generator, e.g. another prefetch
                    close()
            finally:
                put(_SENTINEL)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # unblock a pending put and release the items in the queue
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
