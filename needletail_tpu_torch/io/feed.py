"""Double-buffered host→device feed.

The port's copy of ``needletail_tpu/io/feed.py``.

The counting loops are: frame a batch (host CPU), place it on device,
dispatch the step (async).  Framing in the consumer thread serializes with
the dispatch bookkeeping; ``device_feed`` moves framing + placement into a
background thread with a bounded queue, so batch N+1 frames and uploads
while the device still runs batch N.  The native scanner and numpy copies
run in C (GIL released), so the overlap is real even in one process.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

__all__ = ["device_feed"]

T = TypeVar("T")
U = TypeVar("U")

_POLL = 0.1


def device_feed(
    batches: Iterable[T],
    place: Callable[[T], U],
    depth: int = 2,
) -> Iterator[U]:
    """Yield ``place(batch)`` for each batch, pipelined ``depth`` deep.

    ``place`` runs in the feeder thread (frame + device_put); exceptions
    from the source iterator or ``place`` re-raise in the consumer.
    Abandoning the generator (break / GC) stops the feeder promptly.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    _DONE, _ERR, _ITEM = 0, 1, 2

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for b in batches:
                if stop.is_set():
                    return
                if not _put((_ITEM, place(b))):
                    return
            _put((_DONE, None))
        except BaseException as exc:  # delivered to the consumer
            _put((_ERR, exc))

    t = threading.Thread(target=worker, daemon=True, name="nt-device-feed")
    t.start()
    try:
        while True:
            tag, payload = q.get()
            if tag == _DONE:
                break
            if tag == _ERR:
                raise payload
            yield payload
    finally:
        stop.set()
        # keep draining while joining: a feeder that won its put() race
        # just before stop can enqueue one more item; repeated drains keep
        # the queue empty so it observes stop on the next put attempt
        deadline = 300  # 0.2 s steps: bounded wait for a mid-place() feeder
        while t.is_alive() and deadline > 0:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.2)
            deadline -= 1
