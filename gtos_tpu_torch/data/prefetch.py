"""Background input-pipeline prefetch — port of gtos_tpu/data/prefetch.py.

`prefetch_iter` runs the host-side transform of upcoming items (batchify ->
numpy -> tensors on the device) in a daemon thread, `depth` items ahead of
the training loop, so the per-batch Python work overlaps the card's work
on the steps already queued. The Trainer's transform on one card queues
the copy to the card on a stream of its own and does not wait for it
(train/feed.py): the item reaches the consumer before its copy has
landed, and the step waits for it on the card. The consumer's wait for
each item is the span "gtos/prefetch/wait" (utils/profiling.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from gtos_tpu_torch.utils.profiling import annotate

_DONE = object()


def prefetch_iter(
    iterable: Iterable,
    fn: Optional[Callable] = None,
    depth: int = 2,
) -> Iterator:
    """Yield `fn(item)` for each item, computed `depth` items ahead in a
    background thread.

    depth <= 0 degrades to a plain synchronous map. Exceptions raised by
    the source iterable or by `fn` propagate to the consumer at the point
    of the failed item. If the consumer abandons the iterator early, the
    worker thread is signalled to stop and joined: it finishes the item
    in hand and exits, so none of its torch work outlives the consumer (a
    daemon thread still inside torch when the interpreter exits can abort
    the process)."""
    if depth <= 0:
        it = iter(iterable)
        while True:
            with annotate("gtos/prefetch/wait"):
                item = next(it, _DONE)
                if item is not _DONE and fn is not None:
                    item = fn(item)
            if item is _DONE:
                return
            yield item

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []

    def worker():
        try:
            for item in iterable:
                out = fn(item) if fn is not None else item
                while not stop.is_set():
                    try:
                        q.put(out, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - propagated to consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_DONE, timeout=0.05)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True, name="gtos-prefetch")
    t.start()
    try:
        while True:
            with annotate("gtos/prefetch/wait"):
                item = q.get()
            if item is _DONE:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
