"""Bounded background-thread prefetch for the input pipeline.

The port's copy of ``equss_tpu/core/prefetch.py``: one producer-thread
pattern (bounded queue, sentinel, stop event, exception forwarding,
clean join) behind ``data.pipeline.UnSegData.batches``, and its
multi-producer, in-order form ``ordered_parallel_map``.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional


def threaded_prefetch(items: Iterable, *, depth: int = 2,
                      map_fn: Optional[Callable] = None) -> Iterator:
    """Yield ``map_fn(item)`` (or the item) with up to ``depth`` results
    computed ahead on a daemon thread.

    Exceptions raised by the producer (including inside ``map_fn``) are
    re-raised at the consumer's next ``next()``; abandoning the
    generator early (break / close) unblocks and joins the thread.
    """
    q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def produce():
        try:
            for item in items:
                out = map_fn(item) if map_fn is not None else item
                if not put(out):
                    return
            put(sentinel)
        except BaseException as e:          # propagate to the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            out = q.get()
            if out is sentinel:
                break
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        stop.set()          # unblock the producer if we exit early
        t.join()


def ordered_parallel_map(fn: Callable, items: Iterable, *,
                         workers: int, depth: int = 2) -> Iterator:
    """Yield ``fn(item)`` in input order with up to ``workers`` items
    computed concurrently and at most ``workers + depth`` in flight.

    The multi-producer analogue of ``threaded_prefetch``: N worker
    threads each materialize whole results (e.g. whole batches — a
    sharded-range reader over the item stream), while the consumer sees
    strictly ordered output.  Exceptions from ``fn`` surface at the
    result's in-order position; abandoning the generator early cancels
    pending work and joins the pool.
    """
    if workers <= 1:
        yield from threaded_prefetch(items, depth=depth, map_fn=fn)
        return
    it = iter(items)
    pending: "collections.deque" = collections.deque()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        try:
            while True:
                while len(pending) < workers + depth:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    pending.append(pool.submit(fn, item))
                if not pending:
                    break
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
