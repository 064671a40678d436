"""Opt-in thread pools of the video runners (counterpart of the decode
prefetch and writer pools of ``vfloodnet_tpu.pipelines.video_seg`` and
``video_seg_batch``).

A runner given ``workers`` > 0 decodes frames ahead in one pool of that
many threads and writes masks and overlays in another. With ``workers``
= 0, the default, :func:`make_pool` gives :class:`Inline`, which runs each
submitted call at once on the caller's thread: no thread is started, and
the runner keeps its single-threaded order (it enqueues frame t before it
writes frame t - 1). The masks are the same either way.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Sequence


class Inline:
    """The interface of a ``ThreadPoolExecutor`` that runs each call when
    it is submitted."""

    def submit(self, fn: Callable, *args) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:   # raised again by .result()
            fut.set_exception(e)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        pass


def make_pool(workers: int):
    """A pool of ``workers`` threads, or :class:`Inline` for 0."""
    return ThreadPoolExecutor(max_workers=workers) if workers > 0 \
        else Inline()


class Prefetcher:
    """``load(items[i])`` for i = 0, 1, ... in order, with up to ``depth``
    items submitted ahead to ``pool`` (depth 0: each is loaded when it is
    asked for)."""

    def __init__(self, pool, load: Callable, items: Sequence, depth: int):
        self.pool, self.load, self.items = pool, load, items
        self.depth = depth
        self._futures: Dict[int, Future] = {}

    def get(self, i: int):
        for j in range(i, min(i + 1 + self.depth, len(self.items))):
            if j not in self._futures:
                self._futures[j] = self.pool.submit(self.load, self.items[j])
        return self._futures.pop(i).result()
