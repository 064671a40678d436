"""Batch loader of the trainers (counterpart of
``vfloodnet_tpu.data.loader.BatchLoader``).

The order of epoch ``e`` is a pure function of (seed, e). With
``workers`` = 0, the default, each batch is made on the caller's thread
when it is asked for: no thread is started. ``workers`` > 0 makes batches
ahead in that many threads (batch ``b`` in thread ``b % workers``) and
yields them in the same order, so the batches are the same either way.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class BatchLoader:
    """Batches of ``dataset.get(idx, epoch)``: arrays are stacked, other
    values collected into lists."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 workers: int = 0, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = workers
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def batches(self, epoch: int):
        """The index batches of ``epoch``, in order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        out = [order[i:i + self.batch_size]
               for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            out = [b for b in out if len(b) == self.batch_size]
        return out

    def make_batch(self, idxs, epoch: int):
        samples = [self.dataset.get(int(i), epoch) for i in idxs]
        return tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                     else list(col) for col in zip(*samples))

    def epoch(self, epoch: int) -> Iterator:
        batches = self.batches(epoch)
        if self.workers <= 0:
            for idxs in batches:
                yield self.make_batch(idxs, epoch)
            return
        yield from self._threaded(batches, epoch)

    def _threaded(self, batches, epoch: int) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=2 * self.workers)
        stop = threading.Event()

        def worker(wid):
            for bi in range(wid, len(batches), self.workers):
                if stop.is_set():
                    return
                try:
                    item = (bi, self.make_batch(batches[bi], epoch), None)
                except Exception as e:   # raised again on the caller's
                    item = (bi, None, e)
                q.put(item)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        pending = {}
        try:
            for want in range(len(batches)):
                while want not in pending:
                    bi, batch, err = q.get()
                    if err is not None:
                        raise err
                    pending[bi] = batch
                yield pending.pop(want)
        finally:
            stop.set()
            for t in threads:
                while t.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        t.join(timeout=0.1)
