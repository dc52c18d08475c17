"""Batching iterator with thread-pool prefetch (counterpart of
storm_tpu/data/loader.py, single process).

Items are loaded by a small thread pool in a background thread, up to
PREFETCH batches ahead of the consumer. The shuffle order is a pure
function of (seed, epoch), so a resumed run replays the batches a continuous
run would have seen.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

PREFETCH = 2  # batches loaded ahead of the consumer


class DataLoader:
    """Iterates (x, y) numpy batches (B, C, T), squeezed to (B, T) for C = 1."""

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order (and the dataset's crops) to `epoch`."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, items):
        xs = np.stack([it[0] for it in items])
        ys = np.stack([it[1] for it in items])
        if xs.ndim == 3 and xs.shape[1] == 1:
            xs, ys = xs[:, 0], ys[:, 0]
        return xs, ys

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # use the current epoch and advance it, so that iterating again
            # without set_epoch reshuffles
            epoch, self._epoch = self._epoch, self._epoch + 1
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(epoch)
        end = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        for i in range(0, end, self.batch_size):
            yield idx[i: i + self.batch_size]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item` unless the consumer has stopped; False if it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        if not put(self._collate(
                                list(pool.map(self.dataset.__getitem__, batch_idx)))):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # the consumer may stop early (max_steps): let the producer finish
            stop.set()
            thread.join()
