"""Threaded prefetching batch loader, for datasets generated on the host.

The port's own copy of ``jpdvt_mt_ntnu_tpu/data/loader.py`` (numpy only): a
thread pool builds items on the host while the card computes, with
sharding by process index (the DistributedSampler equivalent,
train_JPDVT.py:304-310). Batches are (B, H, W, C) float32 numpy arrays.

``rows`` is the port's data-parallel rule: every rank walks the same global
batches and builds only its ``rows`` of each (``parallel.rank_rows``), so
that the ranks together train on what one process would.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, rows: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.rows = rows
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch like DistributedSampler.set_epoch."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 100003 + self.epoch)
            rng.shuffle(idx)
        # Strided shard across hosts.
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            # bounded put that honors the stop flag (a plain put() would
            # park forever if the consumer abandoned iteration)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(self.dataset.__getitem__, b))
                    if not put_checked(np.stack(items)):
                        return
            put_checked(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
