"""Host-side prefetch (port of ``gan_lib_tensorflow_tpu/data/pipeline.py``):
``ThreadedSource`` runs N daemon workers, each iterating its own reseeded
copy of a source into a bounded queue, so host batch assembly overlaps the
device's step (numpy's gathers release the interpreter lock)."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from .base import DataSource


class ThreadedSource(DataSource):
    """Parallel, prefetching wrapper around a ``DataSource``.

    Worker ``w`` iterates ``source.reseeded(seed + 1000003 * (w + 1))``, so
    the streams are disjoint; with more than one worker the order in which
    their batches arrive is not fixed. A worker's exception reaches the
    consumer as a ``RuntimeError`` chained to it."""

    def __init__(self, source: DataSource, num_workers: int = 2, depth: int = 8):
        self.source = source
        self.batch_size = source.batch_size
        self.num_workers = num_workers
        self.depth = depth

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker(wid: int) -> None:
            try:
                base_seed = getattr(self.source, "seed", 0)
                it = iter(self.source.reseeded(base_seed + 1000003 * (wid + 1)))
                while not stop.is_set():
                    put(next(it))
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise RuntimeError(
                        "ThreadedSource worker failed; see the chained error") from item
                yield item
        finally:
            stop.set()
