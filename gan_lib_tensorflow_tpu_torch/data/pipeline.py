"""Host-side prefetch (port of ``gan_lib_tensorflow_tpu/data/pipeline.py``):
``ThreadedSource`` runs N daemon workers, each iterating its own reseeded
copy of a source into a bounded queue of its own, so host batch assembly
overlaps the device's step (numpy's gathers release the interpreter lock).
The consumer takes the workers' batches in turn, so the order is fixed."""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from .base import DataSource


class ThreadedSource(DataSource):
    """Parallel, prefetching wrapper around a ``DataSource``.

    Worker ``w`` iterates ``source.reseeded(seed + 1000003 * (w + 1))``, so
    the streams are disjoint, and its batches are the batches ``k = w, w + N,
    w + 2N, ...`` of the output: the consumer takes ``k = 0, 1, 2, ...`` from
    the workers' queues in turn, so two processes that wrap the same source
    read the same sequence (the reference leaves the order unspecified).
    The queues hold ``depth`` batches together. A worker's exception reaches
    the consumer, at that worker's turn, as a ``RuntimeError`` chained to
    it."""

    def __init__(self, source: DataSource, num_workers: int = 2, depth: int = 8):
        self.source = source
        self.batch_size = source.batch_size
        self.num_workers = num_workers
        self.depth = depth

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = self.num_workers
        queues = [queue.Queue(maxsize=max(1, -(-self.depth // n))) for _ in range(n)]
        stop = threading.Event()

        def put(q: queue.Queue, item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker(wid: int) -> None:
            q = queues[wid]
            try:
                base_seed = getattr(self.source, "seed", 0)
                it = iter(self.source.reseeded(base_seed + 1000003 * (wid + 1)))
                while not stop.is_set():
                    put(q, next(it))
            except Exception as e:  # handed to the consumer, which raises it
                put(q, e)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        try:
            for k in itertools.count():
                item = queues[k % n].get()
                if isinstance(item, Exception):
                    raise RuntimeError(
                        "ThreadedSource worker failed; see the chained error") from item
                yield item
        finally:
            stop.set()
