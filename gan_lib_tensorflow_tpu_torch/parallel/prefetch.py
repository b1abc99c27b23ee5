"""Host -> device prefetch (port of ``gan_lib_tensorflow_tpu/parallel/
prefetch.py:20-74``, one device, no mesh).

Each host batch is copied into pinned memory and then to the card with
``non_blocking=True`` on a side stream, ``depth`` batches in flight; the
consumer's stream waits on the copy's event before it reads the batch, so
the copy of batch k+1 overlaps the step on batch k. uint8 leaves (the wire
format of the port's real-data sources) are normalized to float32 in [-1, 1]
on the device (``data/base.py:normalize_u8``); integer leaves (labels) are
left as they are.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..data.base import normalize_u8


def _finish(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: normalize_u8(t) if t.dtype == torch.uint8 else t
            for k, t in batch.items()}


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], device="cuda",
                       depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``it`` (dicts of numpy arrays) as tensors on
    ``device``, uint8 leaves normalized there. On the CPU the arrays are
    wrapped, not copied, and normalized in place of the copy."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in it:
            yield _finish({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in batch.items()})
        return

    copy_stream = torch.cuda.Stream(dev)
    in_flight: collections.deque = collections.deque()

    def put(batch) -> tuple:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            on_dev = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        # torch's pinned-memory allocator reuses a freed buffer only after the
        # copies recorded on it have finished, so dropping ``host`` is safe
        return on_dev, done

    def take(entry) -> Dict[str, torch.Tensor]:
        on_dev, done = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in on_dev.values():
            t.record_stream(consumer)  # allocated on the copy stream, used here
        return _finish(on_dev)

    for batch in it:
        in_flight.append(put(batch))
        if len(in_flight) >= depth:
            yield take(in_flight.popleft())
    while in_flight:
        yield take(in_flight.popleft())
