"""Host -> device prefetch (port of ``gan_lib_tensorflow_tpu/parallel/
prefetch.py:20-74``). On a mesh each rank copies only its rows of the
global batch (``rows``, dim 1 of the ``[n_micro, B, ...]`` stacks), as the
reference's ``shard_batch`` puts each row on its own device, and over a
``spatial_axis`` only its height rows of the image leaves (reference
``prefetch.py:50-65``).

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
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.base import normalize_u8
from ..utils.profiler import span
from .sharding import height_rows

_END = object()


def _waited(it: Iterator) -> Iterator:
    """The items of ``it``, each wait for one inside a ``data.queue_wait``
    span (a host source blocks on its workers' queue there)."""
    while True:
        with span("data.queue_wait"):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _finish(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: normalize_u8(t) if t.dtype == torch.uint8 else t
            for k, t in batch.items()}


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], device="cuda",
                       depth: int = 2, rows: Optional[slice] = None, mesh=None,
                       spatial_axis: Optional[str] = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``it`` (dicts of numpy arrays) as tensors on
    ``device``, uint8 leaves normalized there; with ``rows``, only those
    rows of dim 1; with ``spatial_axis`` (of ``mesh``), only the rank's
    height rows (dim 2) of the ``[n_micro, B, H, W, C]`` leaves. On the CPU
    the arrays are wrapped, not copied, and normalized in place of the copy."""
    dev = resolve_device(device)
    it = _waited(iter(it))
    if rows is not None:
        it = ({k: v[:, rows] for k, v in batch.items()} for batch in it)
    if spatial_axis is not None:
        it = ({k: v[:, :, height_rows(v.shape[2], mesh, spatial_axis)] if v.ndim == 5 else v
               for k, v in batch.items()} for batch in it)
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
