"""Dataset interface, microbatch stacking and the uint8 normalize (port of
``gan_lib_tensorflow_tpu/data/base.py``).

Host sources yield dicts of numpy arrays. The port's real-data sources ship
``image`` as NHWC **uint8** and ``label`` as int32; the device side
(``parallel/prefetch.py``, ``data/device_cache.py``) turns uint8 into float32
in [-1, 1] with ``normalize_u8``.
"""

from __future__ import annotations

import abc
import copy
from typing import Dict, Iterator

import numpy as np
import torch

# 1/127.5 rounded to float32: the reference's constant (``native/ganpipe.cpp``
# writes ``1.0f / 127.5f``)
U8_SCALE = float(np.float32(1.0 / 127.5))


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1], equal bit for bit to the reference.

    The reference's ``u8 * (1/127.5) - 1`` is contracted into one fused
    multiply-add by its compilers (the native loader and XLA alike): the
    result is ``x * c - 1`` rounded once. Two float32 ops round twice and
    differ in the last bit for 158 of the 256 byte values. Here the product
    and the difference are exact in float64 (8 bits times 24 bits, then a
    multiple of 2^-30 below 1 in magnitude), so one cast to float32 gives the
    single-rounded value on any device.
    """
    return x.to(torch.float64).mul_(U8_SCALE).sub_(1.0).to(torch.float32)


def normalize_u8_np(x: np.ndarray) -> np.ndarray:
    """``normalize_u8`` on the host, for numpy arrays."""
    return (x.astype(np.float64) * U8_SCALE - 1.0).astype(np.float32)


class DataSource(abc.ABC):
    """An infinite, resumable-by-seed iterator of host numpy batches:
    ``image`` NHWC (uint8, or float32 in [-1, 1]) and ``label`` int32 where
    the source has labels."""

    batch_size: int

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        ...

    def reseeded(self, seed: int) -> "DataSource":
        """A shallow copy with another random stream (``ThreadedSource``
        workers keep their streams apart this way)."""
        src = copy.copy(self)
        if hasattr(src, "seed"):
            src.seed = seed
        return src


def microbatch_stack(source, n_micro: int) -> Iterator[Dict[str, np.ndarray]]:
    """Stack ``n_micro`` consecutive batches along a new leading axis: the
    fused step takes ``[n_micro, B, ...]``."""
    it = iter(source)
    while True:
        batches = [next(it) for _ in range(n_micro)]
        yield {k: np.stack([b[k] for b in batches]) for k in batches[0]}
