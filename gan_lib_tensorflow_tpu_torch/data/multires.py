"""Multi-resolution source for PGGAN's ladder (port of
``gan_lib_tensorflow_tpu/data/multires.py``): ``box_downsample`` and
``MultiResolution``, which wraps a max-resolution host source and
box-downsamples its batches to one level of the ladder.

``box_downsample`` computes what the reference's native tier computes
(``native/ganpipe.cpp:31-54``), bit for bit: each output pixel sums its
``f x f`` window in row-major ``(dy, dx)`` order, channel by channel,
starting from 0.0f in float32, then multiplies by the float32 ``1/(f*f)``.
(A ``reshape(...).mean((2, 4))`` is the reference's numpy fallback; it sums
in another order and divides, and differs in the last bits.)
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .base import DataSource
from .fake import FakeImages


def box_downsample(x: np.ndarray, factor: int) -> np.ndarray:
    """``[N, H, W, C]`` -> ``[N, H/f, W/f, C]`` float32, the native tier's
    sum order and scale."""
    x = np.asarray(x, np.float32)
    if factor == 1:
        return x
    n, h, w, c = x.shape
    oh, ow = h // factor, w // factor
    win = x[:, :oh * factor, :ow * factor].reshape(n, oh, factor, ow, factor, c)
    out = np.zeros((n, oh, ow, c), np.float32)
    for dy in range(factor):
        for dx in range(factor):
            out += win[:, :, dy, :, dx, :]
    out *= np.float32(1.0) / np.float32(factor * factor)
    return out


class MultiResolution(DataSource):
    """Wraps a max-resolution source (default: one-class host
    ``FakeImages``); yields ``{"image"}`` at ``resolution``."""

    def __init__(self, base: Optional[DataSource] = None, batch_size: int = 16,
                 max_resolution: int = 1024, resolution: int = 4, seed: int = 0):
        self.base = base or FakeImages(batch_size=batch_size, image_size=max_resolution,
                                       num_classes=1, seed=seed)
        self.batch_size = batch_size
        self.max_resolution = max_resolution
        self.resolution = resolution
        self.seed = getattr(self.base, "seed", seed)

    def reseeded(self, seed: int) -> "MultiResolution":
        out = self.at_resolution(self.resolution)
        out.base = self.base.reseeded(seed)
        out.seed = seed
        return out

    def at_resolution(self, resolution: int) -> "MultiResolution":
        out = MultiResolution.__new__(MultiResolution)
        out.base, out.batch_size = self.base, self.batch_size
        out.max_resolution, out.resolution, out.seed = (
            self.max_resolution, resolution, self.seed)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        factor = self.max_resolution // self.resolution
        for b in self.base:
            yield {"image": box_downsample(b["image"], factor)}
