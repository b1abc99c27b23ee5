"""Downsampled-ImageNet npz loader for SNGAN-projection 128x128 (port of
``ImageNetNpz`` from ``gan_lib_tensorflow_tpu/data/imagenet.py:21-57``; the
image-folder loaders, which decode with Pillow, are not ported).

An npz holds ``data`` (``[N, H*W*3]`` row-major CHW, as CIFAR's pickles, or
``[N, H, W, 3]``) uint8 and ``labels`` (or ``label``); downsampled-ImageNet
labels are 1-based and shift to 0-based. Batches are uint8 NHWC with int32
labels; the device normalizes them.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator

import numpy as np

from .base import DataSource


class ImageNetNpz(DataSource):
    """One npz file, or every ``*.npz`` of a directory in sorted order."""

    def __init__(self, path: str, batch_size: int = 64, image_size: int = 128,
                 seed: int = 0):
        files = (sorted(glob.glob(os.path.join(path, "*.npz")))
                 if os.path.isdir(path) else [path])
        if not files:
            raise FileNotFoundError(f"no npz files under {path}")
        xs, ys = [], []
        for f in files:
            with np.load(f) as d:
                x = d["data"]
                if x.ndim == 2:
                    x = x.reshape(-1, 3, image_size, image_size).transpose(0, 2, 3, 1)
                xs.append(np.ascontiguousarray(x, np.uint8))
                ys.append(np.asarray(d["labels"] if "labels" in d else d["label"],
                                     np.int32))
        self.images = np.concatenate(xs)
        self.labels = np.concatenate(ys)
        if self.labels.min() == 1:
            self.labels = self.labels - 1
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = len(self.images)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[i:i + self.batch_size]
                yield {"image": self.images[idx], "label": self.labels[idx]}
