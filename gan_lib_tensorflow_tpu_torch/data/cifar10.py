"""CIFAR-10 loader (port of ``gan_lib_tensorflow_tpu/data/cifar10.py``):
unpickles ``cifar-10-batches-py`` into a uint8 NHWC store and yields an
infinite stream shuffled per epoch by ``default_rng(seed)``.

The batches are uint8 (``image``) with int32 ``label``; the device
normalizes them (``data/base.py:normalize_u8``), so the host only gathers.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np

from .base import DataSource

# the reference's search paths; its second names the root user's home
# directory, taken here as the running user's
_SEARCH_PATHS = (
    "data/cifar-10-batches-py",
    os.path.expanduser("~/data/cifar-10-batches-py"),
    "/data/cifar-10-batches-py",
)


def find_cifar10(data_dir: Optional[str] = None) -> Optional[str]:
    """The first of ``data_dir``, ``$GANTPU_DATA_DIR`` and the search paths
    that holds ``data_batch_1``, or None."""
    candidates = ([data_dir] if data_dir else []) + [
        os.environ.get("GANTPU_DATA_DIR", ""), *_SEARCH_PATHS]
    for c in candidates:
        if c and os.path.isfile(os.path.join(c, "data_batch_1")):
            return c
    return None


class Cifar10(DataSource):
    """``split`` "train" reads ``data_batch_1..5`` (50,000 images), anything
    else ``test_batch``."""

    def __init__(self, batch_size: int = 64, data_dir: Optional[str] = None,
                 split: str = "train", seed: int = 0):
        path = find_cifar10(data_dir)
        if path is None:
            raise FileNotFoundError(
                "cifar-10-batches-py not found (set GANTPU_DATA_DIR or pass "
                "data_dir); use --data fake for synthetic data")
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        images, labels = [], []
        for f in files:
            with open(os.path.join(path, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            images.append(d[b"data"])
            labels.append(np.asarray(d[b"labels"]))
        x = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.images = np.ascontiguousarray(x, np.uint8)
        self.labels = np.concatenate(labels).astype(np.int32)
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
