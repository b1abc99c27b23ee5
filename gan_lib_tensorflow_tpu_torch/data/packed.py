"""Prepacked uint8 image store (port of ``gan_lib_tensorflow_tpu/data/
packed.py:36-126``; the paired store and the PGGAN pyramid are not ported).

Store layout (one directory):
  meta.json   {"n", "height", "width", "channels", "num_classes", ...}
  images.u8   raw [N, H, W, C] uint8, C-contiguous (read through np.memmap)
  labels.npy  int32 [N] (absent for unlabeled datasets)

A store larger than host memory stays on disk: batches are gathered out of
the read-only memmap's page cache, one batch at a time.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

from .base import DataSource, normalize_u8_np

META_NAME = "meta.json"


def is_packed_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, META_NAME))


def write_store(out_dir: str, n: int, height: int, width: int,
                channels: int = 3, classes=None):
    """Create a store for incremental writing; returns ``(images_memmap,
    labels_array or None)``. The caller fills both, then calls
    ``finalize_store``."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.memmap(os.path.join(out_dir, "images.u8"), np.uint8, "w+",
                       shape=(n, height, width, channels))
    labels = None if classes is None else np.zeros((n,), np.int32)
    meta = {"n": n, "height": height, "width": width, "channels": channels,
            "num_classes": 0 if classes is None else len(classes),
            "classes": classes, "format": "ganpack-v1"}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return images, labels


def finalize_store(out_dir: str, images: np.memmap,
                   labels: Optional[np.ndarray]) -> None:
    images.flush()
    if labels is not None:
        np.save(os.path.join(out_dir, "labels.npy"), labels)


class PackedImageStore(DataSource):
    """Shuffled infinite batches out of a store: one ``default_rng(seed)``
    permutation per epoch, indices sorted within each batch (a quasi
    sequential page-cache walk; labels stay paired).

    ``wire_dtype="uint8"`` (the port's streaming mode) yields the raw bytes
    and leaves the normalize to the device (``prefetch_to_device``);
    ``"float32"`` normalizes on the host with the same value."""

    def __init__(self, path: str, batch_size: int = 64, seed: int = 0,
                 wire_dtype: str = "float32"):
        meta_path = os.path.join(path, META_NAME)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(f"not a packed store (no {META_NAME}): {path}")
        with open(meta_path) as f:
            self.meta = json.load(f)
        m = self.meta
        self.images = np.memmap(
            os.path.join(path, "images.u8"), np.uint8, "r",
            shape=(m["n"], m["height"], m["width"], m["channels"]))
        labels_path = os.path.join(path, "labels.npy")
        self.labels = np.load(labels_path) if os.path.exists(labels_path) else None
        self.num_classes = m.get("num_classes", 0)
        self.image_size = m["height"]
        if m["n"] < batch_size:
            # an epoch would hold no batch and the iterator would spin forever
            raise ValueError(
                f"store {path} holds {m['n']} images < batch_size "
                f"{batch_size}; shrink --batch-size or repack more images")
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype must be float32|uint8, got {wire_dtype!r}")
        self.batch_size = batch_size
        self.seed = seed
        self.path = path
        self.wire_dtype = wire_dtype

    def __len__(self) -> int:
        return int(self.meta["n"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = len(self)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = np.sort(order[i:i + self.batch_size])
                img = self.images[idx]
                out = {"image": img if self.wire_dtype == "uint8" else normalize_u8_np(img)}
                if self.labels is not None:
                    out["label"] = self.labels[idx]
                yield out
