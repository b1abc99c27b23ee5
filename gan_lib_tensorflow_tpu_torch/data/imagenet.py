"""ImageNet-style loaders (port of ``gan_lib_tensorflow_tpu/data/imagenet.py``):
the downsampled-ImageNet npz loader for SNGAN-projection 128x128, and the
two image-folder loaders.

An npz holds ``data`` (``[N, H*W*3]`` row-major CHW, as CIFAR's pickles, or
``[N, H, W, 3]``) uint8 and ``labels`` (or ``label``); downsampled-ImageNet
labels are 1-based and shift to 0-based. Its batches are uint8 NHWC with
int32 labels; the device normalizes them.

``ImageFolderFlat`` (an unlabelled folder, CelebA-HQ style: PGGAN's reals)
and ``ImageFolderByClass`` (one subdirectory per class: ImageNet) decode
each file with ``data/codec.py`` (the hand-written JPEG/PNG decoder and
Pillow's bilinear resize, byte-equal to the reference's Pillow path),
center-crop it to its short side, resize it to ``image_size`` and yield
float32 batches normalized as the reference's do (``codec.to_float_div``):
equal to the reference's batches bit for bit.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List

import numpy as np

from . import codec
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


def check_count(n: int, batch_size: int, path: str) -> None:
    """Refuse a folder of fewer images than a batch: an epoch would hold no
    batch, and the iterator, as the reference's does, would spin forever."""
    if n < batch_size:
        raise ValueError(f"{path} holds {n} images < batch_size {batch_size}")


class ImageFolderFlat(DataSource):
    """Unlabelled ``*.jpg``/``*.jpeg``/``*.png`` of one folder in sorted
    order (the reference's glob patterns: case-sensitive), center-cropped
    and resized to ``image_size``; yields ``{"image"}``."""

    def __init__(self, path: str, batch_size: int = 16, image_size: int = 1024,
                 seed: int = 0):
        self.files = sorted(f for ext in ("*.jpg", "*.jpeg", "*.png")
                            for f in glob.glob(os.path.join(path, ext)))
        if not self.files:
            raise FileNotFoundError(f"no images under {path}")
        check_count(len(self.files), batch_size, path)
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = len(self.files)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                yield {"image": np.stack([
                    codec.to_float_div(codec.load_square(self.files[j], self.image_size))
                    for j in order[i:i + self.batch_size]])}


class ImageFolderByClass(DataSource):
    """One sorted subdirectory per class; its files whose lower-cased names
    end in ``.jpg``/``.jpeg``/``.png``, in sorted order; center-cropped and
    resized to ``image_size``; yields ``{"image", "label"}`` (int32)."""

    def __init__(self, path: str, batch_size: int = 64, image_size: int = 128,
                 seed: int = 0):
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {path}")
        self.files: List[str] = []
        self.file_labels: List[int] = []
        for ci, c in enumerate(classes):
            for f in sorted(glob.glob(os.path.join(path, c, "*"))):
                if f.lower().endswith((".jpg", ".jpeg", ".png")):
                    self.files.append(f)
                    self.file_labels.append(ci)
        check_count(len(self.files), batch_size, path)
        self.num_classes = len(classes)
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = len(self.files)
        labels = np.asarray(self.file_labels, np.int32)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[i:i + self.batch_size]
                yield {"image": np.stack([
                    codec.to_float_div(codec.load_square(self.files[j], self.image_size))
                    for j in idx]), "label": labels[idx]}
