"""Prepacked uint8 image stores (port of ``gan_lib_tensorflow_tpu/data/
packed.py``): ``PackedImageStore``, pix2pix's ``PackedPairedStore``, and
PGGAN's pyramid stores (``resolve_pyramid_dir``, ``open_pyramid``, and
``write_pyramid``, the writer of ``tools/prepack_dataset.py --resolutions``,
with ``write_rich_pyramid``, a synthetic one at that layout).

Store layout (one directory):
  meta.json   {"n", "height", "width", "channels", "num_classes", ...}
              (+ "paired": true for a paired store)
  images.u8   raw [N, H, W, C] uint8, C-contiguous (read through np.memmap);
              a paired store's rows are combined A|B, [N, s, 2s, 3]
  labels.npy  int32 [N] (absent for unlabeled datasets)

A pyramid store is one such store per ladder resolution, in members
``r{res:04d}/`` of one directory (``r1024/`` ... ``r0004/``).

A store larger than host memory stays on disk: batches are gathered out of
the read-only memmap's page cache, one batch at a time.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .base import DataSource, normalize_u8, normalize_u8_np
from .fake import FakeImages
from .multires import box_downsample

META_NAME = "meta.json"


def is_packed_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, META_NAME))


def store_digest(path: str) -> str:
    """sha256 over every file of a store (or pyramid) directory: each
    file's path relative to ``path``, then its bytes, in sorted order."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            f = os.path.join(root, name)
            h.update(os.path.relpath(f, path).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def write_store(out_dir: str, n: int, height: int, width: int,
                channels: int = 3, classes=None, paired: bool = False):
    """Create a store for incremental writing; returns ``(images_memmap,
    labels_array or None)``. The caller fills both, then calls
    ``finalize_store``. ``paired``: a pix2pix store of combined A|B rows
    (``width`` = 2 x ``height``), as ``tools/prepack_dataset.py --paired``
    writes it."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.memmap(os.path.join(out_dir, "images.u8"), np.uint8, "w+",
                       shape=(n, height, width, channels))
    labels = None if classes is None else np.zeros((n,), np.int32)
    meta = {"n": n, "height": height, "width": width, "channels": channels,
            "num_classes": 0 if classes is None else len(classes),
            "classes": classes, "format": "ganpack-v1"}
    if paired:
        meta["paired"] = True
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


def crop_pairs(rows: torch.Tensor, idx: torch.Tensor, oy: torch.Tensor,
               ox: torch.Tensor, flip: torch.Tensor, crop: int, in_x: int,
               tg_x: int):
    """pix2pix's jitter of ``K`` examples in one gather: example k takes row
    ``idx[k]`` of the combined A|B ``rows`` (uint8 ``[N, s, 2s, C]``, any
    device), crops the window at ``(oy[k], ox[k])`` of each half (the input's
    at column ``in_x + ox``, the target's at ``tg_x + ox``), flips both
    horizontally where ``flip[k]``, and normalizes (``normalize_u8``).
    Returns ``(input, target)``, float32 ``[K, crop, crop, C]``."""
    ar = torch.arange(crop, device=rows.device)
    ys = (oy[:, None] + ar)[:, :, None]  # [K, c, 1]
    xs = (ox[:, None] + torch.where(flip[:, None], crop - 1 - ar, ar))[:, None, :]
    i = idx[:, None, None]
    return normalize_u8(rows[i, ys, in_x + xs]), normalize_u8(rows[i, ys, tg_x + xs])


class PackedPairedStore(DataSource):
    """Shuffled infinite paired batches ``{"input", "target"}`` (float32
    NHWC in [-1, 1]) out of a paired store, with the reference's jitter: per
    example one random crop ``scale -> image_size`` and one horizontal flip,
    shared by both halves. The draws from ``default_rng(seed)`` come in the
    reference's order: a permutation per epoch, then per example
    ``integers(0, s - c + 1, 2)`` and (with ``flip``) ``random() < 0.5``; the
    batches equal the reference's bit for bit (``crop_pairs`` normalizes as
    its native ``crop_flip_normalize`` does)."""

    def __init__(self, path: str, batch_size: int = 1, image_size: int = 256,
                 which_direction: str = "AtoB", flip: bool = True, seed: int = 0):
        meta_path = os.path.join(path, META_NAME)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(f"not a packed store (no {META_NAME}): {path}")
        with open(meta_path) as f:
            self.meta = json.load(f)
        m = self.meta
        if not m.get("paired"):
            raise ValueError(f"{path} is a single-image store; repack it with "
                             "tools/prepack_dataset.py --paired for pix2pix")
        if which_direction not in ("AtoB", "BtoA"):
            raise ValueError(f"which_direction must be AtoB|BtoA, got {which_direction!r}")
        self.scale = m["height"]
        if image_size > self.scale:
            raise ValueError(f"image_size {image_size} exceeds the store's scale_size "
                             f"{self.scale}; repack with a larger --scale-size")
        if m["n"] < batch_size:
            # an epoch would hold no batch and the iterator would spin forever
            raise ValueError(f"store {path} holds {m['n']} pairs < batch_size "
                             f"{batch_size}; shrink --batch-size or repack more images")
        self.images = np.memmap(os.path.join(path, "images.u8"), np.uint8, "r",
                                shape=(m["n"], m["height"], m["width"], m["channels"]))
        self.image_size = image_size
        self.which_direction = which_direction
        self.flip = flip
        self.batch_size = batch_size
        self.seed = seed
        self.path = path

    def __len__(self) -> int:
        return int(self.meta["n"])

    def _offsets(self):
        """(input_x, target_x) base columns of the two halves of a row."""
        return (self.scale, 0) if self.which_direction == "BtoA" else (0, self.scale)

    def _crops(self, idx, oy, ox, flip) -> Dict[str, np.ndarray]:
        rows = torch.from_numpy(np.asarray(self.images[np.asarray(idx)]))
        k = len(rows)
        inp, tgt = crop_pairs(rows, torch.arange(k), torch.as_tensor(oy),
                              torch.as_tensor(ox), torch.as_tensor(flip, dtype=torch.bool),
                              self.image_size, *self._offsets())
        return {"input": inp.numpy(), "target": tgt.numpy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n, span = len(self), self.scale - self.image_size + 1
        while True:
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = np.sort(order[i:i + self.batch_size])
                oy, ox, flip = [], [], []
                for _ in idx:
                    y, x = (int(v) for v in rng.integers(0, span, 2))
                    oy.append(y)
                    ox.append(x)
                    flip.append(bool(self.flip and rng.random() < 0.5))
                yield self._crops(idx, oy, ox, flip)

    def eval_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        """The test-mode pass: center crop, no flip, store order, one
        example per batch, with its ``name``."""
        o = (self.scale - self.image_size) // 2
        for j in range(len(self)):
            yield {**self._crops([j], [o], [o], [False]), "name": f"{j:05d}"}


def resolve_pyramid_dir(path: str, resolution: int) -> str:
    """The store of ``resolution``: the ``r{resolution:04d}/`` member of a
    pyramid store, or ``path`` itself when it is a single store of that
    size. A single store of another size raises ``ValueError``; no store at
    all raises ``FileNotFoundError`` (reference ``packed.py:225-241``)."""
    sub = os.path.join(path, f"r{resolution:04d}")
    if is_packed_dir(sub):
        return sub
    if is_packed_dir(path):
        with open(os.path.join(path, META_NAME)) as f:
            height = json.load(f)["height"]
        if height != resolution:
            raise ValueError(f"store {path} is {height}px, wanted {resolution}px "
                             f"and no r{resolution:04d}/ member exists")
        return path
    raise FileNotFoundError(f"no packed store at {path} (or {sub})")


def open_pyramid(path: str, batch_size: int, resolution: int, seed: int = 0,
                 wire_dtype: str = "float32") -> PackedImageStore:
    """The pyramid member (or matching single store) at ``resolution``."""
    return PackedImageStore(resolve_pyramid_dir(path, resolution),
                            batch_size=batch_size, seed=seed, wire_dtype=wire_dtype)


def write_pyramid(out_dir: str, images: np.ndarray,
                  resolutions: Sequence[int]) -> Dict[int, str]:
    """Write ``images`` (uint8 ``[N, R, R, C]``, R = ``resolutions[0]``) as an
    unlabeled pyramid store, one member per resolution (descending from R).
    Each chunk of 64 images is box-downsampled by 2 in float32 level after
    level, and each level is rounded half to even, clipped to [0, 255] and
    stored as uint8: the writer of ``tools/prepack_dataset.py:97-114``, equal
    to it byte for byte. Returns ``{resolution: member directory}``."""
    res = list(resolutions)
    n, top = len(images), images.shape[1]
    if res[0] != top or res != sorted(res, reverse=True):
        raise ValueError(f"resolutions {res} must start at the images' {top} and descend")
    dirs = {r: os.path.join(out_dir, f"r{r:04d}") for r in res}
    stores = [write_store(dirs[r], n, r, r, images.shape[3])[0] for r in res]
    for pos in range(0, n, 64):
        cur, cur_res, f32 = images[pos:pos + 64], top, None
        for r, store in zip(res, stores):
            if r != cur_res:
                if f32 is None:
                    f32 = cur.astype(np.float32)
                while cur_res > r:
                    f32 = box_downsample(f32, 2)
                    cur_res //= 2
                cur = np.clip(np.rint(f32), 0, 255).astype(np.uint8)
            store[pos:pos + len(cur)] = cur
    for r, store in zip(res, stores):
        finalize_store(dirs[r], store, None)
    return dirs


def write_rich_pyramid(out_dir: str, n_images: int = 64, resolution: int = 1024,
                       seed: int = 0) -> Dict[int, str]:
    """A synthetic dataset at a real pyramid's layout: ``n_images`` (a
    multiple of 16) host ``FakeImages(style="rich")`` at ``resolution``,
    mapped from [-1, 1] to uint8 and written by ``write_pyramid`` as members
    ``resolution`` ... 4."""
    src = iter(FakeImages(batch_size=16, image_size=resolution, num_classes=1,
                          seed=seed, style="rich"))
    u8 = np.concatenate([np.clip(np.rint((next(src)["image"] + 1.0) * 127.5), 0, 255)
                         .astype(np.uint8) for _ in range(n_images // 16)])
    return write_pyramid(out_dir, u8, [resolution >> i
                                       for i in range(resolution.bit_length() - 2)])
