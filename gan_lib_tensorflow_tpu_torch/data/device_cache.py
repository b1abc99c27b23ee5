"""Device-resident packed store (port of ``gan_lib_tensorflow_tpu/data/
device_cache.py:46-225``; the paired store is not ported).

The uint8 store and its int32 labels are uploaded to the card once; each
step then ships only its ``[n_micro, B]`` indices, gathers ``images[idx]``
on the card and normalizes there (``data/base.py:normalize_u8``, equal bit
for bit to the reference's and to a host gather of the same indices).

The index stream is epoch-shuffled and counter-based: step k's indices are
a pure function of ``(seed, k)``, one ``np.random.default_rng((seed,
epoch)).permutation(n)`` per epoch (the reference's numpy generator, so
both packages draw the same indices), and ``set_stream_position`` makes a
resumed run see the batches of an uninterrupted one.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from .base import normalize_u8
from .packed import META_NAME, PackedImageStore
from .pipeline import ThreadedSource

#: default device-memory budget of the ``auto`` policy (``--device-cache-gb``)
DEFAULT_CACHE_BYTES = 2 * 2**30


def packed_training_source(path: str, batch_size: int, n_micro: int = 1,
                           seed: int = 0, device="cuda", policy: str = "auto",
                           budget_bytes: int = DEFAULT_CACHE_BYTES):
    """The way to feed a packed store to the train loop.

    - ``auto``: ``DeviceCachedStore`` when the store fits ``budget_bytes``,
      else a uint8 stream (one ``ThreadedSource`` worker; the normalize runs
      on the device in ``prefetch_to_device``).
    - ``on``: the device cache, whose constructor refuses a store above the
      budget with a sized error.
    - ``off``: always stream.
    """
    if policy not in ("auto", "on", "off"):
        raise ValueError(f"device-cache policy must be auto|on|off, got {policy!r}")
    if policy != "off":
        with open(os.path.join(path, META_NAME)) as f:
            m = json.load(f)
        nbytes = m["n"] * m["height"] * m["width"] * m["channels"]
        if policy == "on" or nbytes <= budget_bytes:
            # the constructor counts images + labels and is the one budget check
            return DeviceCachedStore(path, batch_size=batch_size, n_micro=n_micro,
                                     seed=seed, device=device, max_bytes=budget_bytes)
        print(f"note: packed store {path} is {nbytes / 2**30:.2f} GiB > "
              f"device-cache budget {budget_bytes / 2**30:.2f} GiB; "
              "streaming with uint8 wire", flush=True)
    return ThreadedSource(PackedImageStore(path, batch_size=batch_size, seed=seed,
                                           wire_dtype="uint8"),
                          num_workers=1)


def _epoch_permutation(store, epoch: int) -> np.ndarray:
    """The shuffle of ``epoch``, a pure function of ``(seed, epoch)``,
    computed once per epoch and kept on the instance."""
    cached = getattr(store, "_perm_cache", None)
    if cached is None or cached[0] != epoch:
        order = np.random.default_rng((store.seed, epoch)).permutation(store.n)
        store._perm_cache = (epoch, order)
        return order
    return cached[1]


class DeviceCachedStore:
    """Infinite ``{"image": [n_micro, B, H, W, C] float32, "label":
    [n_micro, B] int32}`` batches on ``device``, gathered from a store held
    there. ``yields_stacks``: the loop takes its batches as they are."""

    yields_stacks = True

    def __init__(self, path: Optional[str] = None, batch_size: int = 64,
                 n_micro: int = 1, seed: int = 0, device="cuda",
                 max_bytes: Optional[int] = None,
                 images: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None, num_classes: int = 0):
        if path is not None:
            store = PackedImageStore(path, batch_size=batch_size, seed=seed)
            images = np.array(store.images)  # read the memmap's pages once
            labels = store.labels
            num_classes = store.num_classes
            self.meta = store.meta
        elif images is None:
            raise ValueError("need a packed-store path or an images array")
        elif images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"images must be [N,H,W,C] uint8, got "
                             f"{images.dtype} {images.shape}")
        self.num_classes = num_classes
        self.image_size = images.shape[1]
        self.path = path
        nbytes = images.nbytes + (0 if labels is None else labels.size * 4)
        if max_bytes is not None and nbytes > max_bytes:
            raise ValueError(
                f"store {path or '<arrays>'} is {nbytes / 2**30:.2f} GiB > "
                f"device-cache budget {max_bytes / 2**30:.2f} GiB; stream it "
                "instead (--device-cache off, or raise --device-cache-gb)")
        take = n_micro * batch_size
        if len(images) < take:
            raise ValueError(
                f"store {path or '<arrays>'} holds {len(images)} images < "
                f"one fused-step stack of n_micro*batch = {take}; shrink "
                "--batch-size or repack more images")
        self.batch_size = batch_size
        self.n_micro = n_micro
        self.seed = seed
        self.n = len(images)
        self._steps_per_epoch = self.n // take
        self.device = resolve_device(device)
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self._labels = (None if labels is None else torch.from_numpy(
            np.asarray(labels, np.int32)).to(self.device))
        self._pos = 0

    def __len__(self) -> int:
        return self.n

    def nbytes_resident(self) -> int:
        return int(self._images.nbytes
                   + (0 if self._labels is None else self._labels.nbytes))

    def set_stream_position(self, pos: int) -> None:
        """Make the next batch batch ``pos`` of the stream (the train loop
        primes this with the resumed step)."""
        self._pos = int(pos)

    def indices_for(self, pos: int) -> np.ndarray:
        """The ``[n_micro, batch]`` int32 indices of step ``pos``: a pure
        function of ``(seed, pos)``."""
        take = self.n_micro * self.batch_size
        epoch, off = divmod(pos, self._steps_per_epoch)
        order = _epoch_permutation(self, epoch)
        sl = order[off * take:(off + 1) * take]
        return sl.reshape(self.n_micro, self.batch_size).astype(np.int32)

    def gather(self, idx: np.ndarray) -> dict:
        """Images (normalized) and labels of ``idx`` (any shape), on the
        device."""
        i = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        out = {"image": normalize_u8(self._images[i])}
        if self._labels is not None:
            out["label"] = self._labels[i]
        return out

    def __iter__(self) -> Iterator[dict]:
        # the position lives on the instance: a second iter() continues
        while True:
            idx = self.indices_for(self._pos)
            self._pos += 1
            yield self.gather(idx)

    def sequential_batches(self, batch_size: int, n_batches: int) -> Iterator[torch.Tensor]:
        """Normalized ``[B, H, W, C]`` batches of the first ``n_batches *
        batch_size`` images, in order, from the resident store (the real
        moments of an eval read them without a second upload). The training
        stream's position does not move."""
        if n_batches * batch_size > self.n:
            raise ValueError(
                f"sequential_batches({batch_size}, {n_batches}) needs "
                f"{n_batches * batch_size} images but the store holds {self.n}")
        for i in range(n_batches):
            yield normalize_u8(self._images[i * batch_size:(i + 1) * batch_size])
