"""Device-resident packed stores (port of ``gan_lib_tensorflow_tpu/data/
device_cache.py:46-370``): ``DeviceCachedStore`` and pix2pix's
``DeviceCachedPairedStore``.

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
from ..parallel.sharding import data_rows, height_rows
from ..utils.profiler import span
from .base import normalize_u8
from .packed import META_NAME, PackedImageStore, PackedPairedStore, crop_pairs
from .pipeline import ThreadedSource

#: default device-memory budget of the ``auto`` policy (``--device-cache-gb``)
DEFAULT_CACHE_BYTES = 2 * 2**30


def _fits_cache(path: str, policy: str, budget_bytes: int) -> bool:
    """Whether ``policy`` puts the store at ``path`` on the device: ``on``
    always (the cache's constructor is the one budget check then), ``auto``
    when its images fit ``budget_bytes``, ``off`` never."""
    if policy not in ("auto", "on", "off"):
        raise ValueError(f"device-cache policy must be auto|on|off, got {policy!r}")
    if policy == "off":
        return False
    with open(os.path.join(path, META_NAME)) as f:
        m = json.load(f)
    nbytes = m["n"] * m["height"] * m["width"] * m["channels"]
    if policy == "on" or nbytes <= budget_bytes:
        return True
    print(f"note: packed store {path} is {nbytes / 2**30:.2f} GiB > "
          f"device-cache budget {budget_bytes / 2**30:.2f} GiB; streaming it", flush=True)
    return False


def packed_training_source(path: str, batch_size: int, n_micro: int = 1,
                           seed: int = 0, device="cuda", policy: str = "auto",
                           budget_bytes: int = DEFAULT_CACHE_BYTES, mesh=None,
                           spatial_axis: Optional[str] = None):
    """The way to feed a packed store to the train loop.

    - ``auto``: ``DeviceCachedStore`` when the store fits ``budget_bytes``,
      else a uint8 stream (one ``ThreadedSource`` worker; the normalize runs
      on the device in ``prefetch_to_device``).
    - ``on``: the device cache, whose constructor refuses a store above the
      budget with a sized error.
    - ``off``: always stream.

    On a ``mesh`` the cache yields the rank's rows (and with
    ``spatial_axis`` its height rows); a stream yields global batches, which
    the train loop cuts the same way.
    """
    if _fits_cache(path, policy, budget_bytes):
        return DeviceCachedStore(path, batch_size=batch_size, n_micro=n_micro,
                                 seed=seed, device=device, max_bytes=budget_bytes,
                                 mesh=mesh, spatial_axis=spatial_axis)
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
    there. ``yields_stacks``: the loop takes its batches as they are. On a
    ``mesh`` every rank holds the whole store (the reference replicates it),
    draws the global indices and gathers only its rows; with
    ``spatial_axis``, only its height rows of them (reference
    ``device_cache.py:111-175``)."""

    yields_stacks = True

    def __init__(self, path: Optional[str] = None, batch_size: int = 64,
                 n_micro: int = 1, seed: int = 0, device="cuda",
                 max_bytes: Optional[int] = None,
                 images: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None, num_classes: int = 0,
                 mesh=None, spatial_axis: Optional[str] = None):
        self.mesh, self._rows = mesh, data_rows(batch_size, mesh)
        self.spatial_axis = spatial_axis
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
        # the rank's height rows of every image (all of them without an 'sp' axis)
        self._height = (slice(None) if spatial_axis is None
                        else height_rows(images.shape[1], mesh, spatial_axis))
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
        """Images (normalized; the rank's height rows under ``spatial_axis``)
        and labels of ``idx`` (any shape), on the device."""
        with span("data.upload"):  # from pageable memory: waits for the card
            i = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        with span("data.gather"):
            out = {"image": normalize_u8(self._images[:, self._height][i])}
            if self._labels is not None:
                out["label"] = self._labels[i]
        return out

    def __iter__(self) -> Iterator[dict]:
        # the position lives on the instance: a second iter() continues
        while True:
            with span("data.batch"):
                with span("data.indices"):
                    idx = self.indices_for(self._pos)
                self._pos += 1
                batch = self.gather(idx[:, self._rows])
            yield batch

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


def packed_paired_training_source(path: str, batch_size: int, image_size: int = 256,
                                  which_direction: str = "AtoB", flip: bool = True,
                                  n_micro: int = 1, seed: int = 0, device="cuda",
                                  policy: str = "auto",
                                  budget_bytes: int = DEFAULT_CACHE_BYTES, mesh=None):
    """The way to feed a paired store to pix2pix's train loop, by the
    policy rule of ``packed_training_source``: ``DeviceCachedPairedStore``,
    or one ``ThreadedSource`` worker streaming ``PackedPairedStore``'s
    float32 batches (the jitter runs on the host then)."""
    kw = dict(batch_size=batch_size, image_size=image_size,
              which_direction=which_direction, flip=flip, seed=seed)
    if _fits_cache(path, policy, budget_bytes):
        return DeviceCachedPairedStore(path, n_micro=n_micro, device=device,
                                       max_bytes=budget_bytes, mesh=mesh, **kw)
    return ThreadedSource(PackedPairedStore(path, **kw), num_workers=1)


class DeviceCachedPairedStore:
    """pix2pix's twin of ``DeviceCachedStore``: the combined A|B uint8 rows
    live on ``device``; each step ships its indices, crop offsets and flip
    bits (one small copy) and ``crop_pairs`` jitters, crops and normalizes
    both halves there, in one gather. Infinite ``{"input", "target"}``
    ``[n_micro, B, c, c, 3]`` float32 stacks; ``yields_stacks``.

    ``controls_for(pos)`` is a pure function of ``(seed, pos)`` (the
    reference's: ``_epoch_permutation`` for the indices, ``default_rng((seed,
    pos, 1))`` for the offsets and flips), so a resumed run replays the
    stream; a batch equals ``PackedPairedStore``'s host jitter of the same
    controls bit for bit. On a ``mesh`` every rank draws the global controls
    and gathers its rows."""

    yields_stacks = True

    def __init__(self, path: str, batch_size: int = 1, image_size: int = 256,
                 which_direction: str = "AtoB", flip: bool = True, n_micro: int = 1,
                 seed: int = 0, device="cuda", max_bytes: Optional[int] = None,
                 mesh=None):
        self.mesh, self._rows = mesh, data_rows(batch_size, mesh)
        host = PackedPairedStore(path, batch_size=batch_size, image_size=image_size,
                                 which_direction=which_direction, flip=flip, seed=seed)
        if max_bytes is not None and host.images.nbytes > max_bytes:
            raise ValueError(
                f"store {path} is {host.images.nbytes / 2**30:.2f} GiB > "
                f"device-cache budget {max_bytes / 2**30:.2f} GiB; stream it "
                "instead (--device-cache off, or raise --device-cache-gb)")
        take = n_micro * batch_size
        if len(host) < take:
            raise ValueError(f"store {path} holds {len(host)} pairs < one fused-step "
                             f"stack of n_micro*batch = {take}")
        self.meta, self.path = host.meta, path
        self.image_size, self.scale, self.flip = image_size, host.scale, flip
        self.batch_size, self.n_micro, self.seed = batch_size, n_micro, seed
        self.n = len(host)
        self._steps_per_epoch = self.n // take
        self._offsets = host._offsets()
        self.device = resolve_device(device)
        self._store = torch.from_numpy(np.array(host.images)).to(self.device)
        self._pos = 0

    def __len__(self) -> int:
        return self.n

    def nbytes_resident(self) -> int:
        return int(self._store.nbytes)

    def set_stream_position(self, pos: int) -> None:
        """Make the next batch batch ``pos`` of the stream (the train loop
        primes this with the resumed step)."""
        self._pos = int(pos)

    def controls_for(self, pos: int):
        """``(idx, oy, ox, flip)`` of step ``pos``, each ``[n_micro * B]``."""
        take = self.n_micro * self.batch_size
        epoch, off = divmod(pos, self._steps_per_epoch)
        idx = _epoch_permutation(self, epoch)[off * take:(off + 1) * take].astype(np.int32)
        jr = np.random.default_rng((self.seed, pos, 1))
        oy, ox = jr.integers(0, self.scale - self.image_size + 1, (2, take)).astype(np.int32)
        fl = (jr.random(take) < 0.5) if self.flip else np.zeros(take, bool)
        return idx, oy, ox, fl

    def gather(self, idx, oy, ox, fl) -> dict:
        """The ``[n_micro, b, c, c, 3]`` stacks of these controls (each
        ``[n_micro * b]``), on the device."""
        with span("data.upload"):  # from pageable memory: waits for the card
            ctl = torch.from_numpy(np.stack([idx, oy, ox, fl]).astype(np.int64)).to(self.device)
        c = self.image_size
        with span("data.gather"):
            inp, tgt = crop_pairs(self._store, ctl[0], ctl[1], ctl[2], ctl[3].bool(), c,
                                  *self._offsets)
        shape = (self.n_micro, -1, c, c, inp.shape[-1])
        return {"input": inp.view(shape), "target": tgt.view(shape)}

    def __iter__(self) -> Iterator[dict]:
        # the position lives on the instance: a second iter() continues
        while True:
            with span("data.batch"):
                with span("data.indices"):
                    controls = self.controls_for(self._pos)
                self._pos += 1
                batch = self.gather(*(c.reshape(self.n_micro, -1)[:, self._rows].reshape(-1)
                                      for c in controls))
            yield batch
