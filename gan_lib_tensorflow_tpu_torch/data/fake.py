"""Synthetic data (port of ``gan_lib_tensorflow_tpu/data/fake.py``): the
host ``FakeImages`` (``:110-137``) and its device twin ``DeviceFakeImages``
(``:154-253``), each in the ``blobs`` and ``rich`` styles, and pix2pix's
pairs, ``FakePairedImages`` on the host and ``DeviceFakePairedImages`` on the
device (``:256-372``).

``blobs``: one class-pinned gaussian blob (plus a jittered copy) per image,
low noise, clipped to [-1, 1]. ``rich``: three anisotropic blobs with
continuous random centers, sizes, weights and colors over an oriented
background gradient (``_compose_rich``, one function for numpy and torch),
blob 0 tinted toward the class color. The class table is the reference's,
so class k looks the same in both packages. The host sources draw from
``np.random.default_rng(seed)`` as the reference does, so their batches are
the reference's bit for bit; the device sources draw from a
``torch.Generator`` (distribution twins: the random streams differ).

The device streams are counter-based, as the reference's are (``fold_in(key,
k)``): batch k depends only on ``(seed, k)``, because the generator is
re-seeded from both before each render (on the host, no device sync). The
position lives on the instance, and ``set_stream_position`` sets it, so a
resumed run sees the batches an uninterrupted run sees.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..parallel.sharding import data_rows, shard_batch
from .base import DataSource

_MAX_CLASS_TABLE = 1024


def _class_table(num_classes: int):
    """Per-class (cx, cy), color, sigma; deterministic in the class id
    (a copy of the reference's table)."""
    g = np.random.default_rng(7919)
    n = min(num_classes, _MAX_CLASS_TABLE)
    cxy = g.uniform(0.25, 0.75, (n, 2)).astype(np.float32)
    color = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    sigma = (0.08 + 0.04 * (np.arange(n) % 5)).astype(np.float32)
    return cxy, color, sigma


def _blob_images(rng: np.random.Generator, labels: np.ndarray, size: int,
                 num_classes: int) -> np.ndarray:
    """The ``blobs`` style on the host, NHWC float32 in [-1, 1] (the
    reference's, draw for draw)."""
    n = labels.shape[0]
    cxy, color, sigma = _class_table(num_classes)
    lab = labels % len(sigma)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    cx = cxy[lab, 0][:, None, None]
    cy = cxy[lab, 1][:, None, None]
    sg = sigma[lab][:, None, None]
    jit = rng.uniform(-0.08, 0.08, (n, 2)).astype(np.float32)
    d1 = (xx[None] - cx) ** 2 + (yy[None] - cy) ** 2
    d2 = ((xx[None] - cx - jit[:, 0, None, None]) ** 2
          + (yy[None] - cy - jit[:, 1, None, None]) ** 2)
    inv = -1.0 / (2 * sg**2)
    blob = 0.5 * (np.exp(d1 * inv) + np.exp(d2 * inv))
    img = blob[..., None] * color[lab][:, None, None, :]
    img += 0.05 * rng.standard_normal(img.shape, dtype=np.float32)
    return np.clip(img, -1, 1, out=img)


_RICH_BLOBS = 3


def _compose_rich(xp, xx, yy, lab_color, centers, sigmas, weights, colors,
                  bg_color, bg_dir, noise):
    """The ``rich`` renderer of the host (``xp`` numpy) and device (``xp``
    torch) sources: ``_RICH_BLOBS`` anisotropic gaussian blobs plus an
    oriented background gradient plus ``noise``, clipped to [-1, 1]; blob
    0's color is tinted halfway toward ``lab_color``. The parameters' leading
    dims are batch dims; ``xx``/``yy`` are ``(H, W)`` grids in [0, 1]
    (reference ``fake.py:61-91``)."""
    colors = xp.concatenate(
        [(0.5 * lab_color + 0.5 * colors[..., 0, :])[..., None, :],
         colors[..., 1:, :]], axis=-2)
    img = (bg_color[..., None, None, :]
           * (bg_dir[..., 0, None, None] * (xx - 0.5)
              + bg_dir[..., 1, None, None] * (yy - 0.5))[..., None])
    for k in range(_RICH_BLOBS):
        cx = centers[..., k, 0][..., None, None]
        cy = centers[..., k, 1][..., None, None]
        sx = sigmas[..., k, 0][..., None, None]
        sy = sigmas[..., k, 1][..., None, None]
        g = xp.exp(-((xx - cx) ** 2 / (2 * sx**2)
                     + (yy - cy) ** 2 / (2 * sy**2)))
        img = img + (weights[..., k][..., None, None, None]
                     * g[..., None] * colors[..., k, :][..., None, None, :])
    return xp.clip(img + noise, -1, 1)


def _rich_images_np(rng: np.random.Generator, labels: np.ndarray, size: int,
                    num_classes: int) -> np.ndarray:
    """The ``rich`` style on the host (the reference's, draw for draw)."""
    n = labels.shape[0]
    _, class_color, _ = _class_table(num_classes)
    lab_color = class_color[labels % len(class_color)]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    K = _RICH_BLOBS
    u = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    return _compose_rich(
        np, xx[None], yy[None], lab_color,
        centers=u(0.15, 0.85, (n, K, 2)), sigmas=u(0.05, 0.16, (n, K, 2)),
        weights=u(0.3, 1.0, (n, K)), colors=u(-1, 1, (n, K, 3)),
        bg_color=u(-0.4, 0.4, (n, 3)), bg_dir=u(-1, 1, (n, 2)),
        noise=0.05 * rng.standard_normal((n, size, size, 3)).astype(np.float32))


def _check_style(style: str) -> None:
    if style not in ("blobs", "rich"):
        raise ValueError(f"unknown synthetic style {style!r}")


class FakeImages(DataSource):
    """Synthetic class-conditional images on the host: infinite ``{"image":
    [B, S, S, 3] float32 NHWC, "label": [B] int32}`` batches from
    ``np.random.default_rng(seed)``, equal bit for bit to the reference's.
    ``style``: ``blobs`` (maximal label signal) or ``rich`` (a distribution
    a GAN can race on for long runs)."""

    def __init__(self, batch_size: int = 64, image_size: int = 32,
                 num_classes: int = 10, seed: int = 0, style: str = "blobs"):
        _check_style(style)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.style = style

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        render = _rich_images_np if self.style == "rich" else _blob_images
        while True:
            labels = rng.integers(0, self.num_classes, self.batch_size).astype(np.int32)
            yield {"image": render(rng, labels, self.image_size, self.num_classes),
                   "label": labels}


def _seed_stream(gen: torch.Generator, seed: int, pos: int) -> None:
    """Seed ``gen`` from ``(seed, pos)``; the CPU generator keys on the low
    32 bits of its seed, so the pair is mixed into all 64."""
    key = hashlib.blake2b(f"{seed}:{pos}".encode(), digest_size=8)
    gen.manual_seed(int.from_bytes(key.digest(), "little") >> 1)


class DeviceFakeImages:
    """Yields ``{"image": [n_micro, B, S, S, 3] float32 NHWC, "label":
    [n_micro, B] int32}`` on ``device``, forever, in the ``blobs`` or
    ``rich`` style. On a ``mesh`` each rank renders the global batch and
    yields its rows of it, so the ranks' rows make up the one-rank batch bit
    for bit (``render`` is the global batch); with ``spatial_axis`` only its
    height rows of the images over that axis (reference ``fake.py:140-149,
    177``)."""

    yields_stacks = True

    def __init__(self, batch_size: int = 64, image_size: int = 32,
                 num_classes: int = 10, seed: int = 0, n_micro: int = 1,
                 style: str = "blobs", device="cuda", mesh=None,
                 spatial_axis: Optional[str] = None):
        _check_style(style)
        dev = resolve_device(device)
        data_rows(batch_size, mesh)  # the global batch must divide over 'data'
        self.mesh, self.spatial_axis = mesh, spatial_axis
        self.batch_size, self.n_micro, self.num_classes = batch_size, n_micro, num_classes
        self.style = style
        cxy, color, sigma = _class_table(num_classes)
        self._cxy = torch.as_tensor(cxy, device=dev)
        self._color = torch.as_tensor(color, device=dev)
        self._sigma = torch.as_tensor(sigma, device=dev)
        s = image_size
        grid = torch.arange(s, dtype=torch.float32, device=dev) / max(s - 1, 1)
        self._yy, self._xx = grid[:, None], grid[None, :]
        self._s = s
        self._gen = torch.Generator(device=dev)
        self._seed, self._pos = seed, 0
        self.device = dev

    def set_stream_position(self, pos: int) -> None:
        """Make the next batch batch ``pos`` of the stream (the train loop
        primes this with the resumed step)."""
        self._pos = int(pos)

    def render(self):
        """Batch ``self._pos`` of the stream; advances the position."""
        _seed_stream(self._gen, self._seed, self._pos)
        self._pos += 1
        shape = (self.n_micro, self.batch_size)
        g, dev = self._gen, self.device
        lab = torch.randint(0, self.num_classes, shape, generator=g,
                            device=dev) % len(self._sigma)
        if self.style == "rich":
            return {"image": self._rich(lab), "label": lab.to(torch.int32)}
        cx = self._cxy[lab, 0][..., None, None]
        cy = self._cxy[lab, 1][..., None, None]
        sg = self._sigma[lab][..., None, None]
        jit = torch.rand(shape + (2,), generator=g, device=dev) * 0.16 - 0.08
        d1 = (self._xx - cx) ** 2 + (self._yy - cy) ** 2
        d2 = ((self._xx - cx - jit[..., 0, None, None]) ** 2
              + (self._yy - cy - jit[..., 1, None, None]) ** 2)
        inv = -1.0 / (2 * sg ** 2)
        blob = 0.5 * (torch.exp(d1 * inv) + torch.exp(d2 * inv))
        img = blob[..., None] * self._color[lab][..., None, None, :]
        img = img + 0.05 * torch.randn(img.shape, generator=g, device=dev)
        return {"image": img.clamp(-1, 1), "label": lab.to(torch.int32)}

    def _rich(self, lab: torch.Tensor) -> torch.Tensor:
        """The ``rich`` images of classes ``lab``, the parameters drawn in
        the reference's order (``fake.py:212-228``)."""
        g, dev, s, K = self._gen, self.device, self._s, _RICH_BLOBS
        shape = tuple(lab.shape)
        u = lambda lo, hi, sh: torch.rand(shape + sh, generator=g, device=dev) * (hi - lo) + lo
        return _compose_rich(
            torch, self._xx, self._yy, self._color[lab],
            centers=u(0.15, 0.85, (K, 2)), sigmas=u(0.05, 0.16, (K, 2)),
            weights=u(0.3, 1.0, (K,)), colors=u(-1, 1, (K, 3)),
            bg_color=u(-0.4, 0.4, (3,)), bg_dir=u(-1, 1, (2,)),
            noise=0.05 * torch.randn(shape + (s, s, 3), generator=g, device=dev))

    def __iter__(self):
        while True:
            yield shard_batch(self.render(), self.mesh, leading_stack_dims=1,
                              spatial_axis=self.spatial_axis)


class FakePairedImages(DataSource):
    """Synthetic ``{"input", "target"}`` pairs on the host, float32 NHWC
    (the reference's, drawn from ``default_rng(seed)`` the same way, so the
    batches are equal bit for bit): the target is four filled circles on -1,
    the input its edge map (``edge_map``), a procedural edges2shoes.
    ``deterministic_color``: each circle's color is a function of its
    position and radius, so the target can be learned from the input."""

    def __init__(self, batch_size: int = 1, image_size: int = 256, seed: int = 0,
                 deterministic_color: bool = False):
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.deterministic_color = deterministic_color

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / (s - 1)
        while True:
            tgt = np.empty((self.batch_size, s, s, 3), np.float32)
            for i in range(self.batch_size):
                img = np.full((s, s, 3), -1.0, np.float32)
                for _ in range(4):
                    cx, cy, r = rng.uniform(0.2, 0.8, 2).tolist() + [rng.uniform(0.05, 0.2)]
                    mask = ((xx - cx) ** 2 + (yy - cy) ** 2) < r**2
                    if self.deterministic_color:
                        color = np.array([2 * cx - 1, 2 * cy - 1,
                                          (r - 0.05) / 0.15 * 2 - 1], np.float32)
                    else:
                        color = rng.uniform(-1, 1, 3)
                    img[mask] = color
                tgt[i] = img
            yield {"input": edge_map(tgt), "target": tgt}


def edge_map(tgt: np.ndarray) -> np.ndarray:
    """The input of a synthetic pair: per pixel the summed absolute
    differences to the left and upper neighbours of ``[..., S, S, 3]``
    float32 images, clipped to [0, 1], mapped to [-1, 1] and repeated over 3
    channels (reference ``fake.py:292-296``)."""
    gx = np.abs(np.diff(tgt, axis=-2, prepend=tgt[..., :, :1, :])).sum(-1, keepdims=True)
    gy = np.abs(np.diff(tgt, axis=-3, prepend=tgt[..., :1, :, :])).sum(-1, keepdims=True)
    edges = np.clip((gx + gy), 0, 1) * 2 - 1
    return np.repeat(edges, 3, axis=-1).astype(np.float32)


class DeviceFakePairedImages:
    """``FakePairedImages`` rendered on ``device``: ``{"input", "target"}``
    ``[n_micro, B, S, S, 3]`` float32 stacks, forever, with the same
    geometry and color rules (a distribution twin: the random streams
    differ, as the reference's device twin differs from its host one). The
    input is the target's ``edge_map``, summed in numpy's order, so it
    equals the host function of the same target. On a ``mesh`` each rank
    yields its rows of the global batch, as ``DeviceFakeImages`` does."""

    yields_stacks = True

    def __init__(self, batch_size: int = 1, image_size: int = 256, seed: int = 0,
                 n_micro: int = 1, deterministic_color: bool = False, device="cuda",
                 mesh=None):
        dev = resolve_device(device)
        data_rows(batch_size, mesh)  # the global batch must divide over 'data'
        self.mesh = mesh
        self.batch_size, self.n_micro = batch_size, n_micro
        self.deterministic_color = deterministic_color
        s = image_size
        grid = torch.arange(s, dtype=torch.float32, device=dev) / max(s - 1, 1)
        self._yy, self._xx = grid[:, None], grid[None, :]
        self._s = s
        self._gen = torch.Generator(device=dev)
        self._seed, self._pos = seed, 0
        self.device = dev

    def set_stream_position(self, pos: int) -> None:
        """Make the next batch batch ``pos`` of the stream (the train loop
        primes this with the resumed step)."""
        self._pos = int(pos)

    def render(self) -> Dict[str, torch.Tensor]:
        """Batch ``self._pos`` of the stream; advances the position."""
        _seed_stream(self._gen, self._seed, self._pos)
        self._pos += 1
        shape = (self.n_micro, self.batch_size)
        g, dev = self._gen, self.device
        cxy = torch.rand(shape + (4, 2), generator=g, device=dev) * 0.6 + 0.2
        r = torch.rand(shape + (4,), generator=g, device=dev) * 0.15 + 0.05
        if self.deterministic_color:
            color = torch.stack([2 * cxy[..., 0] - 1, 2 * cxy[..., 1] - 1,
                                 (r - 0.05) / 0.15 * 2 - 1], dim=-1)
        else:
            color = torch.rand(shape + (4, 3), generator=g, device=dev) * 2 - 1
        s = self._s
        tgt = torch.full(shape + (s, s, 3), -1.0, device=dev)
        for k in range(4):  # painted in turn: a later circle covers an earlier one
            mask = ((self._xx - cxy[..., k, 0, None, None]) ** 2
                    + (self._yy - cxy[..., k, 1, None, None]) ** 2) < r[..., k, None, None] ** 2
            tgt = torch.where(mask[..., None], color[..., k, None, None, :], tgt)
        dx = torch.diff(tgt, dim=-2, prepend=tgt[..., :, :1, :]).abs()
        dy = torch.diff(tgt, dim=-3, prepend=tgt[..., :1, :, :]).abs()
        edges = (dx[..., 0] + dx[..., 1] + dx[..., 2]) + (dy[..., 0] + dy[..., 1] + dy[..., 2])
        inp = (edges.clamp(0, 1) * 2 - 1)[..., None].expand(*edges.shape, 3)
        return {"input": inp.contiguous(), "target": tgt}

    def __iter__(self):
        while True:
            yield shard_batch(self.render(), self.mesh, leading_stack_dims=1)
