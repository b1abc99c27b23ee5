"""On-device synthetic images (port of ``DeviceFakeImages``, ``blobs`` style
only, from ``gan_lib_tensorflow_tpu/data/fake.py:154-253``).

Each batch is rendered on the device from a ``torch.Generator``: one
class-pinned gaussian blob (plus a jittered copy) per image, low noise,
clipped to [-1, 1]. The class table is the reference's, so class k looks the
same in both packages; the random streams differ (distribution twins).

The stream is counter-based, as the reference's is (``fold_in(key, k)``):
batch k depends only on ``(seed, k)``, because the generator is re-seeded
from both before each render (on the host, no device sync). The position
lives on the instance, and ``set_stream_position`` sets it, so a resumed run
sees the batches an uninterrupted run sees.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import resolve_device

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


class DeviceFakeImages:
    """Yields ``{"image": [n_micro, B, S, S, 3] float32 NHWC, "label":
    [n_micro, B] int32}`` on ``device``, forever."""

    yields_stacks = True

    def __init__(self, batch_size: int = 64, image_size: int = 32,
                 num_classes: int = 10, seed: int = 0, n_micro: int = 1,
                 device="cuda"):
        dev = resolve_device(device)
        self.batch_size, self.n_micro, self.num_classes = batch_size, n_micro, num_classes
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
        # the CPU generator keys on the low 32 bits of its seed, so mix
        # (seed, position) into all 64
        key = hashlib.blake2b(f"{self._seed}:{self._pos}".encode(), digest_size=8)
        self._gen.manual_seed(int.from_bytes(key.digest(), "little") >> 1)
        self._pos += 1
        shape = (self.n_micro, self.batch_size)
        g, dev = self._gen, self.device
        lab = torch.randint(0, self.num_classes, shape, generator=g,
                            device=dev) % len(self._sigma)
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

    def __iter__(self):
        while True:
            yield self.render()
