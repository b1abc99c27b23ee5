"""The one generator of every cell's inputs, from ``--seed`` and the cell's
traffic parameters (``gan_bench/workloads/<cell>.json``, key ``traffic``):

- the seeds of everything a run draws (``Seeds``);
- the store's uint8 images ``[store_images, R, R, 3]`` and int32 labels,
  made on the device in one call each;
- the reference's copy of the store's stream (``StoreStream``): the
  epoch-shuffled, counter-based indices of a ``DeviceCachedStore`` (one
  ``numpy.random.default_rng((seed, epoch)).permutation(n)`` per epoch) and
  the uint8 normalize to float32 in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

U8_SCALE = float(np.float32(1.0 / 127.5))
_STREAMS = ("weights", "images", "labels", "store", "g_noise", "d_noise")


class Seeds:
    """One independent 62-bit seed per stream, a pure function of the run's
    seed (any integer, negative or past 2**63 too)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        for i, name in enumerate(_STREAMS):
            mixed = np.random.SeedSequence([self.seed % 2**64, i]).generate_state(2, np.uint32)
            setattr(self, name, int(mixed[0]) << 30 ^ int(mixed[1]))


def image_size(traffic: dict) -> int:
    return int(traffic.get("resolution", traffic.get("image_size", 0)))


def store_images(traffic: dict, seeds: Seeds, device) -> torch.Tensor:
    """``[n, R, R, 3]`` uint8: each image a ``grid`` x ``grid`` field of
    uniform RGB values bilinearly upsampled to R (smooth structure, and
    images that differ from one another in every statistic a critic sees)."""
    import torch.nn.functional as F

    n, r, grid = traffic["store_images"], image_size(traffic), traffic["grid"]
    gen = torch.Generator(device=device).manual_seed(seeds.images)
    coarse = torch.rand((n, 3, grid, grid), device=device, generator=gen)
    out = torch.empty((n, r, r, 3), dtype=torch.uint8, device=device)
    chunk = max(1, 2**27 // (3 * r * r))  # 512 MB of float32 at a time
    for i in range(0, n, chunk):
        up = F.interpolate(coarse[i:i + chunk], size=(r, r), mode="bilinear",
                           align_corners=False)
        out[i:i + chunk] = up.mul_(255.0).round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def store_labels(traffic: dict, seeds: Seeds, device) -> Optional[torch.Tensor]:
    classes = traffic.get("num_classes", 0)
    if not classes:
        return None
    gen = torch.Generator(device=device).manual_seed(seeds.labels)
    return torch.randint(0, classes, (traffic["store_images"],), dtype=torch.int32,
                         device=device, generator=gen)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 ``x / 127.5 - 1`` rounded once."""
    return (x.double() * U8_SCALE - 1.0).float()


class StoreStream:
    """Step ``k``'s ``{"image": [n_micro, B, R, R, 3], "label": [n_micro,
    B]}`` from the resident ``images``/``labels``, by the store's index
    arithmetic: epoch ``e`` shuffles with ``default_rng((seed, e))``, and a
    step takes the next ``n_micro * B`` indices of its epoch."""

    def __init__(self, images: torch.Tensor, labels: Optional[torch.Tensor], n_micro: int,
                 batch: int, seed: int):
        self.images, self.labels = images, labels
        self.n_micro, self.batch, self.seed = n_micro, batch, seed
        self.take = n_micro * batch
        self.per_epoch = len(images) // self.take

    def indices(self, k: int) -> np.ndarray:
        epoch, off = divmod(k, self.per_epoch)
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.images))
        return order[off * self.take:(off + 1) * self.take].reshape(self.n_micro, self.batch)

    def __call__(self, k: int) -> dict:
        idx = torch.from_numpy(self.indices(k).astype(np.int64)).to(self.images.device)
        out = {"image": normalize(self.images[idx])}
        if self.labels is not None:
            out["label"] = self.labels[idx].long()
        return out
