"""Paired-image folder loader for pix2pix (port of
``gan_lib_tensorflow_tpu/data/paired.py``): a folder of combined A|B images
(facades style), decoded with ``data/codec.py``.

Each file splits at ``w // 2`` into its halves (swapped by ``BtoA``), each
resized to ``scale_size`` with Pillow's bilinear resample. Training batches
take the reference's jitter: per example one random crop to ``image_size``
and one horizontal flip shared by both halves, drawn from
``default_rng(seed)`` in its order (a permutation per epoch, then per
example ``integers(0, s - c + 1, 2)`` and, with ``flip``, ``random() <
0.5``), cropped, flipped and normalized by ``data/packed.py``'s
``crop_pairs`` (bit-equal to the reference's native
``crop_flip_normalize``). ``eval_iter`` resizes each half to ``image_size``
and normalizes as the reference does there (``codec.to_float_div``). Every
batch equals the reference's bit for bit.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator

import numpy as np
import torch

from . import codec
from .base import DataSource
from .imagenet import check_count
from .packed import crop_pairs


class PairedImageFolder(DataSource):
    def __init__(self, path: str, batch_size: int = 1, image_size: int = 256,
                 scale_size: int = 286, which_direction: str = "AtoB",
                 flip: bool = True, seed: int = 0):
        self.files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                            + glob.glob(os.path.join(path, "*.png")))
        if not self.files:
            raise FileNotFoundError(f"no images in {path}")
        check_count(len(self.files), batch_size, path)
        self.batch_size = batch_size
        self.image_size = image_size
        self.scale_size = scale_size
        self.which_direction = which_direction
        self.flip = flip
        self.seed = seed

    def _halves(self, path: str, size: int):
        """(input, target) uint8 ``[size, size, 3]`` of one combined image."""
        a, b = codec.load_halves(path, size)
        return (b, a) if self.which_direction == "BtoA" else (a, b)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        s, c = self.scale_size, self.image_size
        while True:
            order = rng.permutation(len(self.files))
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                rows, oy, ox, flip = [], [], [], []
                for j in order[i:i + self.batch_size]:
                    rows.append(np.concatenate(self._halves(self.files[j], s), axis=1))
                    y, x = (int(v) for v in rng.integers(0, s - c + 1, 2))
                    oy.append(y)
                    ox.append(x)
                    flip.append(bool(self.flip and rng.random() < 0.5))
                inp, tgt = crop_pairs(torch.from_numpy(np.stack(rows)),
                                      torch.arange(len(rows)), torch.as_tensor(oy),
                                      torch.as_tensor(ox), torch.as_tensor(flip),
                                      c, 0, s)
                yield {"input": inp.numpy(), "target": tgt.numpy()}

    def eval_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        """The test-mode pass: each file once in sorted order, both halves
        resized to ``image_size``, no crop or flip, with its ``name``."""
        for f in self.files:
            a, b = self._halves(f, self.image_size)
            yield {"input": codec.to_float_div(a)[None], "target": codec.to_float_div(b)[None],
                   "name": os.path.basename(f)}
