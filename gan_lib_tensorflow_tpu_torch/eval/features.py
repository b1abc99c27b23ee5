"""``FixedFeatureNet`` (port of ``gan_lib_tensorflow_tpu/eval/features.py``):
a seed-fixed random CNN, test-only, so unit tests can exercise the IS/FID
math cheaply. Not exported from ``eval`` and used by no CLI; its numbers
live on another scale than InceptionV3's and must never mix with them.

Three levels of (3x3 stride-2 conv, ReLU, 3x3 conv, ReLU) at widths 64, 128,
256, a global mean, a Dense to the features and a Dense to the logits. The
stride-2 convs pad as TF's SAME does, which is asymmetric: (0, 1) on an even
input for k 3, s 2 (the reference gets it from XLA's ``'SAME'``).
Parameter names are the reference's flax paths (``conv0``, ``conv0b``, ...,
``feat``, ``logits``), so ``convert.to_torch_names`` carries its weights
across.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops import initializers


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FixedFeatureNet(nn.Module):
    """Images [-1, 1] NHWC -> (features ``[N, feature_dim]``, logits
    ``[N, num_classes]``), float32, under ``no_grad``."""

    def __init__(self, image_size: int = 32, feature_dim: int = 256,
                 num_classes: int = 10, seed: int = 1234, width: int = 64,
                 device="cuda"):
        super().__init__()
        self.feature_dim, self.num_classes = feature_dim, num_classes
        in_ch = 3
        for i, mul in enumerate((1, 2, 4)):
            ch = width * mul
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, ch, 3, stride=2))
            self.add_module(f"conv{i}b", nn.Conv2d(ch, ch, 3, padding=1))
            in_ch = ch
        self.feat = nn.Linear(in_ch, feature_dim)
        self.logits = nn.Linear(feature_dim, num_classes)
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():  # the reference's He-normal kernels, zero biases
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                initializers.he_normal_(m.weight, m.weight[0].numel(), gen)
                nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = images.permute(0, 3, 1, 2)
        for i in range(3):
            ph, pw = same_pad(h.shape[2], 3, 2), same_pad(h.shape[3], 3, 2)
            h = F.relu(getattr(self, f"conv{i}")(F.pad(h, (*pw, *ph))))
            h = F.relu(getattr(self, f"conv{i}b")(h))
        feats = self.feat(h.mean(dim=(2, 3)))
        return feats, self.logits(F.relu(feats))
