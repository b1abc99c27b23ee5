"""Residual blocks of the SNGAN ResNet (port of
``gan_lib_tensorflow_tpu/ops/blocks.py``). NCHW inside. A generator block
with ``num_classes`` > 0 uses conditional BN on the class labels.

Discriminator blocks take ``sigmas``, a mapping from each spectral-norm layer
to its sigma, computed by the discriminator in one batched launch; with
``sigmas=None`` each layer computes its own.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, DownsampleConv, UpsampleConv, downsample_avg
from .norms import BatchNorm, ConditionalBatchNorm


def _sn(layer: nn.Module, x, sigmas: Optional[Mapping], update_sn: bool):
    return layer(x, sigma=None if sigmas is None else sigmas[layer],
                 update_sn=update_sn)


class GenResBlock(nn.Module):
    """BN -> ReLU -> up-conv 3x3 -> BN -> ReLU -> conv 3x3, plus a learned
    1x1 up-conv skip (reference ``blocks.py:30-77``, upsampling blocks only:
    the only kind the CIFAR and ImageNet-128 generators have). With
    ``num_classes`` > 0 both BNs are conditional on ``labels``."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None, num_classes: int = 0):
        super().__init__()
        cd = compute_dtype

        def bn(ch):
            return (ConditionalBatchNorm(num_classes, ch, compute_dtype=cd)
                    if num_classes > 0 else BatchNorm(ch, compute_dtype=cd))

        self.conditional = num_classes > 0
        self.bn1 = bn(in_channels)
        self.conv1 = UpsampleConv(in_channels, features, 3, compute_dtype=cd)
        self.bn2 = bn(features)
        self.conv2 = Conv(features, features, 3, compute_dtype=cd)
        self.conv_skip = UpsampleConv(in_channels, features, 1, compute_dtype=cd)

    def forward(self, x, labels=None, train: bool = True, groups: int = 1,
                update_stats: bool = True):
        bn = dict(use_running_average=not train, groups=groups,
                  update_stats=update_stats)
        cond = (labels,) if self.conditional else ()
        h = self.bn1(x, *cond, relu=True, **bn)
        h = self.conv1(h)
        h = self.bn2(h, *cond, relu=True, **bn)
        h = self.conv2(h)
        return h + self.conv_skip(x)


class DiscResBlock(nn.Module):
    """ReLU -> SN conv 3x3 -> ReLU -> SN conv 3x3 (-> avg-pool 2x), skip =
    SN 1x1 conv (+ avg-pool) when the shape changes. ``fused=True`` computes
    conv2-then-pool as one stride-2 conv and pools the skip before its 1x1
    conv (exact; reference ``blocks.py:80-132``)."""

    def __init__(self, in_channels: int, features: int, downsample: bool = False,
                 fused: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.downsample = downsample
        self.fused = fused and downsample
        self.conv1 = Conv(in_channels, features, 3, spectral_norm=True,
                          compute_dtype=cd)
        if self.fused:
            self.conv2 = DownsampleConv(features, features, 3, spectral_norm=True,
                                        compute_dtype=cd)
        else:
            self.conv2 = Conv(features, features, 3, spectral_norm=True,
                              compute_dtype=cd)
        self.conv_skip = None
        if downsample or in_channels != features:
            self.conv_skip = Conv(in_channels, features, 1, spectral_norm=True,
                                  compute_dtype=cd)

    def forward(self, x, sigmas: Optional[Mapping] = None, update_sn: bool = False):
        h = _sn(self.conv1, F.relu(x), sigmas, update_sn)
        h = _sn(self.conv2, F.relu(h), sigmas, update_sn)
        if self.downsample and not self.fused:
            h = downsample_avg(h)
        s = x
        if self.fused:  # fused => downsample => conv_skip
            s = _sn(self.conv_skip, downsample_avg(s), sigmas, update_sn)
        else:
            if self.conv_skip is not None:
                s = _sn(self.conv_skip, s, sigmas, update_sn)
            if self.downsample:
                s = downsample_avg(s)
        return h + s


class DiscOptimizedBlock(nn.Module):
    """The input block: SN conv 3x3 -> ReLU -> SN conv 3x3 -> avg-pool, skip
    = avg-pool -> SN 1x1 conv (reference ``blocks.py:135-163``)."""

    def __init__(self, in_channels: int, features: int, fused: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.fused = fused
        self.conv1 = Conv(in_channels, features, 3, spectral_norm=True,
                          compute_dtype=cd)
        if fused:
            self.conv2 = DownsampleConv(features, features, 3, spectral_norm=True,
                                        compute_dtype=cd)
        else:
            self.conv2 = Conv(features, features, 3, spectral_norm=True,
                              compute_dtype=cd)
        self.conv_skip = Conv(in_channels, features, 1, spectral_norm=True,
                              compute_dtype=cd)

    def forward(self, x, sigmas: Optional[Mapping] = None, update_sn: bool = False):
        h = F.relu(_sn(self.conv1, x, sigmas, update_sn))
        h = _sn(self.conv2, h, sigmas, update_sn)
        if not self.fused:
            h = downsample_avg(h)
        s = _sn(self.conv_skip, downsample_avg(x), sigmas, update_sn)
        return h + s
