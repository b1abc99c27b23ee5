"""Ops of the SNGAN CIFAR path (port of ``gan_lib_tensorflow_tpu/ops``)."""

from .blocks import DiscOptimizedBlock, DiscResBlock, GenResBlock
from .layers import (Conv, Dense, DownsampleConv, UpsampleConv, downsample_avg,
                     global_sum_pool, upsample_nearest)
from .norms import BatchNorm
from .power_iteration import batched_power_iteration

__all__ = [
    "BatchNorm", "Conv", "Dense", "DiscOptimizedBlock", "DiscResBlock",
    "DownsampleConv", "GenResBlock", "UpsampleConv", "batched_power_iteration",
    "downsample_avg", "global_sum_pool", "upsample_nearest",
]
