"""Ops of the SNGAN CIFAR and PGGAN paths (port of ``gan_lib_tensorflow_tpu/ops``)."""

from .blocks import DiscOptimizedBlock, DiscResBlock, GenResBlock
from .fadein import fadein_blend
from .layers import (Conv, Dense, DownsampleConv, UpsampleConv, downsample_avg,
                     global_sum_pool, init_weights, upsample_nearest)
from .norms import BatchNorm, minibatch_stddev, pixel_norm
from .power_iteration import batched_power_iteration

__all__ = [
    "BatchNorm", "Conv", "Dense", "DiscOptimizedBlock", "DiscResBlock",
    "DownsampleConv", "GenResBlock", "UpsampleConv", "batched_power_iteration",
    "downsample_avg", "fadein_blend", "global_sum_pool", "init_weights",
    "minibatch_stddev", "pixel_norm", "upsample_nearest",
]
