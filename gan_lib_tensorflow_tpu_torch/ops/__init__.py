"""Ops of the SNGAN, SNGAN-projection, PGGAN and ACGAN paths (port of
``gan_lib_tensorflow_tpu/ops``)."""

from .blocks import DiscOptimizedBlock, DiscResBlock, GenResBlock
from .fadein import fadein_blend
from .layers import (Conv, ConvTranspose, Dense, DownsampleConv, Embedding, UpsampleConv,
                     downsample_avg, dropout, global_sum_pool, init_weights,
                     upsample_nearest)
from .norms import BatchNorm, ConditionalBatchNorm, minibatch_stddev, pixel_norm
from .power_iteration import batched_power_iteration

__all__ = [
    "BatchNorm", "ConditionalBatchNorm", "Conv", "ConvTranspose", "Dense",
    "DiscOptimizedBlock", "DiscResBlock", "DownsampleConv", "Embedding", "GenResBlock",
    "UpsampleConv", "batched_power_iteration",
    "downsample_avg", "dropout", "fadein_blend", "global_sum_pool", "init_weights",
    "minibatch_stddev", "pixel_norm", "upsample_nearest",
]
