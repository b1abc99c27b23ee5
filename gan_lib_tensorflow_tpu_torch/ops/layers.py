"""Parameterized layers (port of ``gan_lib_tensorflow_tpu/ops/layers.py``),
the ones on the SNGAN, SNGAN-projection, PGGAN and ACGAN paths: ``Dense``,
``Conv``, ``ConvTranspose``, ``UpsampleConv``, ``DownsampleConv``,
``Embedding``, ``dropout`` and the resize helpers.

Activations are NCHW; conv and transposed-conv weights OIHW (O = the
layer's output features), Dense weights ``[out, in]`` and embedding tables
``[features, num_embeddings]``, all float32.
``compute_dtype`` casts the activation and the (spectrally
normalized) weight at the conv/matmul boundary, as the reference does.

Spectral norm: a layer with ``spectral_norm=True`` owns a ``u`` buffer
(``[1, out]``, the reference's ``'sn'`` variable) and divides its weight by a
sigma. The owning discriminator computes all its sigmas in one batched kernel
launch and passes each layer its own; a layer called on its own computes its
sigma with a one-weight launch.

Equalized learning rate (``equalized=True``, PGGAN): the weight is drawn from
a unit normal and multiplied at runtime by ``he_scale(fan_in, gain)``, before
any spectral norm, resize fuse or cast (reference ``layers.py:72-73``).
fan_in is that of the stored kxk kernel, also for the resize convs, whose
fused (k+1)x(k+1) kernels are derived from it.

Spatial partitioning (PGGAN's 'sp' axis): inside
``parallel.sharding.height_shards()`` the activation holds the rank's
height rows, and a SAME conv takes its padding rows from the 'sp'
neighbours (``halo_pad``): the stride-1 ``Conv`` one row per side for 3x3,
the fused ``UpsampleConv`` and ``DownsampleConv`` one input row per side
(``ops/fused.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers
from ..parallel.sharding import halo_pad, height_sharded
from .fused import conv_downscale2x, conv_transpose_same, upsample2x_conv
from .power_iteration import batched_power_iteration


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class _Layer(nn.Module):
    """Weight + bias + optional spectral norm or equalized learning rate."""

    def __init__(self, weight_shape, spectral_norm: bool,
                 compute_dtype: Optional[torch.dtype], equalized: bool = False,
                 gain: float = math.sqrt(2.0)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0]))
        self.spectral_norm = spectral_norm
        if spectral_norm:
            self.register_buffer("u", torch.empty(1, weight_shape[0]))
        self.compute_dtype = compute_dtype
        self.equalized = equalized
        self.scale = initializers.he_scale(self.weight[0].numel(), gain)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.equalized:
            initializers.unit_normal_(self.weight, generator)
        else:
            initializers.he_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)
        if self.spectral_norm:
            initializers.unit_normal_(self.u, generator)

    def kernel(self, sigma: Optional[torch.Tensor] = None,
               update_sn: bool = False) -> torch.Tensor:
        """The float32 weight, times its He scale under equalized LR and
        divided by its sigma under spectral norm."""
        w = self.weight * self.scale if self.equalized else self.weight
        if not self.spectral_norm:
            return w
        if sigma is None:
            sigma = batched_power_iteration([self.weight], [self.u], update_sn)[0]
        return w / sigma

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        b = _cast(self.bias, self.compute_dtype)
        return y + (b if y.dim() == 2 else b.view(1, -1, 1, 1))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every layer's weights (and SN ``u``) from ``generator``, each
    by its own rule (He normal, unit normal under equalized LR, Glorot
    uniform or a constant for an embedding)."""
    for m in module.modules():
        if isinstance(m, (_Layer, Embedding)):
            m.reset_parameters(generator)


class Dense(_Layer):
    def __init__(self, in_features: int, features: int,
                 spectral_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 equalized: bool = False, gain: float = math.sqrt(2.0)):
        super().__init__((features, in_features), spectral_norm, compute_dtype,
                         equalized, gain)

    def forward(self, x, sigma=None, update_sn: bool = False):
        w = self.kernel(sigma, update_sn)
        y = _cast(x, self.compute_dtype) @ _cast(w, self.compute_dtype).T
        return self.add_bias(y)


def same_pads(size: int, kernel: int, stride: int):
    """XLA's (and TF's) ``'SAME'`` padding of one spatial dim: the output
    has ``ceil(size / stride)`` positions, and the total padding that needs
    is split with the odd pixel after (stride 2, kernel 3 on 32 pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(_Layer):
    """2-D conv with a square kernel of any size, ``stride`` and
    ``padding``: ``"SAME"`` (XLA's rule, asymmetric where the total is odd),
    ``"VALID"``, or explicit ``((top, bottom), (left, right))``. A
    symmetric padding goes to ``conv2d`` itself; an asymmetric one is
    applied with ``F.pad`` first."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 spectral_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 equalized: bool = False, gain: float = math.sqrt(2.0),
                 stride: int = 1, padding="SAME"):
        if isinstance(padding, str) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME, VALID or pairs, got {padding!r}")
        super().__init__((features, in_channels, kernel_size, kernel_size),
                         spectral_norm, compute_dtype, equalized, gain)
        self.stride, self.padding = stride, padding

    def pads(self, h: int, w: int):
        """((top, bottom), (left, right)) for an ``h`` x ``w`` input."""
        if self.padding == "SAME":
            k = self.weight.shape[-1]
            return same_pads(h, k, self.stride), same_pads(w, k, self.stride)
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x, sigma=None, update_sn: bool = False):
        w = self.kernel(sigma, update_sn)
        (top, bottom), (left, right) = self.pads(x.shape[-2], x.shape[-1])
        if top and height_sharded():
            if self.stride != 1 or top != bottom:
                raise NotImplementedError("a height shard takes only stride-1 "
                                          "symmetric SAME convolutions")
            x, top = halo_pad(x, top)
            bottom = top
        x = _cast(x, self.compute_dtype)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, _cast(w, self.compute_dtype), stride=self.stride, padding=pad)
        return self.add_bias(y)


class ConvTranspose(_Layer):
    """2-D transposed conv with XLA's ``'SAME'`` padding (reference
    ``layers.py:138-185``: ``lax.conv_transpose``, no kernel flip): the
    output is ``stride`` times the input. The weight is stored OIHW like
    ``Conv``'s (the reference's HWIO kernel by the converter's one rule);
    ``ops/fused.py:conv_transpose_same`` does the padding."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5,
                 stride: int = 2, compute_dtype: Optional[torch.dtype] = None):
        super().__init__((features, in_channels, kernel_size, kernel_size),
                         False, compute_dtype)
        self.stride = stride

    def forward(self, x):
        y = conv_transpose_same(x, self.kernel(), self.stride, self.compute_dtype)
        return self.add_bias(y)


class UpsampleConv(_Layer):
    """Nearest-2x-upsample then conv, computed fused (``ops/fused.py``);
    ``fused=False`` upsamples explicitly. Same parameters either way."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 fused: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 equalized: bool = False, gain: float = math.sqrt(2.0)):
        super().__init__((features, in_channels, kernel_size, kernel_size),
                         False, compute_dtype, equalized, gain)
        self.fused = fused

    def forward(self, x):
        w = self.kernel()
        if self.fused:
            y = upsample2x_conv(x, w, self.compute_dtype)
        else:
            y = F.conv2d(_cast(upsample_nearest(x), self.compute_dtype),
                         _cast(w, self.compute_dtype), padding=w.shape[-1] // 2)
        return self.add_bias(y)


class DownsampleConv(_Layer):
    """Conv then box-downsample-2x, computed fused (``ops/fused.py``).
    Spectral norm divides the raw kxk kernel by its sigma before the smear;
    the bias is added after the pool (reference ``layers.py:242-248``).
    Without spectral norm it is PGGAN's equalized ``fused_scale`` conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 spectral_norm: bool = False, fused: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 equalized: bool = False, gain: float = math.sqrt(2.0)):
        super().__init__((features, in_channels, kernel_size, kernel_size),
                         spectral_norm, compute_dtype, equalized, gain)
        self.fused = fused

    def forward(self, x, sigma=None, update_sn: bool = False):
        w = self.kernel(sigma, update_sn)
        if self.fused:
            y = conv_downscale2x(x, w, self.compute_dtype)
        else:
            y = downsample_avg(F.conv2d(
                _cast(x, self.compute_dtype), _cast(w, self.compute_dtype),
                padding=w.shape[-1] // 2))
        return self.add_bias(y)


class Embedding(nn.Module):
    """Label embedding, optionally spectral-normalized (reference
    ``layers.py:294-313``; the projection discriminator's ``proj_embed``).

    The table is stored ``[features, num_embeddings]``, the transpose of the
    reference's ``[num_embeddings, features]``, like every weight here
    ``[out, fan_in]``: the reference normalizes ``table.reshape(-1,
    features)``, so ``features`` is the output side and ``u`` holds
    ``features`` values, and the power-iteration kernel reads the table in
    place. A lookup takes columns. ``init`` is ``"glorot"`` (the reference's
    default), ``"ones"`` or ``"zeros"`` (conditional BN's gamma and beta)."""

    def __init__(self, num_embeddings: int, features: int,
                 spectral_norm: bool = False, init: str = "glorot"):
        super().__init__()
        if init not in ("glorot", "ones", "zeros"):
            raise ValueError(f"init must be glorot|ones|zeros, got {init!r}")
        self.weight = nn.Parameter(torch.empty(features, num_embeddings))
        self.spectral_norm = spectral_norm
        if spectral_norm:
            self.register_buffer("u", torch.empty(1, features))
        self.init = init
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.init == "glorot":
            initializers.glorot_uniform_(self.weight, generator)
        else:
            nn.init.constant_(self.weight, 1.0 if self.init == "ones" else 0.0)
        if self.spectral_norm:
            initializers.unit_normal_(self.u, generator)

    def forward(self, labels: torch.Tensor, sigma=None,
                update_sn: bool = False) -> torch.Tensor:
        """labels ``[N]`` (integer) -> ``[N, features]`` float32 (no caller
        casts a table: the reference's tables compute in float32)."""
        w = self.weight
        if self.spectral_norm:
            if sigma is None:
                sigma = batched_power_iteration([w], [self.u], update_sn)[0]
            w = w / sigma
        return w.t()[labels.long()]


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: ``where(mask, x / keep, 0)`` with
    ``keep = 1 - rate`` rounded to ``x``'s dtype first, as JAX rounds the
    Python scalar (bf16: 0.69921875). ``mask`` is the bool keep mask, shaped
    and laid out like ``x``."""
    keep = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(mask, x / keep, 0.0)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Box-filter (mean-pool) downsample of an NCHW tensor."""
    return F.avg_pool2d(x, factor)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    """Sum (not mean) over H, W: ``[N, C, H, W] -> [N, C]``."""
    return x.sum(dim=(2, 3))
