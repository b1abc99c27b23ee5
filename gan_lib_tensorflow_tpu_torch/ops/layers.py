"""Parameterized layers (port of ``gan_lib_tensorflow_tpu/ops/layers.py``),
the ones on the SNGAN, SNGAN-projection and PGGAN paths: ``Dense``,
``Conv``, ``UpsampleConv``, ``DownsampleConv``, ``Embedding`` and the resize
helpers.

Activations are NCHW; conv weights OIHW, Dense weights ``[out, in]`` and
embedding tables ``[features, num_embeddings]``, all float32.
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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers
from .fused import conv_downscale2x, upsample2x_conv
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


class Conv(_Layer):
    """Stride-1 conv with an odd square kernel and TF-SAME padding (which is
    symmetric there; the asymmetric stride-2 case is not ported yet)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 spectral_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 equalized: bool = False, gain: float = math.sqrt(2.0)):
        if kernel_size % 2 != 1:
            raise ValueError(f"Conv takes odd kernel sizes, got {kernel_size}")
        super().__init__((features, in_channels, kernel_size, kernel_size),
                         spectral_norm, compute_dtype, equalized, gain)

    def forward(self, x, sigma=None, update_sn: bool = False):
        w = self.kernel(sigma, update_sn)
        y = F.conv2d(_cast(x, self.compute_dtype), _cast(w, self.compute_dtype),
                     padding=w.shape[-1] // 2)
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


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Box-filter (mean-pool) downsample of an NCHW tensor."""
    return F.avg_pool2d(x, factor)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    """Sum (not mean) over H, W: ``[N, C, H, W] -> [N, C]``."""
    return x.sum(dim=(2, 3))
