"""Normalizations (port of ``gan_lib_tensorflow_tpu/ops/norms.py``): the
SNGAN path's ``BatchNorm``, and PGGAN's ``pixel_norm`` and
``minibatch_stddev`` (stateless functions).

Not torch's ``BatchNorm2d``: ``momentum`` is the fraction of the running
stats kept (0.9), the variance is the biased ``max(E[x^2] - E[x]^2, 0)``,
every statistic is float32, and the output is cast to ``compute_dtype``.

``groups`` splits the batch into equal microbatches with their own batch
statistics: the reference's vmap over the n_critic fake microbatches
(``models/sngan.py:160-181``), run as one batched forward here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


MOMENTUM = 0.9   # fraction of the running stats kept per update
EPSILON = 1e-5


class BatchNorm(nn.Module):
    def __init__(self, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))   # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: bool = False,
                groups: int = 1, update_stats: bool = True) -> torch.Tensor:
        """x: NCHW (or ``[N, C]``). Running stats advance only in training
        mode with ``update_stats`` and one group."""
        out_dtype = x.dtype if self.compute_dtype is None else self.compute_dtype
        xf = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if use_running_average:
            mean = self.running_mean.view(shape)
            var = self.running_var.view(shape)
        else:
            xg = xf.reshape(groups, x.shape[0] // groups, *x.shape[1:])
            dims = (1,) + tuple(range(3, xg.dim()))
            gshape = (groups, 1, -1) + (1,) * (x.dim() - 2)
            mean = xg.mean(dim=dims).view(gshape)
            mean2 = (xg * xg).mean(dim=dims).view(gshape)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                if groups != 1:
                    raise ValueError("running stats advance only for one group")
                with torch.no_grad():
                    m = MOMENTUM
                    self.running_mean.mul_(m).add_(mean.view(-1), alpha=1 - m)
                    self.running_var.mul_(m).add_(var.view(-1), alpha=1 - m)
            xf = xg
        y = (xf - mean) * torch.rsqrt(var + EPSILON)
        y = y.reshape(x.shape) * self.weight.view(shape) + self.bias.view(shape)
        return y.to(out_dtype)


def pixel_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """PGGAN PixelNorm: each pixel's feature vector to unit RMS, in float32,
    cast back. Normalizes dim 1: the channels of NCHW, the features of
    ``[N, F]`` (reference ``norms.py:155-161`` normalizes NHWC's last axis)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + epsilon)
    return y.to(x.dtype)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     epsilon: float = 1e-8) -> torch.Tensor:
    """PGGAN minibatch stddev (reference ``norms.py:164-182``): the batch
    splits as ``reshape(g, n // g, ...)``, so sample i is in group i % (n//g);
    per group the float32 stddev over its g members, averaged over C, H, W,
    is appended as one constant channel, last. x: NCHW."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"batch {n} not divisible by group size {g}")
    xf = x.float().reshape(g, n // g, c, h, w)
    mean = xf.mean(dim=0, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=0)
    avg = torch.sqrt(var + epsilon).mean(dim=(1, 2, 3), keepdim=True)  # [n//g, 1, 1, 1]
    feat = avg[None].expand(g, n // g, 1, h, w).reshape(n, 1, h, w)
    return torch.cat([x, feat.to(x.dtype)], dim=1)
