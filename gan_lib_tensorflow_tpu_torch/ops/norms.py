"""Normalizations (port of ``gan_lib_tensorflow_tpu/ops/norms.py``): the
SNGAN path's ``BatchNorm``, SNGAN-projection's ``ConditionalBatchNorm``, and
PGGAN's ``pixel_norm`` and ``minibatch_stddev`` (stateless functions).

Not torch's ``BatchNorm2d``: ``momentum`` is the fraction of the running
stats kept (0.9), the variance is the biased ``max(E[x^2] - E[x]^2, 0)``,
every statistic is float32, and the output is cast to ``compute_dtype``.

``groups`` splits the batch into equal microbatches with their own batch
statistics: the reference's vmap over the n_critic fake microbatches
(``models/sngan.py:160-181``), run as one batched forward here.

Inside a ``parallel.sharded_step`` the batch statistics are the global
batch's, as the reference's are under GSPMD: batch norm all-reduces its
``[sum x, sum x^2]`` over the 'data' ranks, and minibatch stddev its
group sums, both differentiably, so the gradients carry the terms that
cross ranks and the running statistics stay equal on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import active
from ..parallel.sharding import global_batch, sum_over_data
from .layers import Embedding


MOMENTUM = 0.9   # fraction of the running stats kept per update
EPSILON = 1e-5


class BatchNorm(nn.Module):
    """``affine=False`` drops the scale and bias (the reference's
    ``use_scale=False, use_bias=False``, as conditional BN uses it)."""

    def __init__(self, features: int,
                 compute_dtype: Optional[torch.dtype] = None, affine: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.affine = affine
        if affine:
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
            # the global batch's moments: one all-reduce of both sums
            count = global_batch(xg[0].numel() // xg.shape[2])
            sums = sum_over_data(torch.stack([xg.sum(dim=dims), (xg * xg).sum(dim=dims)]))
            mean, mean2 = (sums / count).view(2, *gshape).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                if groups != 1:
                    raise ValueError("running stats advance only for one group")
                with torch.no_grad():
                    m = MOMENTUM
                    self.running_mean.mul_(m).add_(mean.view(-1), alpha=1 - m)
                    self.running_var.mul_(m).add_(var.view(-1), alpha=1 - m)
            xf = xg
        y = ((xf - mean) * torch.rsqrt(var + EPSILON)).reshape(x.shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(out_dtype)


class ConditionalBatchNorm(nn.Module):
    """BN whose gamma and beta are per-class embeddings picked by label
    (reference ``norms.py:83-125``): BN without scale or bias in float32
    (``bn``, which owns the running stats), then ``gamma[label]`` (init 1)
    and ``beta[label]`` (init 0) per sample and channel, then the cast to
    ``compute_dtype``. ``groups`` and ``update_stats`` are ``BatchNorm``'s."""

    def __init__(self, num_classes: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.bn = BatchNorm(features, compute_dtype=torch.float32, affine=False)
        self.gamma = Embedding(num_classes, features, init="ones")
        self.beta = Embedding(num_classes, features, init="zeros")

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                use_running_average: bool = False, groups: int = 1,
                update_stats: bool = True) -> torch.Tensor:
        """x NCHW (or ``[N, C]``), labels ``[N]``."""
        normed = self.bn(x, use_running_average, groups, update_stats)
        shape = (x.shape[0], -1) + (1,) * (x.dim() - 2)
        y = normed * self.gamma(labels).view(shape) + self.beta(labels).view(shape)
        return y.to(x.dtype if self.compute_dtype is None else self.compute_dtype)


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
    is appended as one constant channel, last. x: NCHW.

    In a sharded step n is the global batch, and a group's members lie on
    several ranks: each rank adds its contiguous rows into the ``[n//g,
    ...]`` group slots, the slot sums are all-reduced, and the centred
    squares take a second pass, as the reference computes the mean first
    and the squares after. Outside one the rank holds every row, and the
    slot sums are the group sums. Its mean over C, H, W needs the whole
    height: under spatial partitioning PGGAN's D gathers the height before
    it (``models/pggan.py``), so ``x`` is never an 'sp' shard."""
    n_loc, c, h, w = x.shape
    n = global_batch(n_loc)
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"batch {n} not divisible by group size {g}")
    m = n // g
    # this rank's rows fill slots first, first + 1, ... (mod m) in turn: pad
    # them to whole rounds of m and add the rounds; a fixed order everywhere
    mesh = active()
    first = 0 if mesh is None else mesh.coord("data") * n_loc % m
    rounds = -(-(first + n_loc) // m)

    def slot_sums(t: torch.Tensor) -> torch.Tensor:
        padded = F.pad(t, (0, 0, 0, 0, 0, 0, first, rounds * m - first - n_loc))
        return sum_over_data(padded.reshape(rounds, m, *t.shape[1:]).sum(dim=0))

    def per_row(t: torch.Tensor) -> torch.Tensor:  # slot values back to the rows
        return t.repeat(rounds, 1, 1, 1)[first:first + n_loc]

    xf = x.float()
    mean = slot_sums(xf) / g
    var = slot_sums((xf - per_row(mean)) ** 2) / g
    avg = torch.sqrt(var + epsilon).mean(dim=(1, 2, 3), keepdim=True)  # [m, 1, 1, 1]
    feat = per_row(avg).expand(n_loc, 1, h, w)
    return torch.cat([x, feat.to(x.dtype)], dim=1)
