"""BatchNorm (port of ``gan_lib_tensorflow_tpu/ops/norms.py:BatchNorm``).

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
