"""Weight initializers (port of ``gan_lib_tensorflow_tpu/ops/initializers.py``).

The truncated He normal of the SNGAN path, and PGGAN's equalized learning
rate: a unit-normal init with the He multiplier ``he_scale`` applied at
runtime (Karras et al. 2018, section 4.1). Init matches the JAX package in
distribution, not in bits: the parity tests carry weights across with
``convert.py``. The port's models and CLIs draw every init here, from
torch generators. One place draws the reference's own bits instead: the
TF1 importer's ``--allow-partial`` fills a leaf no checkpoint variable
matches with what the reference tool's ``PRNGKey(0)`` / ``PRNGKey(1)``
init gives it (``tools/flax_init.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# std of a unit normal truncated to [-2, 2]; flax's variance_scaling with
# "truncated_normal" divides by it so the truncated draw keeps the variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def he_normal_(w: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``variance_scaling(2.0, "fan_in", "truncated_normal")``."""
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def unit_normal_(w: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return w.normal_(0.0, 1.0, generator=generator)


def he_scale(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    """Runtime He multiplier of an equalized-LR layer: gain / sqrt(fan_in).
    fan_in is the logical kernel's ``kh * kw * in`` (``weight[0].numel()`` of
    an OIHW or ``[out, in]`` weight)."""
    return float(gain / math.sqrt(fan_in))


@torch.no_grad()
def glorot_uniform_(w: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``glorot_uniform`` of a 2-d table: uniform in +-sqrt(6 / (rows +
    cols)), the same either way round."""
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    return w.uniform_(-limit, limit, generator=generator)
