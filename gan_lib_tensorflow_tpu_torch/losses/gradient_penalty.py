"""WGAN-GP gradient penalty and PGGAN's drift term (port of
``gan_lib_tensorflow_tpu/losses/gradient_penalty.py``).

The inner gradient is ``torch.autograd.grad(..., create_graph=True)``, so
differentiating the penalty again (for the critic's parameters) is a double
backward through the critic. The critic must be pure in its input: no batch
statistics, as PGGAN's D has none.

Under spatial partitioning (``height_sharded``: the images hold the rank's
height rows of an 'sp' line, ``parallel/sharding.py``) the critic's output
is whole on every rank of the line, so the sum of the ranks' inner critic
sums counts it sp times: the inner sum is divided by sp, and its gradient is
then the rank's rows of the whole image's; each sample's squared norm sums
over the line (``sum_over_sp``, differentiable).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.sharding import sp_size, sum_over_sp
from ..utils.profiler import span


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor, u: torch.Tensor,
                     target: float = 1.0, eps: float = 1e-8,
                     height_sharded: bool = False) -> torch.Tensor:
    """E[(||d critic / d x_hat||_2 - target)^2] at x_hat = u real + (1 - u)
    fake. ``u`` ``[N, 1, ...]`` holds the U[0, 1) weights (drawn by the
    caller: the reference draws them from its rng); the norm is taken per
    sample, with ``eps`` under the root. ``height_sharded``: real and fake
    hold the rank's height rows of the enclosing step's 'sp' line. Its span,
    ``d.penalty``, holds the forward and the inner gradient; the second-order
    part runs in the critic update's ``d.backward``."""
    with span("d.penalty"):
        sp = sp_size() if height_sharded else 1
        x_hat = u * real.float() + (1.0 - u) * fake.float()
        if not x_hat.requires_grad:
            x_hat.requires_grad_(True)
        critic_sum = critic_fn(x_hat).float().sum()
        if sp > 1:
            critic_sum = critic_sum / sp
        (grads,) = torch.autograd.grad(critic_sum, x_hat, create_graph=True)
        squares = torch.sum(grads.float() ** 2, dim=tuple(range(1, grads.dim())))
        if sp > 1:
            squares = sum_over_sp(squares)
        norms = torch.sqrt(squares + eps)
        return torch.mean((norms - target) ** 2)


def drift_penalty(real_logits: torch.Tensor) -> torch.Tensor:
    """PGGAN's epsilon-drift term E[D(x)^2] (Karras et al. 2018, A.1)."""
    return torch.mean(real_logits.float() ** 2)
