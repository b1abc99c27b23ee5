"""WGAN-GP gradient penalty and PGGAN's drift term (port of
``gan_lib_tensorflow_tpu/losses/gradient_penalty.py``).

The inner gradient is ``torch.autograd.grad(..., create_graph=True)``, so
differentiating the penalty again (for the critic's parameters) is a double
backward through the critic. The critic must be pure in its input: no batch
statistics, as PGGAN's D has none.
"""

from __future__ import annotations

from typing import Callable

import torch


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor, u: torch.Tensor,
                     target: float = 1.0, eps: float = 1e-8) -> torch.Tensor:
    """E[(||d critic / d x_hat||_2 - target)^2] at x_hat = u real + (1 - u)
    fake. ``u`` ``[N, 1, ...]`` holds the U[0, 1) weights (drawn by the
    caller: the reference draws them from its rng); the norm is taken per
    sample, with ``eps`` under the root."""
    x_hat = u * real.float() + (1.0 - u) * fake.float()
    if not x_hat.requires_grad:
        x_hat.requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(x_hat).float().sum(), x_hat,
                                   create_graph=True)
    norms = torch.sqrt(torch.sum(grads.float() ** 2,
                                 dim=tuple(range(1, grads.dim()))) + eps)
    return torch.mean((norms - target) ** 2)


def drift_penalty(real_logits: torch.Tensor) -> torch.Tensor:
    """PGGAN's epsilon-drift term E[D(x)^2] (Karras et al. 2018, A.1)."""
    return torch.mean(real_logits.float() ** 2)
