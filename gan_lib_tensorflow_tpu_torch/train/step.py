"""The fused n_critic x D + G train step (port of
``gan_lib_tensorflow_tpu/train/step.py:59-130``).

One call runs: all n_critic fake microbatches (one G forward under
``no_grad``), the n_critic critic updates, the G update against D as it stands
after the critic loop, then the EMA of G's parameters. Unlike the reference's
pure function, the step updates the state in place (parameters, Adam slots,
``u`` buffers, BN running stats), which saves a copy of every tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class GANSpec:
    """What the step needs to know about a model family. ``alpha`` is the
    state's fade-in weight (a float; only PGGAN reads it), as the
    reference's loss signature carries it (``step.py:27-30``). With
    ``num_classes`` > 0 the family is class-conditional: ``labels`` below are
    integer class tensors; otherwise they are None.

    prepare_fakes(z_stack [n_critic, B, z_dim], alpha, labels [n_critic, B])
        -> fakes [n_critic, B, ...]
    d_loss(real, fake, alpha, noise, u_gp, labels) -> (loss, metrics):
        ``noise`` is the generator of the critic's own draws (the
        reference's per-substep rng), ``u_gp`` the gradient penalty's
        interpolation weights ``[B, 1, 1, 1]`` when the caller hands them
        in, else None; ``labels`` is ``(real_labels, fake_labels)``
    g_loss(z, alpha, labels [B]) -> loss
    """

    prepare_fakes: Callable
    d_loss: Callable
    g_loss: Callable
    n_critic: int = 1
    ema_decay: float = 0.0
    z_dim: int = 128
    num_classes: int = 0


def make_train_step(spec: GANSpec):
    """``train_step(state, batch, z_critic=None, z_g=None, u_gp=None,
    labels_critic=None, labels_g=None) -> metrics``.

    ``batch["image"]`` is ``[n_critic, B, S, S, 3]``; a conditional family
    also reads ``batch["label"]`` ``[n_critic, B]``. Draws come from the
    state's generators unless given (the parity tests feed JAX's draws):
    ``z_critic`` ``[n_critic, B, z_dim]`` then ``labels_critic`` ``[n_critic,
    B]`` (the critic fakes' classes) from ``d_noise``, ``z_g`` ``[B, z_dim]``
    then ``labels_g`` ``[B]`` from ``g_noise``, ``u_gp`` ``[n_critic, B, 1, 1,
    1]``. Metrics are device tensors; reading them waits for the step."""

    def _apply(params, grads, opt, sched) -> None:
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        if sched is not None:
            sched.step()

    def train_step(state, batch, z_critic: Optional[torch.Tensor] = None,
                   z_g: Optional[torch.Tensor] = None,
                   u_gp: Optional[torch.Tensor] = None,
                   labels_critic: Optional[torch.Tensor] = None,
                   labels_g: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        images = batch["image"]
        if images.shape[0] != spec.n_critic:
            raise ValueError(f"batch['image'] must be a [n_critic={spec.n_critic}"
                             f", B, ...] stack, got shape {tuple(images.shape)}")
        if spec.ema_decay > 0 and state.ema_params is None:
            raise ValueError("spec.ema_decay > 0 but state.ema_params is None")
        n, dev, alpha = images.shape[1], images.device, state.alpha
        nc = spec.num_classes
        if z_critic is None:
            z_critic = torch.randn(spec.n_critic, n, spec.z_dim, device=dev,
                                   generator=state.d_noise)
        if nc and labels_critic is None:
            labels_critic = torch.randint(0, nc, (spec.n_critic, n), device=dev,
                                          generator=state.d_noise)
        fakes = spec.prepare_fakes(z_critic, alpha, labels_critic)

        d_params = list(state.d.parameters())
        for i in range(spec.n_critic):
            labels = (batch["label"][i], labels_critic[i]) if nc else None
            loss, metrics = spec.d_loss(images[i], fakes[i], alpha, state.d_noise,
                                        None if u_gp is None else u_gp[i], labels)
            _apply(d_params, torch.autograd.grad(loss, d_params),
                   state.d_opt, state.d_sched)

        if z_g is None:
            z_g = torch.randn(n, spec.z_dim, device=dev, generator=state.g_noise)
        if nc and labels_g is None:
            labels_g = torch.randint(0, nc, (n,), device=dev, generator=state.g_noise)
        g_named = list(state.g.named_parameters())
        g_params = [p for _, p in g_named]
        g_loss = spec.g_loss(z_g, alpha, labels_g)
        _apply(g_params, torch.autograd.grad(g_loss, g_params),
               state.g_opt, state.g_sched)

        if spec.ema_decay > 0:
            d_ = spec.ema_decay
            ema = [state.ema_params[name] for name, _ in g_named]
            with torch.no_grad():
                torch._foreach_mul_(ema, d_)
                torch._foreach_add_(ema, g_params, alpha=1.0 - d_)
        state.step += 1
        return {**metrics, "g_loss": g_loss.detach()}

    return train_step
