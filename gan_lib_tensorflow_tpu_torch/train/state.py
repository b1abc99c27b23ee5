"""Train state (port of ``gan_lib_tensorflow_tpu/train/state.py``): a plain
container of the two networks, the EMA of G's parameters, the two Adam
optimizers (with their optional lr schedules), the step count and the
generators the step draws its noise from."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.layers import init_weights


@dataclasses.dataclass
class GANTrainState:
    g: nn.Module
    d: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]  # EMA of G's parameters
    g_noise: torch.Generator   # z for the G update
    d_noise: torch.Generator   # z for the critic substeps' fakes
    g_sched: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    d_sched: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0
    # PGGAN fade-in weight, a host float the loop sets before each step
    # (reference state.py:30-32); other families leave it at 1.0
    alpha: float = 1.0


def create_state(g: nn.Module, d: nn.Module, *, lr: float = 2e-4,
                 beta1: float = 0.0, beta2: float = 0.9,
                 ema_decay: float = 0.0, seed: int = 0,
                 lr_lambda: Optional[Callable[[int], float]] = None,
                 device="cuda") -> GANTrainState:
    """Draw both networks' weights from ``seed`` (each layer by its own rule,
    ``ops/layers.py:init_weights``, so any model family's), move them to
    ``device`` and build Adam (optax's defaults: eps 1e-8) for each. ``lr_lambda`` maps
    an optimizer's own update count to an lr multiplier."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init_weights(g, gen)
    init_weights(d, gen)
    g.to(dev)
    d.to(dev)
    g_opt = torch.optim.Adam(g.parameters(), lr=lr, betas=(beta1, beta2), eps=1e-8)
    d_opt = torch.optim.Adam(d.parameters(), lr=lr, betas=(beta1, beta2), eps=1e-8)
    sched = (lambda opt: None) if lr_lambda is None else (
        lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda))
    ema = ({n: p.detach().clone() for n, p in g.named_parameters()}
           if ema_decay > 0 else None)
    return GANTrainState(
        g=g, d=d, g_opt=g_opt, d_opt=d_opt, ema_params=ema,
        g_noise=torch.Generator(device=dev).manual_seed(seed + 1),
        d_noise=torch.Generator(device=dev).manual_seed(seed + 2),
        g_sched=sched(g_opt), d_sched=sched(d_opt))
