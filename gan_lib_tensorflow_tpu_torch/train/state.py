"""Train state (port of ``gan_lib_tensorflow_tpu/train/state.py``): a plain
container of the two networks, the EMA of G's parameters, the two Adam
optimizers (with their optional lr schedules), the step count and the
generators the step draws its noise from; its checkpoint dict, and the
inference view of a checkpoint (``EvalState``)."""

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


@dataclasses.dataclass
class EvalState:
    """Inference view of a checkpoint (reference ``state.py:35-46``): what a
    sampler needs, never the optimizers. ``g`` is G's ``state_dict``
    (weights and buffers, e.g. BN running stats); load it into the
    generator, whose sampler then reads ``ema_params`` and ``alpha``."""
    step: int
    g: Dict[str, torch.Tensor]
    ema_params: Optional[Dict[str, torch.Tensor]]
    alpha: float = 1.0


def eval_state_from_raw(raw: dict) -> EvalState:
    """``CheckpointManager.restore_latest_raw()`` -> ``EvalState``."""
    return EvalState(step=int(raw["step"]), g=raw["g"],
                     ema_params=raw.get("ema_params"),
                     alpha=float(raw.get("alpha", 1.0)))


def to_checkpoint(state: GANTrainState) -> dict:
    """Everything that decides the next step, as tensors, numbers, strings,
    lists and dicts (what ``torch.load(weights_only=True)`` accepts). The
    tensors are the state's own, not copies."""
    return {
        "step": int(state.step), "alpha": float(state.alpha),
        "g": state.g.state_dict(), "d": state.d.state_dict(),
        "g_opt": state.g_opt.state_dict(), "d_opt": state.d_opt.state_dict(),
        "g_sched": None if state.g_sched is None else state.g_sched.state_dict(),
        "d_sched": None if state.d_sched is None else state.d_sched.state_dict(),
        "ema_params": state.ema_params,
        "g_noise": state.g_noise.get_state(), "d_noise": state.d_noise.get_state(),
    }


def load_checkpoint(state: GANTrainState, ckpt: dict) -> None:
    """Load ``to_checkpoint``'s dict into ``state`` in place: every tensor
    is copied into the state's own, on its device."""
    state.g.load_state_dict(ckpt["g"])
    state.d.load_state_dict(ckpt["d"])
    state.g_opt.load_state_dict(ckpt["g_opt"])
    state.d_opt.load_state_dict(ckpt["d_opt"])
    for sched, key in ((state.g_sched, "g_sched"), (state.d_sched, "d_sched")):
        if (sched is None) != (ckpt[key] is None):
            raise ValueError(f"checkpoint {key} is {ckpt[key]!r} but the state's "
                             f"is {sched!r}")
        if sched is not None:
            sched.load_state_dict(ckpt[key])
    if (state.ema_params is None) != (ckpt["ema_params"] is None):
        raise ValueError("the checkpoint and the state disagree on having an EMA")
    if state.ema_params is not None:
        with torch.no_grad():
            for name, t in state.ema_params.items():
                t.copy_(ckpt["ema_params"][name])
    state.g_noise.set_state(ckpt["g_noise"])
    state.d_noise.set_state(ckpt["d_noise"])
    state.step = int(ckpt["step"])
    state.alpha = float(ckpt["alpha"])


def create_state(g: nn.Module, d: nn.Module, *, lr: float = 2e-4,
                 beta1: float = 0.0, beta2: float = 0.9,
                 ema_decay: float = 0.0, seed: int = 0,
                 lr_lambda: Optional[Callable[[int], float]] = None,
                 device="cuda", d_lr: Optional[float] = None) -> GANTrainState:
    """Draw both networks' weights from ``seed`` (each layer by its own rule,
    ``ops/layers.py:init_weights``, so any model family's), move them to
    ``device`` and build Adam (optax's defaults: eps 1e-8) for each: G's at
    ``lr``, D's at ``d_lr`` (default ``lr``; two rates are the TTUR of
    SNGAN-projection). ``lr_lambda`` maps an optimizer's own update count to
    an lr multiplier."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init_weights(g, gen)
    init_weights(d, gen)
    g.to(dev)
    d.to(dev)
    g_opt = torch.optim.Adam(g.parameters(), lr=lr, betas=(beta1, beta2), eps=1e-8)
    d_opt = torch.optim.Adam(d.parameters(), lr=lr if d_lr is None else d_lr,
                             betas=(beta1, beta2), eps=1e-8)
    sched = (lambda opt: None) if lr_lambda is None else (
        lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda))
    ema = ({n: p.detach().clone() for n, p in g.named_parameters()}
           if ema_decay > 0 else None)
    return GANTrainState(
        g=g, d=d, g_opt=g_opt, d_opt=d_opt, ema_params=ema,
        g_noise=torch.Generator(device=dev).manual_seed(seed + 1),
        d_noise=torch.Generator(device=dev).manual_seed(seed + 2),
        g_sched=sched(g_opt), d_sched=sched(d_opt))
