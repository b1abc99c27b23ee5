"""Train state (port of ``gan_lib_tensorflow_tpu/train/state.py``): a plain
container of the two networks, the EMA of G's parameters, the two Adam
optimizers (with their optional lr schedules), the step count and the
generators the step draws its noise from, and the mesh it trains on; its
checkpoint dict (always the one-rank format), and the inference view of a
checkpoint (``EvalState``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.layers import init_weights
from ..parallel.mesh import Mesh
from ..parallel.sharding import DEFAULT_MIN_FEATURES, ModelShards, train_state_shardings


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
    # the mesh the step runs on (None: one process), and each network's
    # 'model' shards under tensor parallelism (None: the optimizer and EMA
    # hold the full parameters)
    mesh: Optional[Mesh] = None
    g_shards: Optional[ModelShards] = None
    d_shards: Optional[ModelShards] = None


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
    lists and dicts (what ``torch.load(weights_only=True)`` accepts), in the
    one-rank format whatever the mesh: under 'model' sharding the shards of
    the Adam slots and the EMA are gathered (a collective: every rank calls
    this). Otherwise the tensors are the state's own, not copies."""
    return {
        "step": int(state.step), "alpha": float(state.alpha),
        "g": state.g.state_dict(), "d": state.d.state_dict(),
        "g_opt": _opt_state(state.g_opt, state.g_shards, "full"),
        "d_opt": _opt_state(state.d_opt, state.d_shards, "full"),
        "g_sched": None if state.g_sched is None else state.g_sched.state_dict(),
        "d_sched": None if state.d_sched is None else state.d_sched.state_dict(),
        "ema_params": full_ema(state),
        "g_noise": state.g_noise.get_state(), "d_noise": state.d_noise.get_state(),
    }


def full_ema(state: GANTrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA at full size (gathered over 'model' under sharding: every
    rank calls this)."""
    sh = state.g_shards
    if state.ema_params is None or sh is None:
        return state.ema_params
    return {n: sh.full(n, t) if n in sh.masters else t for n, t in state.ema_params.items()}


def gathered(state: GANTrainState) -> GANTrainState:
    """A view of ``state`` whose EMA is full-size, for a sampler or an eval
    (a collective under 'model' sharding: every rank calls this)."""
    if state.g_shards is None:
        return state
    return dataclasses.replace(state, ema_params=full_ema(state))


def _opt_state(opt: torch.optim.Optimizer, shards: Optional[ModelShards], to: str,
               sd: Optional[dict] = None) -> dict:
    """``opt.state_dict()`` (or ``sd``) with the slots of every sharded
    parameter gathered (``to="full"``) or cut to this rank's shard
    (``to="shard"``); unchanged without shards."""
    sd = opt.state_dict() if sd is None else sd
    if shards is None:
        return sd
    names = list(shards.params)
    states = {}
    for idx, st in sd["state"].items():
        name = names[int(idx)]
        if name in shards.masters:
            cut = ((lambda t: shards.full(name, t)) if to == "full"
                   else (lambda t: shards.shard(name, t).clone()))
            st = {k: cut(v) if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
        states[idx] = st
    return {**sd, "state": states}


def load_checkpoint(state: GANTrainState, ckpt: dict) -> None:
    """Load ``to_checkpoint``'s dict into ``state`` in place: every tensor
    is copied into the state's own, on its device; under 'model' sharding
    the rank takes its shards of the one-rank checkpoint, so a run resumes
    at another world size or shard count."""
    state.g.load_state_dict(ckpt["g"])
    state.d.load_state_dict(ckpt["d"])
    for net in ("g", "d"):
        shards = getattr(state, f"{net}_shards")
        if shards is not None:
            shards.load_full()
        getattr(state, f"{net}_opt").load_state_dict(
            _opt_state(None, shards, "shard", ckpt[f"{net}_opt"]))
    for sched, key in ((state.g_sched, "g_sched"), (state.d_sched, "d_sched")):
        if (sched is None) != (ckpt[key] is None):
            raise ValueError(f"checkpoint {key} is {ckpt[key]!r} but the state's "
                             f"is {sched!r}")
        if sched is not None:
            sched.load_state_dict(ckpt[key])
    if (state.ema_params is None) != (ckpt["ema_params"] is None):
        raise ValueError("the checkpoint and the state disagree on having an EMA")
    if state.ema_params is not None:
        sh = state.g_shards
        with torch.no_grad():
            for name, t in state.ema_params.items():
                full = ckpt["ema_params"][name]
                t.copy_(full if sh is None else sh.shard(name, full))
    state.g_noise.set_state(ckpt["g_noise"])
    state.d_noise.set_state(ckpt["d_noise"])
    state.step = int(ckpt["step"])
    state.alpha = float(ckpt["alpha"])


def create_state(g: nn.Module, d: nn.Module, *, lr: float = 2e-4,
                 beta1: float = 0.0, beta2: float = 0.9,
                 ema_decay: float = 0.0, seed: int = 0,
                 lr_lambda: Optional[Callable[[int], float]] = None,
                 device="cuda", d_lr: Optional[float] = None,
                 mesh: Optional[Mesh] = None,
                 min_features: int = DEFAULT_MIN_FEATURES) -> GANTrainState:
    """Draw both networks' weights from ``seed`` (each layer by its own rule,
    ``ops/layers.py:init_weights``, so any model family's), move them to
    ``device`` and build Adam (optax's defaults: eps 1e-8) for each: G's at
    ``lr``, D's at ``d_lr`` (default ``lr``; two rates are the TTUR of
    SNGAN-projection). ``lr_lambda`` maps an optimizer's own update count to
    an lr multiplier. On a ``mesh`` every rank draws the same weights; with a
    'model' axis the parameters ``parallel.train_state_shardings`` names
    (at ``min_features``) are held as the rank's shards by the optimizer
    and the EMA."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init_weights(g, gen)
    init_weights(d, gen)
    g.to(dev)
    d.to(dev)
    g_shards = d_shards = None
    if mesh is not None and mesh.size("model") > 1:
        names = train_state_shardings(g, d, mesh, min_features)
        g_shards = ModelShards(g, names["g"], mesh)
        d_shards = ModelShards(d, names["d"], mesh)
    held = lambda net, sh: list(net.parameters()) if sh is None else sh.opt_params()
    g_held, d_held = held(g, g_shards), held(d, d_shards)
    g_opt = torch.optim.Adam(g_held, lr=lr, betas=(beta1, beta2), eps=1e-8)
    d_opt = torch.optim.Adam(d_held, lr=lr if d_lr is None else d_lr,
                             betas=(beta1, beta2), eps=1e-8)
    sched = (lambda opt: None) if lr_lambda is None else (
        lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda))
    ema = ({n: p.detach().clone() for (n, _), p in zip(g.named_parameters(), g_held)}
           if ema_decay > 0 else None)
    return GANTrainState(
        g=g, d=d, g_opt=g_opt, d_opt=d_opt, ema_params=ema,
        g_noise=torch.Generator(device=dev).manual_seed(seed + 1),
        d_noise=torch.Generator(device=dev).manual_seed(seed + 2),
        g_sched=sched(g_opt), d_sched=sched(d_opt), mesh=mesh,
        g_shards=g_shards, d_shards=d_shards)
