"""PGGAN progressive-growing ladder (port of ``gan_lib_tensorflow_tpu/train/
pggan_loop.py:32-178``, with its remat, its space-to-depth top level and its
mesh: 'data', or 'data' x 'sp' for the spatial partitioning of the height).

For each level from ``start_resolution`` to ``final_resolution``: a
transition phase (alpha rises linearly to 1 over the phase) and then a
stabilize phase; the first level has only the stabilize phase. Every phase
builds fresh networks and fresh Adam states (``build_phase``); G, D and the
EMA take every tensor they share by name and shape with the phase before.
``s2d_from_resolution``: each stage runs its own top level on the
space-to-depth grid when that level is at or above it, and only that level
(the stage's threshold is ``max(s2d_from, res)``, reference ``:105-118``).

With ``out_dir`` set, each phase gets its own directory ``<res>x<res>_<phase>/``
with a checkpoint manager (``ckpt/``), grids of 16 samples from a fixed z and
``log.jsonl``; a re-run with the same ``out_dir`` resumes every phase from its
newest checkpoint (a finished phase restores its last step and trains none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch

from ..models import pggan
from ..parallel import is_writer
from ..utils import save_image_grid
from .checkpoint import CheckpointManager
from .loop import LoopConfig, train_loop
from .state import GANTrainState, create_state
from .step import GANSpec, make_train_step

# The reference's batch schedule shrinks with resolution to fit memory
DEFAULT_BATCH_BY_RES = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16,
                        128: 16, 256: 8, 512: 4, 1024: 4}


@dataclasses.dataclass
class LadderConfig:
    start_resolution: int = 4
    final_resolution: int = 1024
    images_per_phase: int = 600_000
    batch_by_res: Dict[int, int] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_BATCH_BY_RES))
    lr: float = 1e-3
    beta1: float = 0.0
    beta2: float = 0.99
    width_mul: float = 1.0
    z_dim: int = 512
    ema_decay: float = 0.999
    compute_dtype: Optional[torch.dtype] = None
    seed: int = 0
    out_dir: Optional[str] = None
    log_every: int = 100
    sample_every: int = 1000
    checkpoint_every: int = 5000
    # fixed step count per phase for short runs (None: images_per_phase / batch)
    steps_per_phase: Optional[int] = None
    # the fused_scale D blocks from this resolution upward (0 = never)
    fused_from_resolution: int = 0
    # rematerialize the G and D level blocks from this resolution upward
    # (0 = never): activation memory for recompute, the same function
    remat_from_resolution: int = 0
    # each stage's own top level on the space-to-depth grid when it is at or
    # above this resolution (0 = never): the same function and parameters
    s2d_from_resolution: int = 0
    device: str = "cuda"
    # the mesh every phase trains on (None: one process): ('data',), or
    # ('data', 'sp') whose 'sp' axis shards the image height
    mesh: Optional[Any] = None
    # torch.profiler trace of this many (+ 1) steps from each phase's 10th
    trace_steps: int = 0
    # each phase's curve PNGs and TensorBoard scalars (LoopConfig's)
    curves: bool = False
    tensorboard: bool = False


def resolutions(cfg: LadderConfig) -> Iterator[int]:
    r = cfg.start_resolution
    while r <= cfg.final_resolution:
        yield r
        r *= 2


@dataclasses.dataclass
class Phase:
    """One (resolution, phase) of the ladder, ready to train."""
    resolution: int
    name: str
    spec: GANSpec
    state: GANTrainState
    batch: int
    steps: int
    alpha_fn: Callable[[int], float]


def build_phase(cfg: LadderConfig, res: int, phase: str,
                prev: Optional[GANTrainState] = None) -> Phase:
    """Networks, spec and state of one phase, with G, D and the EMA migrated
    from ``prev`` (the state at the end of the phase before)."""
    fade = phase == "transition"
    s2d_eff = max(cfg.s2d_from_resolution, res) if cfg.s2d_from_resolution else 0
    g = pggan.PGGANGenerator(resolution=res, fade_in=fade, z_dim=cfg.z_dim,
                             width_mul=cfg.width_mul,
                             remat_from=cfg.remat_from_resolution,
                             s2d_from=s2d_eff, compute_dtype=cfg.compute_dtype)
    d = pggan.PGGANDiscriminator(resolution=res, fade_in=fade,
                                 width_mul=cfg.width_mul,
                                 fused_from=cfg.fused_from_resolution,
                                 remat_from=cfg.remat_from_resolution,
                                 s2d_from=s2d_eff, compute_dtype=cfg.compute_dtype)
    spec = pggan.make_pggan_spec(g, d, ema_decay=cfg.ema_decay)
    state = create_state(g, d, lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
                         ema_decay=cfg.ema_decay,
                         seed=cfg.seed + res + (0 if fade else 1),
                         device=cfg.device, mesh=cfg.mesh)
    if prev is not None:
        g_copied = pggan.migrate_params(dict(prev.g.named_parameters()),
                                        dict(g.named_parameters()))
        d_copied = pggan.migrate_params(dict(prev.d.named_parameters()),
                                        dict(d.named_parameters()))
        if prev.ema_params is not None and state.ema_params is not None:
            pggan.migrate_params(prev.ema_params, state.ema_params)
        if is_writer():
            print(f"[pggan] {res}x{res} {phase}: migrated "
                  f"{g_copied} G + {d_copied} D tensors", flush=True)
    batch = cfg.batch_by_res[res]
    steps = cfg.steps_per_phase or max(cfg.images_per_phase // batch, 1)
    alpha_fn = ((lambda i, s=steps: min((i % s + 1) / s, 1.0))
                if fade else (lambda i: 1.0))
    return Phase(res, phase, spec, state, batch, steps, alpha_fn)


def train_pggan_ladder(
    cfg: LadderConfig,
    source_factory: Callable[[int, int], Iterable],
    phase_hook: Optional[Callable[[str, int, str, GANTrainState], None]] = None,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> GANTrainState:
    """Run the whole ladder; returns the last phase's state.
    ``source_factory(resolution, batch)`` yields ``{"image": [1, B, res, res,
    3]}`` stacks of reals (on ``cfg.mesh``: a source made for it, which
    yields the rank's rows and, over 'sp', its height rows; or a host source
    of global batches). ``phase_hook(when, res, phase, state)`` is called
    with ``when='start'`` after migration, before the phase's first step, and
    with ``when='end'`` after its last."""
    prev: Optional[GANTrainState] = None
    for res in resolutions(cfg):
        for phase in (["stabilize"] if res == cfg.start_resolution
                      else ["transition", "stabilize"]):
            ph = build_phase(cfg, res, phase, prev)
            if phase_hook is not None:
                phase_hook("start", res, phase, ph.state)
            phase_dir = (os.path.join(cfg.out_dir, f"{res}x{res}_{phase}")
                         if cfg.out_dir else None)
            loop_cfg = LoopConfig(total_steps=ph.steps, log_every=cfg.log_every,
                                  sample_every=cfg.sample_every,
                                  checkpoint_every=cfg.checkpoint_every,
                                  out_dir=phase_dir, trace_steps=cfg.trace_steps,
                                  curves=cfg.curves, tensorboard=cfg.tensorboard)
            ckpt = (CheckpointManager(os.path.join(phase_dir, "ckpt"))
                    if phase_dir else None)
            try:
                prev = train_loop(ph.state, make_train_step(ph.spec),
                                  source_factory(res, ph.batch), loop_cfg, log_fn,
                                  alpha_fn=ph.alpha_fn,
                                  sample_fn=_phase_sampler(cfg, ph, phase_dir),
                                  ckpt=ckpt)
            finally:
                if ckpt is not None:
                    ckpt.close()
            if phase_hook is not None:
                phase_hook("end", res, phase, prev)
    return prev


def _phase_sampler(cfg: LadderConfig, ph: Phase, phase_dir: Optional[str]):
    """Writes ``sample_{it:06d}.png`` in ``phase_dir``: 16 samples of the
    EMA generator from a fixed z (seed + 99), None without a directory."""
    if phase_dir is None:
        return None
    sampler = pggan.make_sampler(ph.state.g)
    z = torch.randn(16, cfg.z_dim, generator=torch.Generator().manual_seed(cfg.seed + 99))
    z = z.to(next(ph.state.g.parameters()).device)

    def sample_fn(state: GANTrainState, it: int) -> None:
        imgs = sampler(state, z)
        save_image_grid(imgs.cpu().numpy(), os.path.join(phase_dir, f"sample_{it:06d}.png"))

    return sample_fn
