"""ACGAN CIFAR-10 training entry point (port of
``gan_lib_tensorflow_tpu/cli/train_acgan.py``): BCE (or hinge) plus the
auxiliary class loss, Adam(2e-4, 0.5, 0.999) with no lr schedule, n_critic
1, batch 100, no EMA; checkpoints and auto-resume under ``--out-dir``, a
100-sample grid of 10 rows (one class per column).

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_acgan --data fake --steps 20 \
           --out-dir runs/acgan [--adversarial bce|hinge] [--aux-weight 1.0]
       python -m gan_lib_tensorflow_tpu_torch.cli.train_acgan --device cpu --data fake \
           --steps 2 --batch-size 4 --out-dir runs/acgan_cpu
"""

from __future__ import annotations

import os
import sys

import torch

from ..models import acgan
from ..train import (CheckpointManager, LoopConfig, create_state,
                     make_train_step, train_loop)
from ..utils import save_image_grid
from . import common

GRID = 100  # samples in a grid, 10 rows


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--adversarial", default="bce", choices=["bce", "hinge"])
    p.add_argument("--aux-weight", type=float, default=1.0)
    p.set_defaults(batch_size=100, steps=50_000)
    return p.parse_args(argv)


def build(args, mesh=None):
    """Networks, spec and train state on ``args.device`` (on ``mesh``)."""
    dtype = common.compute_dtype(args)
    g = acgan.ACGANGenerator(compute_dtype=dtype)
    d = acgan.ACGANDiscriminator(compute_dtype=dtype)
    spec = acgan.make_acgan_spec(g, d, adversarial=args.adversarial,
                                 aux_weight=args.aux_weight)
    state = create_state(g, d, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
                         seed=args.seed, device=args.device, mesh=mesh)
    return g, d, spec, state


def main(argv=None):
    args = parse_args(argv)
    common.configure(args)
    mesh = common.maybe_mesh(args)
    g, d, spec, state = build(args, mesh)
    device = next(g.parameters()).device
    source = common.image_source(args, args.batch_size, 32, g.num_classes,
                                 n_micro=spec.n_critic, mesh=mesh)
    sampler = acgan.make_sampler(g)
    z_grid = torch.randn(GRID, g.z_dim, generator=torch.Generator().manual_seed(args.seed + 1))
    z_grid = z_grid.to(device)

    def sample_fn(st, it: int) -> None:
        save_image_grid(sampler(st, z_grid).cpu().numpy(),
                        os.path.join(args.out_dir, "samples", f"sample_{it:06d}.png"),
                        rows=10)

    cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                     sample_every=args.sample_every,
                     checkpoint_every=args.ckpt_every, out_dir=args.out_dir,
                     fault_inject_step=args.fault_inject_step,
                     trace_steps=args.trace_steps)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    try:
        return train_loop(state, make_train_step(spec), source, cfg,
                          sample_fn=sample_fn, ckpt=ckpt, n_micro=spec.n_critic)
    finally:
        ckpt.close()


if __name__ == "__main__":
    main(sys.argv[1:])
