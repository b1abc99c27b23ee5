"""SNGAN CIFAR-10 training entry point (port of
``gan_lib_tensorflow_tpu/cli/train_sngan.py``): hinge, Adam(2e-4, 0, 0.9),
n_critic 5, batch 64, linear lr decay, EMA of G; checkpoints and auto-resume
under ``--out-dir``, sample grids, periodic IS/FID. ``--num-classes N`` (> 0)
trains the conditional variant: conditional BN in G, a projection D with 12
spectral-norm weights, real labels from the data source.

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --data fake --steps 20 \
           --out-dir runs/sngan [--ckpt-every 5000] [--eval-every 10000]
       python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan \
           --data data/cifar-10-batches-py [--device-cache auto|on|off]
       python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --data fake --num-classes 10
       torchrun --nproc_per_node 2 -m gan_lib_tensorflow_tpu_torch.cli.train_sngan \
           --data fake [--tp-shards 2] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import torch

from ..data import DeviceCachedStore
from ..eval import compute_statistics, evaluate_generator
from ..eval.inception_v3 import InceptionV3Features
from ..models import sngan
from ..parallel import shard_batch
from ..train import (CheckpointManager, LoopConfig, create_state,
                     make_train_step, train_loop)
from ..train.loop import device_batches
from ..utils import save_image_grid
from . import common

EVAL_BATCH = 100  # the reference's eval batch


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--n-critic", type=int, default=5)
    p.add_argument("--beta1", type=float, default=0.0)
    p.add_argument("--beta2", type=float, default=0.9)
    p.add_argument("--num-classes", type=int, default=0,
                   help=">0 trains the conditional (projection) variant")
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA of G params for sampling (0 disables)")
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="linear-decay horizon (0 = --steps)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="IS/FID every N steps (0 = never); without "
                        "--inception-weights the extractor is the seed-fixed "
                        "random-init InceptionV3 (relative trends only)")
    p.add_argument("--eval-samples", type=int, default=5000)
    p.add_argument("--inception-weights", default=None,
                   help="npz of InceptionV3 weights in the JAX package's layout")
    return p.parse_args(argv)


def build(args, mesh=None):
    """Networks, spec and train state on ``args.device`` (on ``mesh``).

    The lr decays linearly to 0 over ``--lr-decay-steps`` (default
    ``--steps``) counted in each optimizer's OWN updates, as the reference's
    optax schedule does: D, which updates n_critic times per step, reaches
    lr 0 after steps / n_critic G steps."""
    dtype = common.compute_dtype(args)
    g = sngan.cifar_generator(compute_dtype=dtype, num_classes=args.num_classes)
    d = sngan.cifar_discriminator(compute_dtype=dtype, num_classes=args.num_classes)
    spec = sngan.make_sngan_spec(g, d, n_critic=args.n_critic,
                                 ema_decay=args.ema_decay)
    horizon = args.lr_decay_steps or args.steps

    def lr_lambda(count: int) -> float:
        return 1.0 - min(count, horizon) / horizon

    state = create_state(g, d, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
                         ema_decay=args.ema_decay, seed=args.seed,
                         lr_lambda=lr_lambda, device=args.device, mesh=mesh)
    return g, d, spec, state


def real_batches(args, source, n_batches: int):
    """``n_batches`` normalized real ``[EVAL_BATCH, 32, 32, 3]`` batches on
    the card for the real moments. A training store resident on the card is
    read in place (``sequential_batches``), not uploaded a second time;
    otherwise a new source of the same --data is drawn and dropped after."""
    if (isinstance(source, DeviceCachedStore)
            and n_batches * EVAL_BATCH <= len(source)):
        yield from source.sequential_batches(EVAL_BATCH, n_batches)
        return
    real = device_batches(common.image_source(args, EVAL_BATCH, 32, 10), 1, args.device)
    for _ in range(n_batches):
        yield next(real)["image"][0]


def make_eval_fn(args, sampler, z_dim: int, device: torch.device, source=None,
                 mesh=None):
    """``eval_fn(state, it)`` -> IS/FID of ``--eval-samples`` EMA samples.
    The real moments are computed once, here, at batch 100. On a ``mesh``
    each rank samples and featurizes its rows of every batch."""
    net = InceptionV3Features(params_npz=args.inception_weights, device=args.device)
    n_real = max(args.eval_samples // EVAL_BATCH, 1)
    real_stats = compute_statistics(net, real_batches(args, source, n_real),
                                    net.feature_dim, mesh=mesh)

    def eval_fn(state, it: int) -> dict:
        def sample_batch(gen: torch.Generator) -> torch.Tensor:
            z = shard_batch(torch.randn(EVAL_BATCH, z_dim, generator=gen), mesh)
            return sampler(state, z.to(device))

        return evaluate_generator(
            sample_batch, net, net.feature_dim, n_samples=args.eval_samples,
            batch_size=EVAL_BATCH, generator=torch.Generator().manual_seed(args.seed + it),
            real_stats=real_stats, mesh=mesh)

    return eval_fn


def main(argv=None):
    args = parse_args(argv)
    common.configure(args)
    mesh = common.maybe_mesh(args)
    g, d, spec, state = build(args, mesh)
    device = next(g.parameters()).device
    source = common.image_source(args, args.batch_size, 32, 10,
                                 n_micro=spec.n_critic, mesh=mesh)
    sampler = sngan.make_sampler(g)
    z_grid = torch.randn(64, g.z_dim, generator=torch.Generator().manual_seed(args.seed + 1))
    z_grid = z_grid.to(device)

    def sample_fn(st, it: int) -> None:
        save_image_grid(sampler(st, z_grid).cpu().numpy(),
                        os.path.join(args.out_dir, "samples", f"sample_{it:06d}.png"))

    eval_fn = (make_eval_fn(args, sampler, g.z_dim, device, source, mesh)
               if args.eval_every else None)
    cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                     sample_every=args.sample_every,
                     checkpoint_every=args.ckpt_every,
                     eval_every=args.eval_every, out_dir=args.out_dir,
                     fault_inject_step=args.fault_inject_step,
                     trace_steps=args.trace_steps)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    try:
        return train_loop(state, make_train_step(spec), source, cfg,
                          sample_fn=sample_fn, ckpt=ckpt, eval_fn=eval_fn,
                          n_micro=spec.n_critic)
    finally:
        ckpt.close()


if __name__ == "__main__":
    main(sys.argv[1:])
