"""SNGAN CIFAR-10 training entry point (port of
``gan_lib_tensorflow_tpu/cli/train_sngan.py``): hinge, Adam(2e-4, 0, 0.9),
n_critic 5, batch 64, linear lr decay, EMA of G.

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --data fake --steps 20
"""

from __future__ import annotations

import sys

from ..models import sngan
from ..train import LoopConfig, create_state, make_train_step, train_loop
from . import common


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--n-critic", type=int, default=5)
    p.add_argument("--beta1", type=float, default=0.0)
    p.add_argument("--beta2", type=float, default=0.9)
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA of G params for sampling (0 disables)")
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="linear-decay horizon (0 = --steps)")
    return p.parse_args(argv)


def build(args):
    """Networks, spec and train state on ``args.device``.

    The lr decays linearly to 0 over ``--lr-decay-steps`` (default
    ``--steps``) counted in each optimizer's OWN updates, as the reference's
    optax schedule does: D, which updates n_critic times per step, reaches
    lr 0 after steps / n_critic G steps."""
    dtype = common.compute_dtype(args)
    g = sngan.cifar_generator(compute_dtype=dtype)
    d = sngan.cifar_discriminator(compute_dtype=dtype)
    spec = sngan.make_sngan_spec(g, d, n_critic=args.n_critic,
                                 ema_decay=args.ema_decay)
    horizon = args.lr_decay_steps or args.steps

    def lr_lambda(count: int) -> float:
        return 1.0 - min(count, horizon) / horizon

    state = create_state(g, d, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
                         ema_decay=args.ema_decay, seed=args.seed,
                         lr_lambda=lr_lambda, device=args.device)
    return g, d, spec, state


def main(argv=None):
    args = parse_args(argv)
    g, d, spec, state = build(args)
    source = common.image_source(args, args.batch_size, 32, 10,
                                 n_micro=spec.n_critic)
    cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every)
    return train_loop(state, make_train_step(spec), source, cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
