"""SNGAN-projection ImageNet-128 training entry point (port of
``gan_lib_tensorflow_tpu/cli/train_sngan_imagenet.py``): G with BN
conditional on the class, projection D, hinge loss, n_critic 5, TTUR Adam
(G 1e-4, D 4e-4, betas 0 and 0.9), linear lr decay over --steps, EMA of G;
checkpoints and auto-resume under --out-dir, sample grids.

--data: a packed store of 128^2 labelled images (held on the card when it
fits --device-cache-gb, else streamed as uint8), a downsampled-ImageNet npz
file or a directory of them (streamed), 'fake'/'auto' and 'fake-rich'
(synthetic class blobs rendered on the host; at 5 x 64 images of 128^2 a
step, the host renderer is slow) or 'device-fake'/'device-rich' (rendered
on the device). Image-folder datasets, which the reference decodes with
Pillow, are not read here: pack them first.

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan_imagenet \\
           --data runs/imagenet128_store --steps 450000 --out-dir runs/imagenet
"""

from __future__ import annotations

import glob
import os
import sys

import torch

from .. import data
from ..models import sngan
from ..train import (CheckpointManager, LoopConfig, create_state,
                     make_train_step, train_loop)
from ..utils import save_image_grid
from . import common

IMAGE_SIZE = 128
GRID = 36  # samples per grid, as the reference draws them


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--n-critic", type=int, default=5)
    p.add_argument("--g-lr", type=float, default=1e-4)
    p.add_argument("--d-lr", type=float, default=4e-4)
    p.add_argument("--beta1", type=float, default=0.0)
    p.add_argument("--beta2", type=float, default=0.9)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="channel-width multiplier (1.0 = reference width; "
                        "evaluate and sample with the same value)")
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA of G params for sampling (0 disables)")
    p.set_defaults(steps=450_000)
    return p.parse_args(argv)


def build(args, mesh=None):
    """Networks, spec and train state on ``args.device`` (on ``mesh``). Each optimizer's
    lr decays linearly to 0 over --steps of its OWN updates, as the
    reference's optax schedules count them."""
    dtype = common.compute_dtype(args)
    g = sngan.imagenet128_generator(compute_dtype=dtype, num_classes=args.num_classes,
                                    width_mul=args.width_mul)
    d = sngan.imagenet128_discriminator(compute_dtype=dtype, num_classes=args.num_classes,
                                        width_mul=args.width_mul)
    spec = sngan.make_sngan_spec(g, d, n_critic=args.n_critic, ema_decay=args.ema_decay)

    def lr_lambda(count: int) -> float:
        return 1.0 - min(count, args.steps) / args.steps

    state = create_state(g, d, lr=args.g_lr, d_lr=args.d_lr, beta1=args.beta1,
                         beta2=args.beta2, ema_decay=args.ema_decay, seed=args.seed,
                         lr_lambda=lr_lambda, device=args.device, mesh=mesh)
    return g, d, spec, state


def _has_npz(path: str) -> bool:
    return os.path.isdir(path) and bool(glob.glob(os.path.join(path, "*.npz")))


def image_source(args, n_micro: int, mesh=None):
    """Resolve --data (see the module docstring); a path never falls back."""
    if args.data not in ("auto", *common.SYNTHETIC):
        if not os.path.exists(args.data):
            raise FileNotFoundError(f"--data {args.data!r}: no such path")
        if args.data.endswith(".npz") or _has_npz(args.data):
            return data.ThreadedSource(
                data.ImageNetNpz(args.data, batch_size=args.batch_size,
                                 image_size=IMAGE_SIZE, seed=args.seed),
                num_workers=1)
        if not data.is_packed_dir(args.data):
            raise ValueError(f"--data {args.data}: neither a packed store nor npz "
                             f"files; image folders are read by Pillow, which this "
                             f"package does not use: pack them first")
    # 'auto' is 'fake' at 128^2, as in the reference
    return common.image_source(args, args.batch_size, IMAGE_SIZE, args.num_classes,
                               n_micro=n_micro, mesh=mesh)


def main(argv=None):
    args = parse_args(argv)
    common.configure(args)
    mesh = common.maybe_mesh(args)
    g, d, spec, state = build(args, mesh)
    device = next(g.parameters()).device
    source = image_source(args, spec.n_critic, mesh)
    sampler = sngan.make_sampler(g)
    z_grid = torch.randn(GRID, g.z_dim,
                         generator=torch.Generator().manual_seed(args.seed + 1)).to(device)

    def sample_fn(st, it: int) -> None:
        save_image_grid(sampler(st, z_grid).cpu().numpy(),
                        os.path.join(args.out_dir, "samples", f"sample_{it:06d}.png"))

    cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                     sample_every=args.sample_every,
                     checkpoint_every=args.ckpt_every, out_dir=args.out_dir,
                     fault_inject_step=args.fault_inject_step,
                     trace_steps=args.trace_steps, curves=args.curves,
                     tensorboard=args.tensorboard)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    try:
        return train_loop(state, make_train_step(spec), source, cfg,
                          sample_fn=sample_fn, ckpt=ckpt, n_micro=spec.n_critic)
    finally:
        ckpt.close()


if __name__ == "__main__":
    main(sys.argv[1:])
