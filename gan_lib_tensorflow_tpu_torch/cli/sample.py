"""Sampling entry point (port of ``gan_lib_tensorflow_tpu/cli/sample.py``,
without ``--export-dir``): restore the newest checkpoint and write a grid of
EMA samples from a seed-fixed z.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model sngan \\
      --ckpt-dir runs/out/ckpt --out samples.png --n 64
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model pggan \\
      --ckpt-dir runs/pggan/64x64_stabilize/ckpt --resolution 64
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model sngan_imagenet \\
      --ckpt-dir runs/imagenet/ckpt --n 36

A conditional G (``sngan_imagenet``) samples the classes ``arange(n) %
num_classes``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..models import pggan, sngan
from ..train import CheckpointManager, eval_state_from_raw
from ..utils import save_image_grid


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True,
                   choices=["sngan", "sngan_imagenet", "imagenet", "pggan"])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int, default=1024, help="pggan only")
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="pggan/sngan_imagenet channel-width multiplier")
    p.add_argument("--num-classes", type=int, default=0,
                   help="sngan_imagenet: classes of the conditional G (0 = 1000)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    return p.parse_args(argv)


def build_generator(args, g_state: dict):
    """The generator a checkpoint of ``--model`` was trained with. A PGGAN
    checkpoint of a transition phase carries the fade-in's second toRGB; its
    first Dense (``[out, z_dim]``) gives the latent width."""
    if args.model == "sngan":
        return sngan.make_sampler, sngan.cifar_generator()
    if args.model in ("sngan_imagenet", "imagenet"):
        return sngan.make_sampler, sngan.imagenet128_generator(
            num_classes=args.num_classes or 1000, width_mul=args.width_mul)
    fade = f"torgb_{args.resolution // 2}.weight" in g_state
    return pggan.make_sampler, pggan.PGGANGenerator(
        resolution=args.resolution, fade_in=fade,
        z_dim=g_state["dense_4.weight"].shape[1], width_mul=args.width_mul)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    raw = CheckpointManager(args.ckpt_dir).restore_latest_raw(map_location=dev)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
    state = eval_state_from_raw(raw)
    make_sampler, g = build_generator(args, state.g)
    g.load_state_dict(state.g)
    g.to(dev)
    z = torch.randn(args.n, g.z_dim, generator=torch.Generator().manual_seed(args.seed))
    imgs = make_sampler(g)(state, z.to(dev))
    save_image_grid(imgs.cpu().numpy(), args.out)
    print(f"wrote {args.n} samples (step {state.step}) to {args.out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
