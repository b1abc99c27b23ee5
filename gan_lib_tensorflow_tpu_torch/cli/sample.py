"""Sampling entry point (port of ``gan_lib_tensorflow_tpu/cli/sample.py``):
restore the newest checkpoint and write a grid of EMA samples from a
seed-fixed z; ``--export-dir`` also writes the serving bundle of that
sampler (``train/export.py``) for a batch of ``--n``.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model sngan \\
      --ckpt-dir runs/out/ckpt --out samples.png --n 64
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model pggan \\
      --ckpt-dir runs/pggan/64x64_stabilize/ckpt --resolution 64
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model sngan_imagenet \\
      --ckpt-dir runs/imagenet/ckpt --n 36
  python -m gan_lib_tensorflow_tpu_torch.cli.sample --model acgan \\
      --ckpt-dir runs/acgan/ckpt --n 100

A conditional G (``sngan_imagenet``, ``acgan``, ``sngan --num-classes N``)
samples the classes ``arange(n) % num_classes``. A PGGAN G is built without
the fade-in, as the reference builds it: a transition checkpoint samples
(and exports) as G at alpha 1 without its second toRGB, whatever its alpha
(``pggan.sampling_state``).
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch import nn

from .. import resolve_device
from ..models import acgan, pggan, sngan
from ..train import CheckpointManager, eval_state_from_raw
from ..train.export import write_serving_bundle
from ..utils import save_image_grid


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True,
                   choices=["sngan", "sngan_imagenet", "imagenet", "acgan", "pggan"])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int, default=1024, help="pggan only")
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="pggan/sngan_imagenet channel-width multiplier")
    p.add_argument("--num-classes", type=int, default=0,
                   help="sngan: classes of the conditional G (0 = unconditional); "
                        "sngan_imagenet: its classes (0 = 1000)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    p.add_argument("--export-dir", default=None,
                   help="also write the serving bundle (checkpoint + generator.pt2) here")
    return p.parse_args(argv)


class SamplerModule(nn.Module):
    """The sampler as a module of z alone, for the export: a PGGAN G as it
    is (no fade-in, so no alpha); any other G at ``train=False`` on the
    classes ``arange(n) % num_classes`` of a conditional G (a buffer), None
    otherwise."""

    def __init__(self, g: nn.Module, n: int):
        super().__init__()
        self.g = g
        nc = getattr(g, "num_classes", 0)
        self.register_buffer("labels", torch.arange(n) % nc if nc else None)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if isinstance(self.g, pggan.PGGANGenerator):
            return self.g(z)
        return self.g(z, self.labels, train=False)


def build_generator(args, g_state: dict):
    """The generator that samples a checkpoint of ``--model``; a PGGAN G's
    first Dense (``[out, z_dim]``) gives its latent width."""
    if args.model == "sngan":
        return sngan.make_sampler, sngan.cifar_generator(num_classes=args.num_classes)
    if args.model == "acgan":
        return acgan.make_sampler, acgan.ACGANGenerator()
    if args.model in ("sngan_imagenet", "imagenet"):
        return sngan.make_sampler, sngan.imagenet128_generator(
            num_classes=args.num_classes or 1000, width_mul=args.width_mul)
    return pggan.make_sampler, pggan.PGGANGenerator(
        resolution=args.resolution, z_dim=g_state["dense_4.weight"].shape[1],
        width_mul=args.width_mul)


def main(argv=None) -> torch.Tensor:
    """Writes the grid (and the bundle); returns the samples."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    raw = CheckpointManager(args.ckpt_dir).restore_latest_raw(map_location=dev)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
    state = eval_state_from_raw(raw)
    sampled = (pggan.sampling_state(state, args.resolution) if args.model == "pggan"
               else state)
    make_sampler, g = build_generator(args, state.g)
    g.load_state_dict(sampled.g)
    g.to(dev)
    z = torch.randn(args.n, g.z_dim, generator=torch.Generator().manual_seed(args.seed))
    imgs = make_sampler(g)(sampled, z.to(dev))
    save_image_grid(imgs.cpu().numpy(), args.out)
    print(f"wrote {args.n} samples (step {state.step}) to {args.out}", flush=True)
    if args.export_dir:
        export_generator(args, g, state, sampled, dev)
    return imgs


def export_generator(args, g, state, sampled, dev) -> str:
    """The serving bundle of the sampler: the checkpoint's G and EMA
    parameters and alpha in the payload; G in the module with the
    parameters it samples with (``sampled``: EMA where the checkpoint has
    them, G's own otherwise) and its buffers."""
    payload = {"g": state.g, "alpha": state.alpha}
    if state.ema_params is not None:
        payload["ema_params"] = state.ema_params
        g.load_state_dict({**sampled.g, **sampled.ema_params})
    return write_serving_bundle(args.export_dir, state.step, payload,
                                SamplerModule(g, args.n).to(dev),
                                torch.zeros(args.n, g.z_dim, device=dev))


if __name__ == "__main__":
    main(sys.argv[1:])
