"""PGGAN entry point: the progressive ladder 4x4 -> --final-resolution (port
of ``gan_lib_tensorflow_tpu/cli/train_pggan.py``; WGAN-GP + drift,
Adam(1e-3, 0, 0.99), G EMA 0.999, a transition (fade-in) and a stabilize
phase per level, fused_scale D blocks from 128x128).

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --data fake --steps-per-phase 2 \
           --out-dir runs/pggan
(one directory per phase under --out-dir: checkpoints, sample grids, log.jsonl;
a re-run with the same --out-dir resumes every phase)
"""

from __future__ import annotations

import sys

from ..data import DeviceFakeImages
from ..train.pggan_loop import LadderConfig, train_pggan_ladder
from . import common


def parse_batch_by_res(spec: str) -> dict:
    """'512:16,1024:8' -> {512: 16, 1024: 8}; SystemExit on malformed input."""
    out = {}
    for pair in filter(None, spec.split(",")):
        res_s, _, b_s = pair.partition(":")
        try:
            out[int(res_s)] = int(b_s)
        except ValueError:
            raise SystemExit(f"--batch-by-res: bad entry {pair!r} (want RES:BATCH)")
    return out


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--final-resolution", type=int, default=1024)
    p.add_argument("--images-per-phase", type=int, default=600_000)
    p.add_argument("--width-mul", type=float, default=1.0)
    p.add_argument("--z-dim", type=int, default=512)
    p.add_argument("--steps-per-phase", type=int, default=0,
                   help="override phase length in steps (smoke runs)")
    p.add_argument("--fused-from", type=int, default=128,
                   help="fused conv+downscale D blocks (Karras fused_scale) "
                        "at resolutions >= this (0=off)")
    p.add_argument("--batch-by-res", type=str, default="",
                   help="override entries of the Karras per-resolution batch "
                        "schedule, e.g. '512:16,1024:8'; the generic "
                        "--batch-size flag is NOT used by the ladder")
    p.set_defaults(lr=1e-3, data="fake")
    args = p.parse_args(argv)
    if args.data != "fake":
        raise SystemExit(f"--data {args.data}: the ladder trains on 'fake' only; the "
                         f"multi-resolution real sources are ROADMAP.md Queue 1 item 8")
    return args


def ladder_config(args) -> LadderConfig:
    cfg = LadderConfig(
        final_resolution=args.final_resolution,
        images_per_phase=args.images_per_phase, lr=args.lr,
        width_mul=args.width_mul, z_dim=args.z_dim,
        compute_dtype=common.compute_dtype(args), seed=args.seed,
        out_dir=args.out_dir, log_every=args.log_every,
        sample_every=args.sample_every, checkpoint_every=args.ckpt_every,
        steps_per_phase=args.steps_per_phase or None,
        fused_from_resolution=args.fused_from, device=args.device)
    cfg.batch_by_res.update(parse_batch_by_res(args.batch_by_res))
    return cfg


def source_factory(args):
    """``--data fake``: blobs rendered on the device at each phase's own
    resolution, one class."""

    def make(res: int, batch: int):
        return DeviceFakeImages(batch_size=batch, image_size=res, num_classes=1,
                                seed=args.seed, n_micro=1, device=args.device)

    return make


def main(argv=None):
    args = parse_args(argv)
    return train_pggan_ladder(ladder_config(args), source_factory(args))


if __name__ == "__main__":
    main(sys.argv[1:])
