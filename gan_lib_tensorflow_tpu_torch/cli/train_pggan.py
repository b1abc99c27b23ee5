"""PGGAN entry point: the progressive ladder 4x4 -> --final-resolution (port
of ``gan_lib_tensorflow_tpu/cli/train_pggan.py``; WGAN-GP + drift,
Adam(1e-3, 0, 0.99), G EMA 0.999, a transition (fade-in) and a stabilize
phase per level, fused_scale D blocks from 128x128).

--data, each phase's reals at its own resolution (reference ``:103-155``):
'auto'/'fake' (one-class blobs rendered on the host, the reference's numpy
renderer, behind a ``ThreadedSource``: two workers, or one on a mesh, so
that every rank reads the same global batches), 'fake-rich' (the same,
``rich`` style), 'device-fake'/'device-rich' (rendered on the device), or a
packed pyramid store (``tools/prepack_dataset.py --resolutions``, or
``data.write_pyramid``): each phase reads its ``r{res:04d}/`` member, held on
the card when it fits --device-cache-gb, else streamed as uint8. Image
folders, which the reference decodes with Pillow, are not read here: pack
them first.

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --data <pyramid> \\
           --out-dir runs/pggan [--remat-from 512]
       python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --data device-rich \\
           --steps-per-phase 2
       torchrun --nproc_per_node 2 -m gan_lib_tensorflow_tpu_torch.cli.train_pggan \
           --data device-fake (data parallel: each rank trains on its rows)
(one directory per phase under --out-dir: checkpoints, sample grids, log.jsonl;
a re-run with the same --out-dir resumes every phase)
"""

from __future__ import annotations

import os
import sys

from .. import data
from ..train.pggan_loop import LadderConfig, train_pggan_ladder
from . import common

SYNTHETIC = ("auto", "fake", "fake-rich", "device-fake", "device-rich")


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
    p = common.base_parser(__doc__, data_help=(
        "each phase's reals: 'auto'/'fake' (blobs rendered on the host), "
        "'fake-rich', 'device-fake'/'device-rich' (rendered on the device), or "
        "a packed pyramid store"))
    p.add_argument("--final-resolution", type=int, default=1024)
    p.add_argument("--images-per-phase", type=int, default=600_000)
    p.add_argument("--width-mul", type=float, default=1.0)
    p.add_argument("--z-dim", type=int, default=512)
    p.add_argument("--steps-per-phase", type=int, default=0,
                   help="override phase length in steps (smoke runs)")
    p.add_argument("--remat-from", type=int, default=0,
                   help="rematerialize the G and D level blocks at resolutions "
                        ">= this (0=off): less activation memory, the same "
                        "function and parameters")
    p.add_argument("--fused-from", type=int, default=128,
                   help="fused conv+downscale D blocks (Karras fused_scale) "
                        "at resolutions >= this (0=off)")
    p.add_argument("--sp-shards", type=int, default=1,
                   help="spatial ('sp' axis) shards of the image height; only 1 "
                        "is supported in this package so far")
    p.add_argument("--batch-by-res", type=str, default="",
                   help="override entries of the Karras per-resolution batch "
                        "schedule, e.g. '512:16,1024:8'; the generic "
                        "--batch-size flag is NOT used by the ladder")
    p.set_defaults(lr=1e-3)
    args = p.parse_args(argv)
    if args.tp_shards > 1:
        # the reference refuses it too (train_pggan.py:85-92): PGGAN's memory
        # is activations, not parameters
        raise SystemExit("--tp-shards is not supported by the PGGAN ladder; "
                         "use data parallelism (torchrun) instead")
    if args.sp_shards != 1:
        raise SystemExit(f"--sp-shards {args.sp_shards}: spatial sharding is not "
                         "ported yet; only --sp-shards 1 runs")
    if args.data not in SYNTHETIC:
        common.refuse_image_folder(p, args.data, "--resolutions",
                                   [f"r{args.final_resolution:04d}"])
    return args


def ladder_config(args, mesh=None) -> LadderConfig:
    cfg = LadderConfig(
        final_resolution=args.final_resolution,
        images_per_phase=args.images_per_phase, lr=args.lr,
        width_mul=args.width_mul, z_dim=args.z_dim,
        compute_dtype=common.compute_dtype(args), seed=args.seed,
        out_dir=args.out_dir, log_every=args.log_every,
        sample_every=args.sample_every, checkpoint_every=args.ckpt_every,
        steps_per_phase=args.steps_per_phase or None,
        fused_from_resolution=args.fused_from,
        remat_from_resolution=args.remat_from, device=args.device,
        mesh=mesh, trace_steps=args.trace_steps)
    cfg.batch_by_res.update(parse_batch_by_res(args.batch_by_res))
    return cfg


def source_factory(args, mesh=None):
    """``make(resolution, batch)``: the reals of one phase, as --data says
    (a device source on ``mesh`` yields the rank's rows)."""
    if args.data in ("device-fake", "device-rich"):
        def make(res: int, batch: int):
            return data.DeviceFakeImages(
                batch_size=batch, image_size=res, num_classes=1, seed=args.seed,
                n_micro=1, style="rich" if args.data == "device-rich" else "blobs",
                device=args.device, mesh=mesh)
    elif args.data in SYNTHETIC:
        def make(res: int, batch: int):
            # rendered at the phase's own resolution, not downsampled from
            # the top one; on a mesh by one worker, whose batches come in a
            # fixed order, so every rank cuts its rows from the same global
            # batch (two workers' batches arrive in either order)
            return data.ThreadedSource(data.FakeImages(
                batch_size=batch, image_size=res, num_classes=1, seed=args.seed,
                style="rich" if args.data == "fake-rich" else "blobs"),
                num_workers=1 if mesh is not None else 2)
    elif not os.path.isdir(args.data):
        raise FileNotFoundError(f"--data {args.data!r}: no such directory")
    else:
        def make(res: int, batch: int):
            return data.packed_training_source(
                data.resolve_pyramid_dir(args.data, res), batch_size=batch, n_micro=1,
                seed=args.seed, device=args.device, mesh=mesh,
                **common.device_cache_kwargs(args))
    return make


def main(argv=None):
    args = parse_args(argv)
    common.configure(args)
    mesh = common.maybe_mesh(args)
    return train_pggan_ladder(ladder_config(args, mesh), source_factory(args, mesh))


if __name__ == "__main__":
    main(sys.argv[1:])
