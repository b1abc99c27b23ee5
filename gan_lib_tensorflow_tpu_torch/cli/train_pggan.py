"""PGGAN entry point: the progressive ladder 4x4 -> --final-resolution (port
of ``gan_lib_tensorflow_tpu/cli/train_pggan.py``; WGAN-GP + drift,
Adam(1e-3, 0, 0.99), G EMA 0.999, a transition (fade-in) and a stabilize
phase per level, fused_scale D blocks from 128x128, each stage's top level
on the space-to-depth grid from 512x512: --s2d-from 512, the reference's
default).

--data, each phase's reals at its own resolution (reference ``:103-155``):
'auto'/'fake' (one-class blobs rendered on the host, the reference's numpy
renderer, behind a ``ThreadedSource`` of two workers whose batches come in a
fixed order, so that every rank reads the same global batches), 'fake-rich' (the same,
``rich`` style), 'device-fake'/'device-rich' (rendered on the device), or a
packed pyramid store (``tools/prepack_dataset.py --resolutions``, or
``data.write_pyramid``): each phase reads its ``r{res:04d}/`` member, held on
the card when it fits --device-cache-gb, else streamed as uint8; or a flat
folder of JPEG/PNG images (CelebA-HQ style): each phase decodes them on the
host with ``data/codec.py`` at --final-resolution (center crop, bilinear
resize) and box-downsamples them to its own resolution
(``MultiResolution``), two ``ThreadedSource`` workers; pack large folders
with ``tools/prepack_dataset --resolutions`` for the reference's rates.

Usage: python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --data <pyramid> \\
           --out-dir runs/pggan [--remat-from 512]
       python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --data device-rich \\
           --steps-per-phase 2
       torchrun --nproc_per_node 2 -m gan_lib_tensorflow_tpu_torch.cli.train_pggan \
           --data device-fake (data parallel: each rank trains on its rows)
       torchrun --nproc_per_node 4 -m gan_lib_tensorflow_tpu_torch.cli.train_pggan \
           --data device-fake --sp-shards 2 (DP x SP 2 x 2: each 'sp' rank holds
           half the height of every level from 8 * 2 rows up)
(one directory per phase under --out-dir: checkpoints, sample grids, log.jsonl;
a re-run with the same --out-dir resumes every phase)
"""

from __future__ import annotations

import os
import sys

from .. import data
from ..parallel.sharding import spatial_axis_of
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
        "'fake-rich', 'device-fake'/'device-rich' (rendered on the device), "
        "a packed pyramid store, or a flat folder of images"))
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
    p.add_argument("--s2d-from", type=int, default=512,
                   help="compute each ladder stage's own top level on the "
                        "space-to-depth grid when it is at or above this "
                        "resolution (ops/s2d.py): the same function as the "
                        "fused_scale levels and the same parameters. 0=off")
    p.add_argument("--fused-from", type=int, default=128,
                   help="fused conv+downscale D blocks (Karras fused_scale) "
                        "at resolutions >= this (0=off)")
    p.add_argument("--sp-shards", type=int, default=1,
                   help="spatial partitioning: shard the image height over this "
                        "many ranks (the 'sp' axis; the ranks split as data = "
                        "world / sp, sp). A power of two: a level of H >= 4 * sp "
                        "rows holds H / sp rows per rank, and the smaller ones "
                        "stay whole on every rank (a ladder that ends below "
                        "4 * sp shards no level). The reference's GSPMD mesh "
                        "takes any sp that divides the device count, but its "
                        "batches then need 4 (the first level) divisible by sp")
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
    sp = args.sp_shards
    if sp < 1 or sp & (sp - 1):
        # a sharded level's rows must split into shards of an even number of
        # rows, each starting on an even row (the pool, the fused downscale
        # and the space-to-depth grid read pixel pairs)
        p.error(f"--sp-shards {sp}: a power of two is needed, so that every sharded "
                "level splits into even shards of 4 rows or more")
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
        remat_from_resolution=args.remat_from, s2d_from_resolution=args.s2d_from,
        device=args.device,
        mesh=mesh, trace_steps=args.trace_steps, curves=args.curves,
        tensorboard=args.tensorboard)
    cfg.batch_by_res.update(parse_batch_by_res(args.batch_by_res))
    return cfg


def source_factory(args, mesh=None):
    """``make(resolution, batch)``: the reals of one phase, as --data says
    (a device source on ``mesh`` yields the rank's rows, and its height rows
    over an 'sp' axis)."""
    spatial = spatial_axis_of(mesh)
    if args.data in ("device-fake", "device-rich"):
        def make(res: int, batch: int):
            return data.DeviceFakeImages(
                batch_size=batch, image_size=res, num_classes=1, seed=args.seed,
                n_micro=1, style="rich" if args.data == "device-rich" else "blobs",
                device=args.device, mesh=mesh, spatial_axis=spatial)
    elif args.data in SYNTHETIC:
        def make(res: int, batch: int):
            # rendered at the phase's own resolution, not downsampled from
            # the top one; the workers' batches come in a fixed order, so on
            # a mesh every rank cuts its rows from the same global batch
            return data.ThreadedSource(data.FakeImages(
                batch_size=batch, image_size=res, num_classes=1, seed=args.seed,
                style="rich" if args.data == "fake-rich" else "blobs"))
    elif not os.path.isdir(args.data):
        raise FileNotFoundError(f"--data {args.data!r}: no such directory")
    elif not (data.is_packed_dir(args.data) or data.is_packed_dir(
            os.path.join(args.data, f"r{args.final_resolution:04d}"))):
        def make(res: int, batch: int):
            # decoded at the final resolution, box-downsampled to the phase's
            # (reference cli/train_pggan.py:123-132)
            base = data.ImageFolderFlat(args.data, batch_size=batch,
                                        image_size=args.final_resolution, seed=args.seed)
            return data.ThreadedSource(data.MultiResolution(
                base=base, batch_size=batch, max_resolution=args.final_resolution,
                resolution=res))
    else:
        def make(res: int, batch: int):
            return data.packed_training_source(
                data.resolve_pyramid_dir(args.data, res), batch_size=batch, n_micro=1,
                seed=args.seed, device=args.device, mesh=mesh, spatial_axis=spatial,
                **common.device_cache_kwargs(args))
    return make


def main(argv=None):
    args = parse_args(argv)
    common.configure(args)
    mesh = common.maybe_mesh(args)
    return train_pggan_ladder(ladder_config(args, mesh), source_factory(args, mesh))


if __name__ == "__main__":
    main(sys.argv[1:])
