"""pix2pix entry point (port of ``gan_lib_tensorflow_tpu/cli/train_pix2pix.py``)
with the reference's three modes:

  train   U-Net G + PatchGAN D, cGAN + 100 L1, Adam(2e-4, 0.5, 0.999), batch 1,
          40,000 steps; checkpoints and auto-resume under --out-dir, input |
          output | target sample PNGs of a fixed pair
  test    restore the newest checkpoint, translate the test pass (dropout on,
          masks seeded by the example's index), write per-image PNGs,
          ``index.html`` and ``test_metrics.json`` (test_l1, n_examples, step)
  export  restore the newest checkpoint and write the serving bundle
          (``train/export.py``) under --out-dir/export

--data: 'auto'/'fake' (host-rendered synthetic pairs, the reference's numpy
renderer), 'fake-det' (colors a function of geometry), 'device-fake' /
'device-det' (the same pairs rendered on the device; train mode only, test
mode renders them on the host), a packed paired store
(``tools/prepack_dataset.py --paired``; held on the card when it fits
--device-cache-gb, else streamed), or a folder of combined A|B ``*.jpg`` /
``*.png`` images (facades style): decoded on the host by the port's own
JPEG/PNG decoder (``data/codec.py``) and jittered there as the reference
does, two ``ThreadedSource`` workers in train mode.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --data <store> \\
      --out-dir runs/facades
  python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --mode test \\
      --data facades/val --out-dir runs/facades
  python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --mode export \\
      --out-dir runs/facades
  python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --device cpu \\
      --data fake --image-size 32 --scale-size 32 --ngf 4 --ndf 4 --steps 2
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .. import data
from ..models import pix2pix
from ..parallel import is_writer
from ..train import (CheckpointManager, LoopConfig, create_state,
                     make_train_step, train_loop)
from ..train.export import write_serving_bundle
from ..utils import ScalarLogger, save_image_grid, write_gallery
from . import common

SYNTHETIC = ("auto", "fake", "fake-det", "device-fake", "device-det")
FIXED_POSITION = 2**31 - 1  # stream position of the fixed visualization pair


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--mode", default="train", choices=["train", "test", "export"])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--gan-weight", type=float, default=1.0)
    p.add_argument("--l1-weight", type=float, default=100.0)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--which-direction", default="AtoB", choices=["AtoB", "BtoA"])
    p.add_argument("--scale-size", type=int, default=286,
                   help="jitter: resize to this before random-cropping to "
                        "--image-size (a packed store fixes it when packed)")
    p.add_argument("--no-flip", action="store_true",
                   help="disable random horizontal flip augmentation")
    p.add_argument("--max-test-images", type=int, default=64)
    p.set_defaults(batch_size=1, steps=40_000)
    args = p.parse_args(argv)
    if args.scale_size < args.image_size:
        p.error(f"--scale-size {args.scale_size} must be >= --image-size "
                f"{args.image_size} (resize-then-crop jitter)")
    return args


def paired_source(args, threaded: bool = True, n_micro: int = 1, mesh=None):
    """The paired source of --data. ``threaded`` (train mode): device
    renderers and device-cached stores as they are (on ``mesh``: the rank's
    rows), host sources behind ``ThreadedSource`` (one worker, two for an
    image folder, as in the reference); otherwise the bare host source (test
    mode needs its deterministic ``eval_iter``)."""
    if args.data in SYNTHETIC:
        if args.data.startswith("device") and threaded:
            return data.DeviceFakePairedImages(
                batch_size=args.batch_size, image_size=args.image_size, seed=args.seed,
                n_micro=n_micro, deterministic_color=args.data == "device-det",
                device=args.device, mesh=mesh)
        base = data.FakePairedImages(batch_size=args.batch_size, image_size=args.image_size,
                                     seed=args.seed,
                                     deterministic_color=args.data.endswith("-det"))
    elif not os.path.isdir(args.data):
        raise FileNotFoundError(f"--data {args.data!r}: no such directory")
    elif not data.is_packed_dir(args.data):
        base = data.PairedImageFolder(
            args.data, batch_size=args.batch_size, image_size=args.image_size,
            scale_size=args.scale_size, which_direction=args.which_direction,
            flip=not args.no_flip, seed=args.seed)
        return data.ThreadedSource(base, num_workers=2) if threaded else base
    else:
        kw = dict(batch_size=args.batch_size, image_size=args.image_size,
                  which_direction=args.which_direction, flip=not args.no_flip,
                  seed=args.seed)
        if threaded:
            return data.packed_paired_training_source(
                args.data, n_micro=n_micro, device=args.device, mesh=mesh,
                **kw, **common.device_cache_kwargs(args))
        base = data.PackedPairedStore(args.data, **kw)
    return data.ThreadedSource(base, num_workers=1) if threaded else base


def build(args, mesh=None):
    """Networks, spec and train state on ``args.device`` (on ``mesh``)."""
    dtype = common.compute_dtype(args)
    g = pix2pix.UNetGenerator(args.image_size, args.ngf, compute_dtype=dtype)
    d = pix2pix.PatchGANDiscriminator(args.ndf, compute_dtype=dtype)
    spec = pix2pix.make_pix2pix_spec(g, d, gan_weight=args.gan_weight,
                                     l1_weight=args.l1_weight)
    state = create_state(g, d, lr=args.lr, beta1=args.beta1, beta2=0.999,
                         seed=args.seed, device=args.device, mesh=mesh)
    return g, d, spec, state


def _fixed_pair(args, source, device) -> dict:
    """The visualization pair: from the reserved stream position of a
    stacking source (the loop re-primes the position), else from an
    unthreaded twin, so it is a function of --seed alone."""
    if getattr(source, "yields_stacks", False):
        source.set_stream_position(FIXED_POSITION)
        return {k: v[0] for k, v in next(iter(source)).items()}
    first = next(iter(paired_source(args, threaded=False)))
    return {k: torch.from_numpy(v).to(device) for k, v in first.items()}


def train(args, g, spec, state, ckpt):
    device = next(g.parameters()).device
    source = paired_source(args, n_micro=spec.n_critic, mesh=state.mesh)
    fixed = _fixed_pair(args, source, device)
    translator = pix2pix.make_translator(g)

    logger = ScalarLogger(args.out_dir if is_writer() else None, curves=args.curves,
                          tensorboard=args.tensorboard)

    def sample_fn(st, it: int) -> None:
        out = translator(fixed["input"], torch.Generator(device=device).manual_seed(0))
        trip = torch.cat([fixed["input"], out, fixed["target"]], dim=2)
        save_image_grid(trip.cpu().numpy(), os.path.join(args.out_dir, "samples",
                                                         f"{it:06d}.png"), rows=len(trip))
        # the reference's TensorBoard images of the fixed triple (train_pix2pix.py:170-173)
        for tag, images in (("inputs", fixed["input"]), ("outputs", out),
                            ("targets", fixed["target"])):
            logger.log_images(it, tag, images.cpu().numpy())

    cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                     sample_every=args.sample_every, checkpoint_every=args.ckpt_every,
                     out_dir=args.out_dir, fault_inject_step=args.fault_inject_step,
                     trace_steps=args.trace_steps)
    return train_loop(state, make_train_step(spec), source, cfg, sample_fn=sample_fn,
                      ckpt=ckpt, logger=logger, n_micro=spec.n_critic)


def test(args, g, state) -> dict:
    device = next(g.parameters()).device
    source = paired_source(args, threaded=False)
    examples = source.eval_iter() if hasattr(source, "eval_iter") else iter(source)
    translator = pix2pix.make_translator(g)
    rows, l1_sum, l1_n = [], 0.0, 0
    for i, ex in enumerate(examples):
        if i >= args.max_test_images:
            break
        out = translator(torch.from_numpy(ex["input"]).to(device),
                         torch.Generator(device=device).manual_seed(i)).cpu().numpy()
        l1_sum += float(np.abs(out - ex["target"]).mean())
        l1_n += 1
        name = ex.get("name", f"{i:05d}")
        row = {"name": name}
        for kind, arr in (("input", ex["input"]), ("output", out), ("target", ex["target"])):
            fn = f"{name}-{kind}.png"
            save_image_grid(arr[:1], os.path.join(args.out_dir, "images", fn))
            row[kind] = f"images/{fn}"
        rows.append(row)
    path = write_gallery(args.out_dir, rows)
    # the test-set L1 on the [-1, 1] scale of the training g_l1 term
    metrics = {"test_l1": l1_sum / max(l1_n, 1), "n_examples": l1_n, "step": int(state.step)}
    with open(os.path.join(args.out_dir, "test_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(f"wrote {len(rows)} examples to {path}; test L1 {metrics['test_l1']:.4f}",
          flush=True)
    return metrics


def export(args, g, state) -> str:
    """The bundle of G with its dropout masks drawn from a generator seeded
    0 on G's device (the reference's fixed ``PRNGKey(0)``)."""
    device = next(g.parameters()).device
    masks = g.draw_masks(1, torch.Generator(device=device).manual_seed(0))
    s = args.image_size
    return write_serving_bundle(os.path.join(args.out_dir, "export"), state.step,
                                {"g": g.state_dict()}, pix2pix.FixedMaskTranslator(g, masks),
                                torch.zeros(1, s, s, 3, device=device))


def main(argv=None):
    """Returns the trained state (train), the test metrics (test) or the
    bundle's ``generator.pt2`` path (export). Test and export are one
    process's work: under more than one rank only rank 0 does it."""
    args = parse_args(argv)
    common.configure(args)
    if args.mode != "train" and int(os.environ.get("RANK", 0)) != 0:
        return None
    mesh = common.maybe_mesh(args) if args.mode == "train" else None
    g, _, spec, state = build(args, mesh)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    try:
        if args.mode == "train":
            return train(args, g, spec, state, ckpt)
        if ckpt.restore_latest(state) is not None:
            print(f"restored step {state.step}", flush=True)
        return (test if args.mode == "test" else export)(args, g, state)
    finally:
        ckpt.close()


if __name__ == "__main__":
    main(sys.argv[1:])
