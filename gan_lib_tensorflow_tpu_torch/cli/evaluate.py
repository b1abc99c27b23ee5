"""IS/FID evaluation entry point (port of the ``--model sngan`` and
``--model imagenet`` branches of ``gan_lib_tensorflow_tpu/cli/evaluate.py``):
restore the newest checkpoint, generate ``--n-samples`` EMA samples (the
SNGAN-projection G cycles its classes), IS over 10 splits and FID against
the real moments; prints one JSON line.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model sngan \\
      --ckpt-dir runs/out/ckpt --n-samples 50000 --data cifar10 \\
      [--inception-weights inception_v3.npz] [--real-stats-npz stats.npz]
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model sngan_imagenet \\
      --ckpt-dir runs/imagenet/ckpt --data runs/imagenet128_store

Without --inception-weights a seed-fixed random-init InceptionV3 is used:
comparisons across checkpoints of one run hold, absolute values are not
Inception-comparable. ``--real-stats-npz PATH`` caches the real moments:
computed and saved when PATH is missing, loaded (no real pass) when present;
a cache made by another extractor is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import data, resolve_device
from ..eval import compute_statistics, evaluate_generator
from ..eval.inception_v3 import InceptionV3Features
from ..models import sngan
from ..parallel import prefetch_to_device
from ..train import CheckpointManager, eval_state_from_raw

# the reference's other families, and the ROADMAP.md item that ports each
_NOT_PORTED = {
    "acgan": "Queue 1 item 6 (ACGAN)",
    "pggan": "Queue 1 item 8 (PGGAN's SWD and MS-SSIM)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="sngan",
                   choices=["sngan", "imagenet", "sngan_imagenet", *_NOT_PORTED])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--data", default="auto",
                   help="real-data source for FID: 'auto' (CIFAR-10 when found "
                        "and the model is 32^2, else synthetic), 'cifar10', "
                        "'fake' (synthetic blobs rendered on the device), or a "
                        "PATH (packed store, or a CIFAR-10 directory at 32^2)")
    p.add_argument("--n-real", type=int, default=10_000)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--real-stats-npz", default=None,
                   help="cache file for real moments: saved on first run, "
                        "loaded (real pass skipped) thereafter")
    p.add_argument("--num-classes", type=int, default=0,
                   help="imagenet: classes of the conditional G (0 = 1000)")
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="imagenet: the channel-width multiplier it was trained with")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-json", default=None,
                   help="also write the result record to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.model == "sngan_imagenet":  # cli.sample's name for the family
        args.model = "imagenet"
    if args.model in _NOT_PORTED:
        raise SystemExit(f"--model {args.model}: eval of this family is not ported "
                         f"yet; ROADMAP.md {_NOT_PORTED[args.model]} brings it")
    out = eval_is_fid(args)
    line = json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in out.items()})
    print(line, flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(line + "\n")
    return out


def _extractor_name(args) -> str:
    return ("inception_v3_pretrained" if args.inception_weights
            else "inception_v3_random_init")


def real_moments(args, net, image_size: int = 32):
    """Real-data (mu, cov) and the source's name, cached in
    ``--real-stats-npz``. A cache records its extractor; loading it under
    another is refused, since FID moments do not compare across extractors."""
    cache = args.real_stats_npz
    if cache and os.path.exists(cache):
        d = np.load(cache)
        have = str(d["extractor"])
        if have != _extractor_name(args):
            raise ValueError(
                f"--real-stats-npz {cache}: cached moments were computed with "
                f"{have} but this run uses {_extractor_name(args)}; delete the "
                f"cache or pass a different path")
        if int(d["n_real"]) != args.n_real:
            print(f"note: {cache} was computed with n_real={int(d['n_real'])}",
                  flush=True)
        print(f"loaded cached real moments from {cache}", flush=True)
        return (d["mu"], d["cov"]), str(d["source"])
    if args.n_real < args.batch_size:
        raise ValueError(f"--n-real {args.n_real} < --batch-size {args.batch_size}: "
                         f"zero real batches would be accumulated")
    batches, source = real_image_batches(args, args.device, image_size)
    mu, cov = compute_statistics(
        net, (next(batches) for _ in range(args.n_real // args.batch_size)),
        net.feature_dim)
    if cache:
        np.savez(cache, mu=mu, cov=cov, n_real=args.n_real, source=source,
                 extractor=_extractor_name(args))
        print(f"cached real moments to {cache}", flush=True)
    return (mu, cov), source


def real_image_batches(args, device, image_size: int):
    """Resolve --data for the real moments: (an iterator of normalized
    ``[batch, S, S, 3]`` batches on ``device``, the source's name). An
    explicit source that does not resolve raises; only 'auto' falls back to
    synthetic data."""
    bs = args.batch_size

    def host(src):
        return prefetch_to_device(iter(src), device)

    if args.data == "cifar10" and image_size != 32:
        raise ValueError(f"--data cifar10 is 32^2 but --model {args.model} generates "
                         f"{image_size}^2; point --data at a matching real source")
    if args.data in ("auto", "cifar10") and image_size == 32:
        try:
            return host(data.Cifar10(batch_size=bs, seed=args.seed)), "cifar10"
        except FileNotFoundError:
            if args.data == "cifar10":
                raise
    if args.data in ("auto", "fake"):
        fake = data.DeviceFakeImages(batch_size=bs, image_size=image_size,
                                     num_classes=10, seed=args.seed, device=device)
        return (b["image"][0] for b in fake), "synthetic"
    if not os.path.isdir(args.data):
        raise FileNotFoundError(f"--data {args.data!r}: no such directory")
    if data.is_packed_dir(args.data):
        src = data.PackedImageStore(args.data, batch_size=bs, seed=args.seed,
                                    wire_dtype="uint8")
        if src.image_size != image_size:
            raise ValueError(f"--data {args.data}: packed store is {src.image_size}^2 "
                             f"but --model {args.model} generates {image_size}^2")
    elif image_size == 32 and os.path.isfile(os.path.join(args.data, "data_batch_1")):
        src = data.Cifar10(batch_size=bs, data_dir=args.data, seed=args.seed)
    else:
        raise FileNotFoundError(f"--data {args.data}: neither a packed store nor, at "
                                f"32^2, a CIFAR-10 directory")
    return (b["image"] for b in host(src)), args.data


def eval_is_fid(args) -> dict:
    dev = resolve_device(args.device)
    raw = CheckpointManager(args.ckpt_dir).restore_latest_raw(map_location=dev)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
    state = eval_state_from_raw(raw)
    net = InceptionV3Features(params_npz=args.inception_weights, device=dev)
    if args.model == "imagenet":
        # class-conditional samples cycling the label set (reference
        # evaluate.py:185-190)
        g = sngan.imagenet128_generator(num_classes=args.num_classes or 1000,
                                        width_mul=args.width_mul)
        image_size = 128
    else:
        g = sngan.cifar_generator()
        image_size = 32
    g.load_state_dict(state.g)
    g.to(dev)
    sampler = sngan.make_sampler(g)
    real_stats, real_source = real_moments(args, net, image_size)

    def sample_batch(gen: torch.Generator) -> torch.Tensor:
        z = torch.randn(args.batch_size, g.z_dim, generator=gen)
        return sampler(state, z.to(dev))

    out = evaluate_generator(
        sample_batch, net, net.feature_dim, n_samples=args.n_samples,
        batch_size=args.batch_size,
        generator=torch.Generator().manual_seed(args.seed + 1),
        real_stats=real_stats)
    out["step"] = state.step
    out["extractor"] = _extractor_name(args)
    out["real_source"] = real_source
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
