"""Evaluation entry point (port of ``gan_lib_tensorflow_tpu/cli/evaluate.py``):
restore the newest checkpoint and print one JSON line. ``--model sngan``,
``imagenet``, ``acgan``: generate ``--n-samples`` samples (EMA parameters
when the checkpoint has them; a conditional G cycles its classes), IS over
10 splits and FID against the real moments. ``--model pggan``: Karras's
MS-SSIM diversity over generated pairs, and SWD per Laplacian-pyramid level
against reals when --data resolves to them (a pyramid or single packed
store of --resolution, or 'device-rich'/'device-fake' rendered on the card;
'auto' gives MS-SSIM alone; an image folder is refused: pack it first).

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model sngan \\
      --ckpt-dir runs/out/ckpt --n-samples 50000 --data cifar10 \\
      [--inception-weights inception_v3.npz] [--real-stats-npz stats.npz]
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model sngan_imagenet \\
      --ckpt-dir runs/imagenet/ckpt --data runs/imagenet128_store
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model acgan \\
      --ckpt-dir runs/acgan/ckpt --n-samples 10000
  python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model pggan \\
      --ckpt-dir runs/pggan/1024x1024_stabilize/ckpt --resolution 1024 \\
      --data <pyramid store> [--swd-samples 16384]

Under ``torchrun --nproc_per_node R`` the IS/FID eval is data parallel:
every rank generates and featurizes its rows of each batch (and of the
real batches), the sums are all-reduced, and rank 0 prints the one-rank
record. The PGGAN eval is one process's work: rank 0 alone runs it.

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
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, resolve_device
from ..eval import compute_statistics, evaluate_generator, perceptual
from ..eval.inception_v3 import InceptionV3Features
from ..models import acgan, pggan, sngan
from ..parallel import is_writer, prefetch_to_device, shard_batch
from ..train import CheckpointManager, eval_state_from_raw
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="sngan",
                   choices=["sngan", "imagenet", "sngan_imagenet", "acgan", "pggan"])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--data", default="auto",
                   help="real-data source for FID: 'auto' (CIFAR-10 when found "
                        "and the model is 32^2, else 'fake'), 'cifar10', "
                        "'fake' / 'fake-rich' (synthetic blobs rendered on the "
                        "host), 'device-fake' / 'device-rich' (rendered on the "
                        "device), or a PATH (packed store, or a CIFAR-10 "
                        "directory at 32^2); "
                        "for SWD (pggan): a pyramid or packed store, "
                        "'device-rich' or 'device-fake'")
    p.add_argument("--n-real", type=int, default=10_000)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--real-stats-npz", default=None,
                   help="cache file for real moments: saved on first run, "
                        "loaded (real pass skipped) thereafter")
    p.add_argument("--num-classes", type=int, default=0,
                   help="sngan: classes of the conditional G (0 = unconditional); "
                        "imagenet: its classes (0 = 1000)")
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="pggan/imagenet: the channel-width multiplier it was trained with")
    p.add_argument("--resolution", type=int, default=64, help="pggan only")
    p.add_argument("--swd-samples", type=int, default=None,
                   help="pggan only: images per side for SWD (default "
                        "n_samples//10; Karras scale = 16384)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-json", default=None,
                   help="also write the result record to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    p.add_argument("--no-mesh", action="store_true",
                   help="one device, no mesh (refused under more than one rank)")
    args = p.parse_args(argv)
    if args.model == "pggan":
        common.refuse_image_folder(p, args.data, "--resolutions",
                                   [f"r{args.resolution:04d}"])
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.model == "sngan_imagenet":  # cli.sample's name for the family
        args.model = "imagenet"
    if args.model == "pggan":
        if int(os.environ.get("RANK", 0)) != 0:
            return {}
        out = eval_pggan(args)
    else:
        out = eval_is_fid(args, common.maybe_mesh(args))
        if not is_writer():
            return out
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


def real_moments(args, net, image_size: int = 32, mesh=None):
    """Real-data (mu, cov) and the source's name, cached in
    ``--real-stats-npz``. A cache records its extractor; loading it under
    another is refused, since FID moments do not compare across extractors.
    On a ``mesh`` each rank featurizes its rows; rank 0 writes the cache."""
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
        net.feature_dim, mesh=mesh)
    if cache and is_writer():
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
        return (b["image"] for b in prefetch_to_device(iter(src), device))

    if args.data == "cifar10" and image_size != 32:
        raise ValueError(f"--data cifar10 is 32^2 but --model {args.model} generates "
                         f"{image_size}^2; point --data at a matching real source")
    if args.data in ("auto", "cifar10") and image_size == 32:
        try:
            return host(data.Cifar10(batch_size=bs, seed=args.seed)), "cifar10"
        except FileNotFoundError:
            if args.data == "cifar10":
                raise
    if args.data in ("auto", "fake", "fake-rich"):
        # the reference's host renderer, one stream (evaluate.py:102-104, 116-119)
        fake = data.FakeImages(batch_size=bs, image_size=image_size, seed=args.seed,
                               style="rich" if args.data == "fake-rich" else "blobs")
        return host(fake), "synthetic"
    if args.data in ("device-fake", "device-rich"):
        fake = data.DeviceFakeImages(
            batch_size=bs, image_size=image_size, num_classes=10, seed=args.seed,
            style="rich" if args.data == "device-rich" else "blobs", device=device)
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
    return host(src), args.data


def _restore(args, dev):
    raw = CheckpointManager(args.ckpt_dir).restore_latest_raw(map_location=dev)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
    return eval_state_from_raw(raw)


def eval_is_fid(args, mesh=None) -> dict:
    dev = resolve_device(args.device)
    state = _restore(args, dev)
    net = InceptionV3Features(params_npz=args.inception_weights, device=dev)
    # a conditional G's samples cycle its classes (reference evaluate.py:180-196)
    if args.model == "imagenet":
        g = sngan.imagenet128_generator(num_classes=args.num_classes or 1000,
                                        width_mul=args.width_mul)
        image_size, make_sampler = 128, sngan.make_sampler
    elif args.model == "acgan":
        g, image_size, make_sampler = acgan.ACGANGenerator(), 32, acgan.make_sampler
    else:
        g = sngan.cifar_generator(num_classes=args.num_classes)
        image_size, make_sampler = 32, sngan.make_sampler
    g.load_state_dict(state.g)
    g.to(dev)
    sampler = make_sampler(g)
    real_stats, real_source = real_moments(args, net, image_size, mesh)

    def sample_batch(gen: torch.Generator) -> torch.Tensor:
        z = shard_batch(torch.randn(args.batch_size, g.z_dim, generator=gen), mesh)
        return sampler(state, z.to(dev))

    out = evaluate_generator(
        sample_batch, net, net.feature_dim, n_samples=args.n_samples,
        batch_size=args.batch_size,
        generator=torch.Generator().manual_seed(args.seed + 1),
        real_stats=real_stats, mesh=mesh)
    out["step"] = state.step
    out["extractor"] = _extractor_name(args)
    out["real_source"] = real_source
    return out


def eval_pggan(args) -> dict:
    """Karras's PGGAN eval (reference ``evaluate.py:217-289``): MS-SSIM over
    ``max(n_samples // 10, bs)`` generated pairs, then SWD per pyramid level
    against ``--swd-samples`` reals when --data resolves to them. G is built
    as the reference's sampler builds it, without the fade-in
    (``pggan.sampling_state``)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = pggan.sampling_state(_restore(args, dev), args.resolution)
    g = pggan.PGGANGenerator(resolution=args.resolution, width_mul=args.width_mul,
                             z_dim=state.g["dense_4.weight"].shape[1])
    g.load_state_dict(state.g)
    g.to(dev)
    sampler = pggan.make_sampler(g)
    bs = min(args.batch_size, 16)

    def sample_fn(gen: torch.Generator, n: int):
        return lambda: sampler(state, torch.randn(n, g.z_dim, generator=gen).to(dev))

    n_pairs = max(args.n_samples // 10, bs)
    with record_function("pggan_eval.ms_ssim"):
        ms_mean, ms_std = perceptual.ms_ssim_diversity(
            sample_fn(torch.Generator().manual_seed(args.seed), 2 * bs), n_pairs,
            batch_size=bs)
    out = {"ms_ssim": ms_mean, "ms_ssim_std": ms_std,
           "ms_ssim_pairs": (n_pairs // bs) * bs,
           "step": state.step, "resolution": args.resolution}

    real = None
    if os.path.isdir(args.data):
        store = data.open_pyramid(args.data, batch_size=bs, resolution=args.resolution,
                                  seed=args.seed, wire_dtype="uint8")
        real = (b["image"] for b in prefetch_to_device(iter(store), dev))
    elif args.data in ("device-rich", "device-fake"):
        # reals rendered on the card at the eval's resolution: a 16,384-image
        # real side at 1024^2 would be a 51 GB store
        render = data.DeviceFakeImages(
            batch_size=bs, image_size=args.resolution, num_classes=1, seed=args.seed,
            style="rich" if args.data == "device-rich" else "blobs", device=dev)
        real = (b["image"][0] for b in render)
    elif args.data != "auto":
        print(f"note: --data {args.data!r} is not a directory; skipping SWD "
              "(MS-SSIM only)", flush=True)
    if real is not None:
        n_b = max((args.swd_samples or max(args.n_samples // 10, bs)) // bs, 1)
        # the fakes one batch at a time: held all at once, 16,384 of them at
        # 1024^2 would be 206 GB
        fake = sample_fn(torch.Generator().manual_seed(args.seed + 1), bs)
        t0 = time.perf_counter()
        out.update(perceptual.swd_pyramid(_in_range("swd.reals", lambda: next(real), n_b),
                                          _in_range("swd.fakes", fake, n_b),
                                          resolution=args.resolution, seed=args.seed))
        out["swd_images"] = n_b * bs
        out["swd_seconds"] = round(time.perf_counter() - t0, 2)
        if dev.type == "cuda":
            out["swd_peak_hbm_gb"] = round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
    return out


def _in_range(name: str, make, n: int):
    """``n`` results of ``make()``, each made inside the profiler range
    ``name`` (the range closes before the consumer takes the result)."""
    for _ in range(n):
        with record_function(name):
            x = make()
        yield x


if __name__ == "__main__":
    main(sys.argv[1:])
