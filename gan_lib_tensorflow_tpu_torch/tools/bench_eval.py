"""IS/FID eval wall clock (port of ``tools/bench_eval.py``): the statistics
accumulated on the device against the host path, over the same SNGAN
CIFAR-10 generator (EMA sampler) and InceptionV3 forward:

  device  ``DeviceEvalAccumulator``: the features stay on the device, the
          FID sums and IS split sums are added there, one transfer at the end
  host    every batch's 2048-d features and softmax copied to the host, the
          FID sums in float64 numpy (``MomentAccumulator``), IS from the
          gathered probabilities (``inception_score_from_probs``)

One JSON line per mode: ``mode, n_samples, wall_s, samples_per_s, is,
trace_cov`` and the card. The extractor is the seed-fixed random-init
InceptionV3, as in the reference tool.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.bench_eval --n-samples 50000 [--mode both]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..eval.inception_v3 import InceptionV3Features
from ..eval.metrics import (DeviceEvalAccumulator, MomentAccumulator,
                            inception_score_from_probs)
from ..models import sngan
from ..train import create_state
from ..utils.profiler import hard_sync
from . import harness

SPLITS = 10


def run(mode: str, n_samples: int, batch_size: int, device) -> dict:
    dev = resolve_device(device)
    g, d = sngan.cifar_generator(), sngan.cifar_discriminator()
    state = create_state(g, d, ema_decay=0.9999, device=dev)
    sampler = sngan.make_sampler(g)
    net = InceptionV3Features(device=dev)
    n_batches = n_samples // batch_size
    is_n = (n_batches * batch_size // SPLITS) * SPLITS
    gen = torch.Generator(device=dev).manual_seed(1)

    def images() -> torch.Tensor:
        return sampler(state, torch.randn(batch_size, g.z_dim, device=dev, generator=gen))

    if mode == "device":
        acc = DeviceEvalAccumulator(net, net.feature_dim, splits=SPLITS,
                                    split_size=is_n // SPLITS)
        net(images())  # warm-up, outside the sums
        hard_sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            acc.add_images(images())
        mu, cov = acc.moments()
        is_mean, _ = acc.inception_score()
    else:
        acc, probs = MomentAccumulator(net.feature_dim), []
        net(images())
        hard_sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            feats, logits = net(images())
            acc.update(feats.cpu().numpy())
            probs.append(torch.softmax(logits.float(), -1).cpu().numpy())
        mu, cov = acc.finalize()
        is_mean, _ = inception_score_from_probs(np.concatenate(probs)[:is_n], SPLITS)
    dt = time.perf_counter() - t0
    return {"mode": mode, "n_samples": n_batches * batch_size, "wall_s": dt,
            "samples_per_s": n_batches * batch_size / dt, "is": float(is_mean),
            "trace_cov": float(np.trace(cov))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--mode", default="both", choices=["both", "device", "host"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    card = harness.card(args.device)
    modes = ["device", "host"] if args.mode == "both" else [args.mode]

    def measure(row: dict) -> dict:
        out = run(row["mode"], args.n_samples, args.batch_size, args.device)
        harness.free(args.device)
        return {**out, "card": card}

    return harness.run_rows(({"mode": m} for m in modes), measure)


if __name__ == "__main__":
    sys.exit(main())
