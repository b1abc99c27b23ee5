#!/usr/bin/env python3
"""Where the time of one of the port's train steps goes, on one card.

``--model sngan`` (the default): the fused SNGAN CIFAR-10 step, built through
the port's CLI ``build`` (batch 64, n_critic 5, bf16, EMA 0.9999, on-device
fake data). ``--model pggan``: the PGGAN 1024x1024 transition step at full
width and batch 4 (bf16, fused_scale D blocks from 128), built by the
ladder's own ``build_phase`` from the PGGAN CLI's defaults.
``--model sngan_imagenet``: the fused SNGAN-projection ImageNet-128 step at
full width (1000 classes, batch 64, n_critic 5, bf16, EMA 0.9999) built by
``train_sngan_imagenet.build``, on class blobs rendered on the device.
``--model acgan``: the ACGAN CIFAR-10 step at full width (batch 100, bf16,
bce, aux weight 1.0) built by ``train_acgan.build``. ``--num-classes N``
with ``--model sngan``: the conditional CIFAR SNGAN (projection D, 12
spectral-norm weights). ``--model pix2pix``: the pix2pix step at full width
(U-Net ngf 64 + PatchGAN ndf 64, 256x256, batch 1, bf16) built by
``train_pix2pix.build``, on pairs rendered on the device (``device-fake``).

Warms up, then traces a few steps with ``torch.profiler`` and prints: wall
ms/step (timed without the profiler), device-busy ms/step (the sum of the
traced kernels' times; user annotations such as ``Optimizer.step`` are left
out, they overlap their kernels) and the idle share against the unprofiled
wall time, kernels per step, each hand-written kernel's launches per step,
the device time by kind of kernel (convolutions and matmuls, elementwise,
casts and copies, reductions, pooling, the optimizers' fused updates, the
hand-written kernels) and the kernels with the most device time.
The trace goes to ``chiprun_out/torch_step_trace_<model>.json``.

Usage (on the machine with the card, from the repository root):
    python3 profile_torch_step.py [--model sngan|pggan|sngan_imagenet|acgan|pix2pix]
                                  [--num-classes N] [--steps 5] [--top 25]
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time

# (kind, substrings of a kernel's name), tried in order
KINDS = [("hand-written", ("power_iteration", "fadein")),
         ("conv/matmul", ("xmma", "cudnn", "conv", "gemm", "nvjet")),
         ("cast/copy", ("copy",)),
         ("reduction", ("reduce_kernel",)),
         ("pooling", ("pool",)),
         ("adam/ema (foreach)", ("multi_tensor", "foreach")),
         ("elementwise", ("elementwise",))]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gan_lib_tensorflow_tpu_torch.cli import (common, train_acgan, train_pggan,
                                                  train_pix2pix, train_sngan,
                                                  train_sngan_imagenet)
    from gan_lib_tensorflow_tpu_torch.ops import fadein
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import make_train_step
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=["sngan", "pggan", "sngan_imagenet", "acgan", "pix2pix"],
                   default="sngan")
    p.add_argument("--num-classes", type=int, default=0,
                   help="sngan: >0 profiles the conditional variant")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    if opts.model == "sngan":
        args = train_sngan.parse_args(["--data", "fake", "--device", "cuda", "--steps",
                                       "100000", "--num-classes", str(opts.num_classes)])
        _, _, spec, state = train_sngan.build(args)
        batches = iter(common.image_source(args, args.batch_size, 32, 10,
                                           n_micro=spec.n_critic))
    elif opts.model == "sngan_imagenet":
        args = train_sngan_imagenet.parse_args(["--data", "fake", "--device", "cuda"])
        _, _, spec, state = train_sngan_imagenet.build(args)
        batches = iter(common.image_source(args, args.batch_size, 128, args.num_classes,
                                           n_micro=spec.n_critic))
    elif opts.model == "acgan":
        args = train_acgan.parse_args(["--data", "fake", "--device", "cuda"])
        g, _, spec, state = train_acgan.build(args)
        batches = iter(common.image_source(args, args.batch_size, 32, g.num_classes,
                                           n_micro=spec.n_critic))
    elif opts.model == "pix2pix":
        args = train_pix2pix.parse_args(["--data", "device-fake", "--device", "cuda"])
        _, _, spec, state = train_pix2pix.build(args)
        batches = iter(train_pix2pix.paired_source(args, n_micro=spec.n_critic))
    else:
        args = train_pggan.parse_args(["--data", "fake", "--device", "cuda"])
        ph = build_phase(train_pggan.ladder_config(args), 1024, "transition")
        spec, state = ph.spec, ph.state
        state.alpha = 0.5
        batches = iter(train_pggan.source_factory(args)(1024, ph.batch))
    kernels = {"power_iteration": pi, "fadein_blend": fadein}
    step_fn = make_train_step(spec)
    for _ in range(3):
        step_fn(state, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(opts.steps):
        metrics = step_fn(state, next(batches))
    float(metrics["d_loss"])
    wall = (time.perf_counter() - t0) / opts.steps

    for mod in kernels.values():
        mod.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(opts.steps):
            metrics = step_fn(state, next(batches))
        float(metrics["d_loss"])
        torch.cuda.synchronize()

    def is_kernel(e):
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    n = opts.steps
    traced = [e for e in prof.events() if is_kernel(e)]
    busy_us = sum(e.device_time_total for e in traced)
    print(f"card: {smi}")
    print(f"wall {1e3 * wall:.2f} ms/step (no profiler), device busy "
          f"{busy_us / 1e3 / n:.2f} ms/step, idle share "
          f"{1 - busy_us / 1e6 / n / wall:.3f}, device kernels {len(traced) / n:.0f}/step, "
          + ", ".join(f"{k} launches {mod.launches / n:.0f}/step" for k, mod in kernels.items()))
    averages = [e for e in prof.key_averages() if is_kernel(e)]
    by_kind = collections.Counter()
    for e in averages:
        by_kind[kind_of(e.key)] += e.device_time_total
    print(f"{'device ms/step':>14} {'share':>6}  kind of kernel")
    for k, us in by_kind.most_common():
        print(f"{us / 1e3 / n:14.3f} {us / busy_us:6.3f}  {k}")
    rows = sorted(averages, key=lambda e: -e.device_time_total)[:opts.top]
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for e in rows:
        print(f"{e.device_time_total / 1e3 / n:14.3f} {e.device_time_total / busy_us:6.3f} "
              f"{e.count / n:10.1f}  {e.key[:110]}")
    os.makedirs("chiprun_out", exist_ok=True)
    if opts.num_classes:  # the conditional variant's trace gets a name of its own
        opts.model += f"_{opts.num_classes}c"
    prof.export_chrome_trace(os.path.join("chiprun_out", f"torch_step_trace_{opts.model}.json"))


if __name__ == "__main__":
    main()
