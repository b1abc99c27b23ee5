#!/usr/bin/env python3
"""Where the time of one of the port's train steps goes, on one card.

``--model sngan`` (the default): the fused SNGAN CIFAR-10 step, built through
the port's CLI ``build`` (batch 64, n_critic 5, bf16, EMA 0.9999, on-device
fake data). ``--model pggan``: the PGGAN 1024x1024 transition step at full
width and batch 4 (bf16, fused_scale D blocks from 128, the 1024x1024 level
on the space-to-depth grid; ``--s2d-from 0``: composed), built by the
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
``--data`` gives the PGGAN step its reals as ``train_pggan --data`` does
(default ``device-fake``); with the host renderers (``fake``,
``fake-rich``) only the wall ms/step is measured.

Warms up, then traces a few steps with ``torch.profiler`` and prints: wall
ms/step (timed without the profiler), device-busy ms/step (the sum of the
traced kernels' times; user annotations such as ``Optimizer.step`` are left
out, they overlap their kernels) and the idle share against the unprofiled
wall time, kernels per step, each hand-written kernel's launches per step,
the device time by kind of kernel (convolutions and matmuls, elementwise,
casts and copies, reductions, pooling, the optimizers' fused updates, the
hand-written kernels) and the kernels with the most device time.
The trace goes to ``chiprun_out/torch_step_trace_<model>.json``.

``--model pggan_eval``: where the time of the PGGAN eval at Karras scale
goes (``profile_pggan_eval``): the plain ``cli.evaluate --model pggan`` at
1024^2 with 16,384 images per side, then a traced run at
4,096 per side read by the eval's profiler ranges.

Usage (on the machine with the card, from the repository root):
    python3 profile_torch_step.py [--model sngan|pggan|sngan_imagenet|acgan|pix2pix]
                                  [--num-classes N] [--data device-fake]
                                  [--s2d-from 512|0] [--steps 5] [--top 25]
    python3 profile_torch_step.py --model pggan_eval
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time
from typing import Optional

WARMUP = 3  # steps before the timed ones: cuDNN's autotune, the first allocations

# (kind, substrings of a kernel's name), tried in order
KINDS = [("hand-written", ("power_iteration", "fadein")),
         ("sort", ("radixsort", "sort")),
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


def build_step(model: str, num_classes: int = 0, data: str = "device-fake",
               device: str = "cuda", extra=(), s2d_from: Optional[int] = None):
    """``(spec, state, batches)`` of the train step that ``--model`` profiles,
    built through the family's CLI at its defaults; ``extra`` adds CLI flags
    (the CPU test's small widths). ``data`` is the PGGAN step's reals, as
    ``train_pggan --data`` takes them; ``s2d_from`` its ``--s2d-from`` (None:
    the CLI's default, 512)."""
    from gan_lib_tensorflow_tpu_torch.cli import (common, train_acgan, train_pggan,
                                                  train_pix2pix, train_sngan,
                                                  train_sngan_imagenet)
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase

    flags = ["--device", device, *extra]
    if model == "sngan":
        args = train_sngan.parse_args(["--data", "device-fake", "--steps", "100000",
                                       "--num-classes", str(num_classes), *flags])
        _, _, spec, state = train_sngan.build(args)
        return spec, state, iter(common.image_source(args, args.batch_size, 32, 10,
                                                     n_micro=spec.n_critic))
    if model == "sngan_imagenet":
        args = train_sngan_imagenet.parse_args(["--data", "device-fake", *flags])
        _, _, spec, state = train_sngan_imagenet.build(args)
        return spec, state, iter(common.image_source(args, args.batch_size, 128,
                                                     args.num_classes, n_micro=spec.n_critic))
    if model == "acgan":
        args = train_acgan.parse_args(["--data", "device-fake", *flags])
        g, _, spec, state = train_acgan.build(args)
        return spec, state, iter(common.image_source(args, args.batch_size, 32, g.num_classes,
                                                     n_micro=spec.n_critic))
    if model == "pix2pix":
        args = train_pix2pix.parse_args(["--data", "device-fake", *flags])
        _, _, spec, state = train_pix2pix.build(args)
        return spec, state, iter(train_pix2pix.paired_source(args, n_micro=spec.n_critic))
    # the ladder's top transition step, fed as train_loop feeds it
    s2d = [] if s2d_from is None else ["--s2d-from", str(s2d_from)]
    args = train_pggan.parse_args(["--data", data, *s2d, *flags])
    res = args.final_resolution
    ph = build_phase(train_pggan.ladder_config(args), res, "transition")
    ph.state.alpha = 0.5
    return ph.spec, ph.state, device_batches(train_pggan.source_factory(args)(res, ph.batch),
                                             1, device)


def report(prof, n: int, wall: float, smi: str, kernels: dict, top: int, name: str,
           unit: str = "step", wall_note: str = "no profiler") -> None:
    """Prints the traced device time of ``n`` units (steps) of ``wall``
    seconds each: busy ms, idle share, kernels, the hand-written kernels'
    launches, time by kind of kernel and the ``top`` kernels; writes the
    trace to ``chiprun_out/torch_step_trace_<name>.json``."""
    import torch

    def is_kernel(e):
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    traced = [e for e in prof.events() if is_kernel(e)]
    busy_us = sum(e.device_time_total for e in traced)
    print(f"card: {smi}")
    print(f"wall {1e3 * wall:.2f} ms/{unit} ({wall_note}), device busy "
          f"{busy_us / 1e3 / n:.2f} ms/{unit}, idle share "
          f"{1 - busy_us / 1e6 / n / wall:.3f}, device kernels {len(traced) / n:.0f}/{unit}, "
          + ", ".join(f"{k} launches {mod.launches / n:.0f}/{unit}"
                      for k, mod in kernels.items()))
    averages = [e for e in prof.key_averages() if is_kernel(e)]
    by_kind = collections.Counter()
    for e in averages:
        by_kind[kind_of(e.key)] += e.device_time_total
    print(f"{'device ms/' + unit:>14} {'share':>6}  kind of kernel")
    for k, us in by_kind.most_common():
        print(f"{us / 1e3 / n:14.3f} {us / busy_us:6.3f}  {k}")
    rows = sorted(averages, key=lambda e: -e.device_time_total)[:top]
    print(f"{'device ms/' + unit:>14} {'share':>6} {'calls/' + unit:>10}  kernel")
    for e in rows:
        print(f"{e.device_time_total / 1e3 / n:14.3f} {e.device_time_total / busy_us:6.3f} "
              f"{e.count / n:10.1f}  {e.key[:110]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", f"torch_step_trace_{name}.json"))


def profile_step(opts, smi: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gan_lib_tensorflow_tpu_torch.ops import fadein
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import make_train_step

    spec, state, batches = build_step(opts.model, opts.num_classes, opts.data,
                                      s2d_from=opts.s2d_from)
    kernels = {"power_iteration": pi, "fadein_blend": fadein}
    step_fn = make_train_step(spec)
    for _ in range(WARMUP):
        step_fn(state, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(opts.steps):
        metrics = step_fn(state, next(batches))
    float(metrics["d_loss"])
    wall = (time.perf_counter() - t0) / opts.steps
    if opts.model == "pggan":
        s2d = 512 if opts.s2d_from is None else opts.s2d_from
        print(f"pggan --data {opts.data} --s2d-from {s2d}: wall {1e3 * wall:.2f} ms/step "
              f"over {opts.steps} steps after {WARMUP}  [{smi}]", flush=True)
        if opts.data not in ("device-fake", "device-rich"):
            return  # the host renderer's time is the question, not the trace's
    for mod in kernels.values():
        mod.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(opts.steps):
            metrics = step_fn(state, next(batches))
        float(metrics["d_loss"])
        torch.cuda.synchronize()
    name = opts.model + (f"_{opts.num_classes}c" if opts.num_classes else "") + (
        f"_s2d{opts.s2d_from}" if opts.s2d_from is not None else "")
    report(prof, opts.steps, wall, smi, kernels, opts.top, name)


# the traced eval's images per side: a quarter of Karras's 16,384 keeps the
# trace's events in host memory; every stage's work is linear in it
TRACED_SWD_SAMPLES = 4096
EVAL_RANGES = ("pggan_eval.ms_ssim", "swd.fakes", "swd.reals", "swd.pyramid",
               "swd.descriptors", "swd.normalize", "swd.project", "swd.sort")


def profile_pggan_eval(opts, smi: str) -> None:
    """``--model pggan_eval``: writes a pyramid store of 64 rich 1024^2
    images, trains the ladder 4^2 -> 1024^2 from it (``train_pggan``, 2 steps
    per phase), runs ``cli.evaluate --model pggan --resolution 1024 --data
    device-rich`` on the 1024^2 stabilize checkpoint as a user would (no
    profiler: its record and ``swd_seconds``), then once more at
    ``TRACED_SWD_SAMPLES`` images per side under ``torch.profiler``: the
    device span and host time of each of the eval's ranges, and the device
    time by kind of kernel."""
    import json
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_pggan
    from gan_lib_tensorflow_tpu_torch.data import write_rich_pyramid
    from gan_lib_tensorflow_tpu_torch.ops import fadein

    t0 = time.perf_counter()
    for _ in range(100_000):
        with record_function("swd.idle"):
            pass
    print(f"one profiler range, no profiler on: "
          f"{(time.perf_counter() - t0) * 10:.2f} us of host time  [{smi}]", flush=True)
    tmp = tempfile.mkdtemp(prefix="profile_pggan_eval_")
    try:
        pyr, run = os.path.join(tmp, "pyramid"), os.path.join(tmp, "ladder")
        write_rich_pyramid(pyr)
        t0 = time.perf_counter()
        train_pggan.main(["--data", pyr, "--final-resolution", "1024", "--steps-per-phase",
                          "2", "--log-every", "2", "--sample-every", "1000",
                          "--out-dir", run])
        print(f"ladder 4x4 -> 1024x1024 from the pyramid store: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ckpt = os.path.join(run, "1024x1024_stabilize", "ckpt")

        def eval_args(n_samples: int, swd_samples: int):
            return ["--model", "pggan", "--resolution", "1024", "--ckpt-dir", ckpt,
                    "--n-samples", str(n_samples), "--swd-samples", str(swd_samples),
                    "--data", "device-rich", "--batch-size", "16"]

        t0 = time.perf_counter()
        rec = evaluate.main(eval_args(50_000, 16384))  # the defaults; Karras's SWD scale
        print(f"plain eval: whole {time.perf_counter() - t0:.1f} s; SWD pass "
              f"{rec['swd_seconds']} s over {rec['swd_images']} images per side "
              f"({rec['swd_images'] / rec['swd_seconds']:.1f} images/s), peak "
              f"{rec['swd_peak_hbm_gb']} GiB; MS-SSIM {rec['ms_ssim_pairs']} pairs  [{smi}]",
              flush=True)

        fadein.launches = 0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prec = evaluate.main(eval_args(160, TRACED_SWD_SAMPLES))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    spans = collections.defaultdict(lambda: [0.0, 0.0, 0])  # device us, host us, count
    for e in prof.events():
        if e.name in EVAL_RANGES:
            if e.device_type == DeviceType.CUDA:
                spans[e.name][0] += e.device_time_total
            else:
                spans[e.name][1] += e.cpu_time_total
                spans[e.name][2] += 1
    swd_s = prec["swd_seconds"]
    print(f"profiled eval at {prec['swd_images']} images per side: SWD pass {swd_s} s "
          f"under the profiler; whole eval {wall:.1f} s")
    if not any(v[0] for v in spans.values()):
        print("the trace holds no device spans of the ranges: host times only")
    print(f"{'device s':>9} {'host s':>9} {'calls':>7} {'device/swd_seconds':>18}  range")
    for name in EVAL_RANGES:
        dev_us, host_us, calls = spans[name]
        share = "outside" if name.startswith("pggan_eval") else f"{dev_us / 1e6 / swd_s:.3f}"
        print(f"{dev_us / 1e6:9.3f} {host_us / 1e6:9.3f} {calls:7d} {share:>18}  {name}")
    report(prof, 1, wall, smi, {"fadein_blend": fadein}, opts.top, "pggan_eval",
           unit="eval", wall_note="under the profiler")
    print(json.dumps({"record": rec, "profiled_record": prec, "card": smi,
                      "ranges": {k: {"device_s": v[0] / 1e6, "host_s": v[1] / 1e6,
                                     "calls": v[2]} for k, v in spans.items()}}))


def main() -> None:
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="sngan", choices=[
        "sngan", "pggan", "sngan_imagenet", "acgan", "pix2pix", "pggan_eval"])
    p.add_argument("--num-classes", type=int, default=0,
                   help="sngan: >0 profiles the conditional variant")
    p.add_argument("--data", default="device-fake",
                   choices=["fake", "fake-rich", "device-fake", "device-rich"],
                   help="pggan: the reals (train_pggan --data); the host renderers "
                        "are timed, not traced")
    p.add_argument("--s2d-from", type=int, default=None,
                   help="pggan: train_pggan --s2d-from (default: the CLI's 512, "
                        "the 1024^2 top level on the space-to-depth grid; 0: the "
                        "composed top level)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if opts.model == "pggan_eval":
        profile_pggan_eval(opts, smi)
    else:
        profile_step(opts, smi)


if __name__ == "__main__":
    main()
