"""FLOP-calibrate the perf rungs (port of ``tools/calibrate_rungs.py``):
ACGAN, pix2pix 256^2, SNGAN-projection ImageNet-128 and PGGAN at 256^2,
512^2 and 1024^2, each at the reference tool's configuration.

FLOPs: torch's FLOP formulas (``torch.utils.flop_counter.flop_registry``,
what ``FlopCounterMode`` counts with) applied to every operator of one whole
fused step, the backward and the penalty's double backward included, by a
dispatch mode without ``FlopCounterMode``'s module hooks (they refuse
``torch.autograd.grad``). It counts every matmul and convolution that runs
(2 FLOPs per multiply-add; elementwise work is not counted), so
ImageNet-128's five critic updates are counted as they run and need no hand
correction.

Peaks: the nominal rate is the NVIDIA H100 SXM data sheet's dense bf16
tensor-core rate; the achieved rate is measured here, a bf16 8192^3
``torch.matmul`` timed with CUDA events, and printed beside the card's name
and power limit. Off the card the roofline, MFU and achieved-rate keys are
null: a CPU run has no share of a card's peak.

One JSON line per rung: ``rung, batch, ms_per_step, img_per_sec,
tf_per_step, roofline_ms_nominal, roofline_ms_achieved, mfu_nominal,
frac_of_achieved`` (``img_per_sec`` counts ``batch`` images per step, as
the reference does), with ``nominal_tfs``, ``achieved_tfs`` and the card.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.calibrate_rungs \\
           --rungs acgan pix2pix imagenet pggan256 pggan512 pggan1024
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import resolve_device
from . import harness

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s (no sparsity), at 700 W
H100_SXM_BF16_DENSE_TFS = 989.0
MATMUL_N, MATMUL_REPS = 8192, 20
PGGAN_BATCHES = {256: 8, 512: 8, 1024: 4}  # the reference's schedule at high resolution


class _FlopCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of the matmuls and convolutions that ``fn()`` runs."""
    with _FlopCount() as counter:
        fn()
    return counter.total


def matmul_tfs(device) -> float:
    """Measured bf16 matmul rate on the card, TFLOP/s: ``MATMUL_REPS``
    products of two ``MATMUL_N``^2 matrices between CUDA events."""
    g = torch.Generator(device=device).manual_seed(0)
    a, b = (torch.randn(MATMUL_N, MATMUL_N, device=device, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    for _ in range(3):
        torch.matmul(a, b)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MATMUL_REPS):
        torch.matmul(a, b)
    end.record()
    end.synchronize()
    return 2 * MATMUL_N ** 3 * MATMUL_REPS / (start.elapsed_time(end) * 1e-3) / 1e12


def calibrate(fam: harness.Family, timed_steps: int, achieved: Optional[float]) -> dict:
    """Count one step's FLOPs (it is also the first warm-up step), then time
    it; the roofline keys against both peaks when ``achieved`` is known."""
    tf = count_flops(lambda: fam.step(fam.state, fam.data)) / 1e12
    sec = harness.seconds_per_step(fam, 1, timed_steps)
    ms = 1e3 * sec
    row = {"batch": fam.batch, "ms_per_step": ms, "img_per_sec": fam.batch / sec,
           "tf_per_step": tf, "roofline_ms_nominal": None, "roofline_ms_achieved": None,
           "mfu_nominal": None, "frac_of_achieved": None}
    if achieved is not None:
        nom = tf / H100_SXM_BF16_DENSE_TFS * 1e3
        ach = tf / achieved * 1e3
        row.update(roofline_ms_nominal=nom, roofline_ms_achieved=ach,
                   mfu_nominal=nom / ms, frac_of_achieved=ach / ms)
    return row


def build(rung: str, args) -> harness.Family:
    dev, wm = args.device, args.width_mul
    if rung == "acgan":
        return harness.acgan_cifar(100, dev)
    if rung == "pix2pix":
        return harness.pix2pix_facades(args.pix2pix_batch, dev)
    if rung == "imagenet":
        return harness.sngan_imagenet(64, dev, width_mul=wm)
    if rung.startswith("pggan"):
        res = int(rung[len("pggan"):])
        return harness.pggan_top(res, args.pggan_batch or PGGAN_BATCHES.get(res, 8), dev,
                                 s2d_from=args.s2d_from, width_mul=wm)
    raise ValueError(f"unknown rung {rung!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rungs", nargs="+", default=["acgan", "pggan256", "pggan512", "pggan1024"],
                   help="also available: pix2pix (256^2, --pix2pix-batch), imagenet "
                        "(SNGAN-projection 128^2, batch 64), pggan<res> at any resolution")
    p.add_argument("--timed-steps", type=int, default=10)
    p.add_argument("--s2d-from", type=int, default=0,
                   help="PGGAN levels on the space-to-depth grid from this resolution "
                        "(its FLOPs are the S2D convolutions' own, 4x the composed at the top)")
    p.add_argument("--pggan-batch", type=int, default=0,
                   help="override the per-resolution batch schedule")
    p.add_argument("--pix2pix-batch", type=int, default=4)
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="pggan and imagenet channel-width multiplier (1.0 = reference width)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    achieved = matmul_tfs(dev) if dev.type == "cuda" else None
    card = harness.card(dev)

    def measure(row: dict) -> dict:
        fam = build(row["rung"], args)
        try:
            out = calibrate(fam, args.timed_steps, achieved)
        finally:
            del fam
            harness.free(dev)
        return {**out, "nominal_tfs": H100_SXM_BF16_DENSE_TFS, "achieved_tfs": achieved,
                "card": card}

    return harness.run_rows(({"rung": r} for r in args.rungs), measure)


if __name__ == "__main__":
    sys.exit(main())
