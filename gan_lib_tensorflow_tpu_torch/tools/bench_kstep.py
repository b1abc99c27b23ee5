"""K steps per dispatch for the small, host-bound models (port of
``tools/bench_kstep.py``): ACGAN (batch 100) and pix2pix (256^2, batch 4).

For K in ``--ks`` and each model:
  (a) ``chained``: K eager steps, then one device sync (the loop that reads
      its metrics every K steps)
  (b) ``fused``: the single step captured K times into one
      ``torch.cuda.CUDAGraph``, replayed, one sync per replay: the torch
      counterpart of the reference's one dispatch of a ``lax.scan`` over K
      steps. Capture needs Adam with ``capturable=True`` (made here, with
      the same hyperparameters) and the step's noise generators registered
      with the graph; it runs on the card only.
If (b) flattens to a constant while (a) does not, the constant is the
device's work and (a) - (b) the host's launch cost per step. Every step does
the same work; only the way it is launched differs.

One JSON line per (model, mode, K): ``model, mode, k, ms_per_step`` and the
card.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.bench_kstep [--ks 1 5 10 50]
       python -m gan_lib_tensorflow_tpu_torch.tools.bench_kstep --device cpu --mode chained
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from .. import resolve_device
from ..utils.profiler import StepTimer
from . import harness


def build(model: str, device, image_size: int = 256) -> harness.Family:
    if model == "acgan":
        return harness.acgan_cifar(100, device)
    return harness.pix2pix_facades(4, device, image_size=image_size)


def chained_ms(fam: harness.Family, k: int, reps: int) -> float:
    dev = next(fam.state.g.parameters()).device
    timer = StepTimer(images_per_step=fam.images_per_step, device=dev)
    timer.start()
    for _ in range(reps):
        for _ in range(k):
            metrics = fam.step(fam.state, fam.data)
        float(metrics["d_loss"])  # one sync per K-chain
    timer.tick(reps * k)
    return 1e3 * timer.stop()["sec_per_step"]


def make_capturable(fam: harness.Family) -> None:
    """Both Adams rebuilt with ``capturable=True`` (their step counts on the
    card), the same hyperparameters; the state has taken no step yet."""
    st = fam.state
    for name in ("g_opt", "d_opt"):
        group = getattr(st, name).param_groups[0]
        setattr(st, name, torch.optim.Adam(group["params"], lr=group["lr"],
                                           betas=group["betas"], eps=group["eps"],
                                           capturable=True))


def fused_ms(fam: harness.Family, k: int, reps: int) -> float:
    """K steps captured into one CUDA graph; ms per step over ``reps``
    replays, one sync after each."""
    st, dev = fam.state, next(fam.state.g.parameters()).device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up off the capture: cuDNN and Adam set up
        for _ in range(3):
            fam.step(st, fam.data)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in (st.g_noise, st.d_noise):
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        for _ in range(k):
            metrics = fam.step(st, fam.data)
    graph.replay()
    if not math.isfinite(float(metrics["d_loss"])):
        raise FloatingPointError(f"the graph of {k} steps gave d_loss {metrics['d_loss']}")
    timer = StepTimer(images_per_step=fam.images_per_step, device=dev)
    timer.start()
    for _ in range(reps):
        graph.replay()
        float(metrics["d_loss"])
    timer.tick(reps * k)
    ms = 1e3 * timer.stop()["sec_per_step"]
    del graph
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", nargs="+", default=["acgan", "pix2pix"],
                   choices=["acgan", "pix2pix"])
    p.add_argument("--ks", type=int, nargs="+", default=[1, 5, 10, 50])
    p.add_argument("--reps", type=int, default=200,
                   help="steps measured per point (K=50 runs reps // 50 replays)")
    p.add_argument("--mode", default="both", choices=["both", "chained", "fused"])
    p.add_argument("--image-size", type=int, default=256, help="pix2pix's (256 = reference)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = harness.card(dev)
    modes = ["chained", "fused"] if args.mode == "both" else [args.mode]

    def measure(row: dict) -> dict:
        reps = max(1, args.reps // row["k"])
        fam = build(row["model"], dev, args.image_size)
        try:
            if row["mode"] == "chained":
                for _ in range(3):
                    fam.step(fam.state, fam.data)
                ms = chained_ms(fam, row["k"], reps)
            else:
                if dev.type != "cuda":
                    raise RuntimeError("the fused mode captures a CUDA graph: it needs the card")
                make_capturable(fam)
                ms = fused_ms(fam, row["k"], reps)
        finally:
            del fam
            harness.free(dev)
        return {"ms_per_step": ms, "card": card}

    rows = ({"model": m, "mode": mode, "k": k}
            for m in args.model for mode in modes for k in args.ks)
    return harness.run_rows(rows, measure)


if __name__ == "__main__":
    sys.exit(main())
