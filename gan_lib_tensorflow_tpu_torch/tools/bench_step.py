"""Per-model fused-train-step timer (port of ``tools/bench_step.py``), each
family at the reference tool's configuration:

  sngan      CIFAR-10 32^2, batch 64, n_critic 5, hinge
  acgan      CIFAR-10 32^2, batch 100, n_critic 1, BCE + aux CE
  imagenet   SNGAN-projection 128^2 conditional, batch 64, n_critic 5, TTUR

One JSON line per model: ``model, batch, n_critic, ms_per_step,
img_per_sec`` and the card. Three warm-up steps, then ``--timed-steps``
steps between two device syncs. sngan and imagenet launch the
power-iteration kernel 6 times per step on the card.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.bench_step --model acgan imagenet
       python -m gan_lib_tensorflow_tpu_torch.tools.bench_step --device cpu \\
           --batch 2 --timed-steps 1 --width-mul 0.015625
"""

from __future__ import annotations

import argparse
import sys

from . import harness

MODELS = ("sngan", "acgan", "imagenet")


def build(model: str, batch, device, width_mul: float = 1.0) -> harness.Family:
    if model == "sngan":
        return harness.sngan_cifar(batch, device)
    if model == "acgan":
        return harness.acgan_cifar(batch, device)
    return harness.sngan_imagenet(batch, device, width_mul=width_mul)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", nargs="+", default=list(MODELS), choices=MODELS)
    p.add_argument("--batch", type=int, default=None,
                   help="override the reference batch size")
    p.add_argument("--timed-steps", type=int, default=50)
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="imagenet's channel-width multiplier (1.0 = reference width)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    card = harness.card(args.device)

    def measure(row: dict) -> dict:
        fam = build(row["model"], args.batch, args.device, args.width_mul)
        sec = harness.seconds_per_step(fam, 3, args.timed_steps)
        out = {"batch": fam.batch, "n_critic": fam.spec.n_critic,
               "ms_per_step": 1e3 * sec, "img_per_sec": fam.images_per_step / sec,
               "card": card}
        del fam
        harness.free(args.device)
        return out

    return harness.run_rows(({"model": m} for m in args.model), measure)


if __name__ == "__main__":
    sys.exit(main())
