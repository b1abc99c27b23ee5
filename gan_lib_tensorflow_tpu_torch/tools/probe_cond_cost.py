"""Bound the conditional machinery's cost in the ImageNet-128 step (port of
``tools/probe_cond_cost.py``): the fused step (batch 64, n_critic 5, TTUR)
in two builds,

  cond    the reference SNGAN-projection: conditional BN in G and the
          projection D, 1000 classes
  uncond  num_classes 0 in both: plain BN, no projection term

The difference bounds everything conditional. Both D builds launch the
power-iteration kernel over their 19 spectral-norm weights. One JSON line
per build: ``config, ms_per_step, img_per_sec`` and the card. Three warm-up
steps, then ``--timed-steps`` steps between two device syncs.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.probe_cond_cost
"""

from __future__ import annotations

import argparse
import sys

from . import harness

BUILDS = (("cond", 1000), ("uncond", 0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--timed-steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--width-mul", type=float, default=1.0,
                   help="channel-width multiplier (1.0 = reference width)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    card = harness.card(args.device)
    classes = dict(BUILDS)

    def measure(row: dict) -> dict:
        fam = harness.sngan_imagenet(args.batch, args.device, num_classes=classes[row["config"]],
                                     width_mul=args.width_mul)
        try:
            sec = harness.seconds_per_step(fam, 3, args.timed_steps)
            return {"ms_per_step": 1e3 * sec, "img_per_sec": fam.images_per_step / sec,
                    "card": card}
        finally:
            del fam
            harness.free(args.device)

    return harness.run_rows(({"config": name} for name, _ in BUILDS), measure)


if __name__ == "__main__":
    sys.exit(main())
