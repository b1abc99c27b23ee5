"""PGGAN high-resolution step benchmark (port of ``tools/bench_pggan.py``):
the top rung at full width without fade-in, WGAN-GP + drift, bf16,
Adam(1e-3, 0, 0.99), EMA 0.999, at ``--resolution 1024 --batch 4``, swept
over the three knobs that matter at 512^2 and 1024^2:

  remat_from  rematerialize the G and D level blocks at resolutions >= this
  fused_from  fused conv + downscale D blocks (Karras fused_scale)
  s2d_from    levels >= this on the space-to-depth grid (ops/s2d.py)

One JSON line per configuration: ``resolution, batch, remat_from,
fused_from, s2d_from, ms_per_step, img_per_sec`` and the card, or
``error`` when it fails to build or fit (the tool then exits 1). Two
warm-up steps, then ``--timed-steps`` steps between two device syncs.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.bench_pggan --resolution 1024 \\
           --batch 4 --remat-from 0 512 1024 --fused-from 0 128 --s2d-from 0 512
"""

from __future__ import annotations

import argparse
import itertools
import sys

from . import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--width-mul", type=float, default=1.0)
    p.add_argument("--remat-from", type=int, nargs="+", default=[0, 512, 1024])
    p.add_argument("--fused-from", type=int, nargs="+", default=[0, 128])
    p.add_argument("--s2d-from", type=int, nargs="+", default=[0])
    p.add_argument("--timed-steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    card = harness.card(args.device)

    def measure(row: dict) -> dict:
        fam = harness.pggan_top(args.resolution, args.batch, args.device,
                                remat_from=row["remat_from"], fused_from=row["fused_from"],
                                s2d_from=row["s2d_from"], width_mul=args.width_mul)
        try:
            sec = harness.seconds_per_step(fam, 2, args.timed_steps)
        finally:
            del fam
            harness.free(args.device)
        return {"ms_per_step": 1e3 * sec, "img_per_sec": args.batch / sec, "card": card}

    rows = ({"resolution": args.resolution, "batch": args.batch, "remat_from": rf,
             "fused_from": ff, "s2d_from": sf}
            for rf, ff, sf in itertools.product(args.remat_from, args.fused_from,
                                                args.s2d_from))
    return harness.run_rows(rows, measure)


if __name__ == "__main__":
    sys.exit(main())
