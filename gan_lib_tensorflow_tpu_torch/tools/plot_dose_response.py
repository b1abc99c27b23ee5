"""Render the SWD dose-response figure (port of
``tools/plot_dose_response.py``): the per-level sliced Wasserstein distance
of the same 4^2 -> 128^2 packed-pyramid ladder trained at increasing
per-phase image budgets, one curve per pyramid level and the average dashed
in black, on a log2 axis of images per phase, with a dotted grey rule at
the reference schedule's budget (600k images per phase).

Each point is one ladder run evaluated by ``cli.evaluate --model pggan
--resolution 128 --out-json <run>/eval_karras_128.json``. Drawn in numpy
(``tools/figure.py``); the title, axis labels and legend go into the PNG's
``Title`` and ``Description`` text chunks (no font is drawn).

Usage:
  python -m gan_lib_tensorflow_tpu_torch.tools.plot_dose_response \\
      --run runs/pggan_packed_r5=32000 \\
      --run runs/pggan_packed3x_r5=96000 \\
      --run runs/pggan_packed6x_r5=192000 \\
      --out docs/artifacts/pggan128_swd_dose_response.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import figure

LEVEL_KEYS = ("swd_128", "swd_64", "swd_32", "swd_16", "swd_avg")
LEVEL_LABELS = {
    "swd_128": "128^2 (fine)",
    "swd_64": "64^2 (the outlier band)",
    "swd_32": "32^2",
    "swd_16": "16^2 (coarse)",
    "swd_avg": "average",
}
TITLE = "Packed-pyramid 4^2 -> 128^2 ladder: SWD vs per-phase budget"
# the reference's figsize (7.0, 4.2) at dpi 140
SIZE = (588, 980)
TOP, BOTTOM, LEFT, RIGHT = 40, 50, 70, 20


def load_points(run_specs):
    """[(budget, {level: swd}), ...] sorted by budget; fails loudly on a
    missing eval JSON (an unevaluated run must not silently drop out)."""
    pts = []
    for spec in run_specs:
        run_dir, _, budget = spec.partition("=")
        if not budget:
            raise SystemExit(f"--run needs DIR=IMAGES_PER_PHASE, got {spec!r}")
        path = os.path.join(run_dir, "eval_karras_128.json")
        if not os.path.isfile(path):
            raise SystemExit(
                f"{path} missing — evaluate the run first "
                f"(cli.evaluate --model pggan ... --out-json {path})")
        with open(path) as f:
            rec = json.load(f)
        missing = [k for k in LEVEL_KEYS if k not in rec]
        if missing:
            raise SystemExit(f"{path} lacks {missing}")
        pts.append((int(budget), {k: float(rec[k]) for k in LEVEL_KEYS}))
    pts.sort(key=lambda p: p[0])
    return pts


def render(pts, reference_budget: int):
    """``(image, panels)``: five curves over the budgets on a log2 axis that
    also holds the reference budget's rule (``panels[0]["rule"]``, its
    column)."""
    h, w = SIZE
    img = figure.canvas(h, w)
    budgets = [b for b, _ in pts]
    vals = [v[k] for _, v in pts for k in LEVEL_KEYS]
    panel = figure.Panel(img, TOP, LEFT, h - BOTTOM, w - RIGHT,
                         figure.limits(budgets + [reference_budget], 2.0, pad=0.05),
                         figure.limits(vals, pad=0.08), xlog=2.0)
    panel.xticks(budgets)
    rule = panel.vrule(reference_budget, grey=figure.GREY, dotted=True)
    series = []
    for key, color in zip(LEVEL_KEYS, figure.CYCLE):
        ys = [v[key] for _, v in pts]
        if key == "swd_avg":
            panel.line(budgets, ys, figure.BLACK, width=3, dash=(10, 6))
            panel.markers(budgets, ys, figure.BLACK, radius=4)
            series.append((LEVEL_LABELS[key], "black dashed line, circles"))
        else:
            panel.line(budgets, ys, figure.TAB10[color], width=2)
            panel.markers(budgets, ys, figure.TAB10[color], radius=4)
            series.append((LEVEL_LABELS[key], f"{color} line, circles"))
    ticks = ", ".join(f"{b // 1000}k" for b in budgets)
    return img, [{"panel": panel, "rule": rule, "title": TITLE,
                  "x": "training images per ladder phase", "xscale": "log2",
                  "y": "SWD x 10^3 (16,384 images/side)", "series": series,
                  "notes": f"x ticks at {ticks}; dotted grey rule: reference schedule "
                           f"({reference_budget // 1000}k images/phase)"}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run", action="append", required=True,
                    metavar="DIR=IMAGES_PER_PHASE",
                    help="ladder run dir with eval_karras_128.json, and its "
                         "per-phase image budget (repeatable)")
    ap.add_argument("--reference-budget", type=int, default=600_000,
                    help="reference schedule images/phase, drawn as a marker")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    pts = load_points(args.run)
    img, panels = render(pts, args.reference_budget)
    figure.save(args.out, img, TITLE, panels)
    print(f"wrote {args.out} ({len(pts)} budgets)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
