"""Render a training run's figure from its ``log.jsonl`` (port of
``tools/plot_run.py``): the loss curves (``d_loss``, ``g_loss``) in one
panel and, when the run logged ``fid``, the FID trend with the inception
score on its own scale in a second. Drawn in numpy (``tools/figure.py``) at
the reference figure's size in pixels; the title, axis labels and legend go
into the PNG's ``Title`` and ``Description`` text chunks (no font is drawn).

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.plot_run runs/long_sngan \\
           --out docs/artifacts/sngan_long_run.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import figure

# the reference's figsize at dpi 120: (11, 3.5) with the FID panel, (6, 3.5) without
SIZE_FID, SIZE_LOSSES = (420, 1320), (420, 720)
TOP, BOTTOM, LEFT, RIGHT, GAP = 30, 40, 50, 20, 70


def load_history(run_dir: str):
    """``{metric: [(step, value), ...]}`` of every record with a step."""
    hist = {}
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "step" not in rec:  # config/header records carry no step
                continue
            step = rec.pop("step")
            for k, v in rec.items():
                hist.setdefault(k, []).append((step, v))
    return hist


def _xy(points):
    return [p[0] for p in points], [p[1] for p in points]


def render(hist, title: str):
    """The figure of a history: ``(image, panels)``, each panel a dict
    holding its ``Panel`` under ``"panel"`` and its text."""
    has_fid = "fid" in hist
    h, w = SIZE_FID if has_fid else SIZE_LOSSES
    img = figure.canvas(h, w)
    n = 2 if has_fid else 1
    width = (w - LEFT - RIGHT - (n - 1) * GAP) // n
    boxes = [(TOP, LEFT + i * (width + GAP), h - BOTTOM, LEFT + i * (width + GAP) + width)
             for i in range(n)]

    losses = [k for k in ("d_loss", "g_loss") if k in hist]
    xs = [s for k in losses for s, _ in hist[k]]
    ys = [v for k in losses for _, v in hist[k]]
    p0 = figure.Panel(img, *boxes[0], figure.limits(xs), figure.limits(ys, pad=0.05))
    series = []
    for k, color in zip(losses, figure.CYCLE):
        p0.line(*_xy(hist[k]), figure.TAB10[color])
        series.append((k, f"{color} line"))
    panels = [{"panel": p0, "title": "losses", "x": "fused step", "y": "loss",
               "series": series}]
    if has_fid:
        fx, fy = _xy(hist["fid"])
        all_x = fx + (_xy(hist["inception_score"])[0] if "inception_score" in hist else [])
        p1 = figure.Panel(img, *boxes[1], figure.limits(all_x, pad=0.05),
                          figure.limits(fy, pad=0.05))
        p1.line(fx, fy, figure.TAB10["tab:blue"])
        p1.markers(fx, fy, figure.TAB10["tab:blue"], radius=3)
        entry = {"panel": p1, "title": "FID trend", "x": "fused step",
                 "y": "FID (fixed extractor)", "series": [("FID", "tab:blue line, circles")]}
        if "inception_score" in hist:
            ix, iy = _xy(hist["inception_score"])
            twin = figure.Panel(img, *boxes[1], p1.xlim, figure.limits(iy, pad=0.05))
            twin.line(ix, iy, figure.TAB10["tab:green"])
            twin.markers(ix, iy, figure.TAB10["tab:green"], radius=3, square=True)
            entry["y2"] = "IS"
            entry["series"].append(("IS", "tab:green line, squares, right axis"))
            entry["twin"] = twin
        panels.append(entry)
    return img, panels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--title", default=None,
                   help="default: the run directory's name and what the figure holds")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.run_dir, "run_summary.png")
    hist = load_history(args.run_dir)
    name = os.path.basename(os.path.normpath(os.path.abspath(args.run_dir)))
    title = args.title or (f"{name}: losses" + (" and FID" if "fid" in hist else ""))
    img, panels = render(hist, title)
    figure.save(out, img, title, panels)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
