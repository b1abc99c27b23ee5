"""Render a PGGAN ladder run's figure (port of ``tools/plot_ladder.py``):
the Wasserstein distance and the gradient penalty (log scale) of every phase
on one global-step axis, in two panels that share it, with a grey rule at
each phase boundary. Drawn in numpy (``tools/figure.py``); the title, axis
labels and the phases' names go into the PNG's ``Title`` and
``Description`` text chunks (no font is drawn).

Usage:
  python -m gan_lib_tensorflow_tpu_torch.tools.plot_ladder runs/pggan256_r3 \\
      --out docs/artifacts/pg256.png
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from . import figure

_PHASE_RE = re.compile(r"^(\d+)x\1_(transition|stabilize)$")
# the reference's figsize (11, 5.5) at dpi 120
SIZE = (660, 1320)
TOP, BOTTOM, LEFT, RIGHT, GAP = 30, 40, 60, 20, 30


def phase_order(name: str):
    m = _PHASE_RE.match(name)
    if not m:
        return None
    # transitions precede stabilizes at the same resolution
    return (int(m.group(1)), 0 if m.group(2) == "transition" else 1)


def load_ladder(run_dir: str):
    """[(phase_name, [record, ...]), ...] in ladder order; skips non-phase
    dirs and records without a step (config headers)."""
    phases = []
    for d in os.listdir(run_dir):
        key = phase_order(d)
        log = os.path.join(run_dir, d, "log.jsonl")
        if key is None or not os.path.isfile(log):
            continue
        recs = []
        with open(log) as f:
            for line in f:
                rec = json.loads(line)
                if "step" in rec:
                    recs.append(rec)
        if recs:
            phases.append((key, d, recs))
    phases.sort(key=lambda t: t[0])
    return [(name, recs) for _, name, recs in phases]


def offsets(phases):
    """Each phase's global-step offset (where its rule goes) and its
    records' global steps, as the reference lays them out."""
    out, offset = [], 0
    for _, recs in phases:
        xs = [offset + r["step"] for r in recs]
        out.append((offset, xs))
        offset = xs[-1]
    return out


def render(phases, title: str):
    """``(image, panels)`` of the ladder's phases: the W-distance panel on
    top, the GP panel (log scale) below; ``panels[i]["panel"]`` is the
    ``Panel`` and ``panels[i]["rules"]`` the rules' columns."""
    h, w = SIZE
    img = figure.canvas(h, w)
    lay = offsets(phases)
    xlim = (0.0, float(lay[-1][1][-1]))
    wd = [r.get("wdist", float("nan")) for _, recs in phases for r in recs]
    gp = [r.get("gp", float("nan")) for _, recs in phases for r in recs]
    ph = (h - TOP - BOTTOM - GAP) // 2
    p_w = figure.Panel(img, TOP, LEFT, TOP + ph, w - RIGHT, xlim, figure.limits(wd, pad=0.05))
    p_gp = figure.Panel(img, TOP + ph + GAP, LEFT, h - BOTTOM, w - RIGHT, xlim,
                        figure.limits(gp, 10.0, pad=0.05), ylog=10.0)
    p_gp.yticks(figure.decades(p_gp.ylim))
    rules = []
    for (name, recs), (offset, xs) in zip(phases, lay):
        rules.append(p_w.vrule(offset))
        p_gp.vrule(offset)
        p_w.line(xs, [r.get("wdist", float("nan")) for r in recs], figure.TAB10["tab:blue"])
        p_gp.line(xs, [r.get("gp", float("nan")) for r in recs], figure.TAB10["tab:orange"])
    names = ", ".join(f"{name.replace('_transition', ' t').replace('_stabilize', ' s')} at "
                      f"{offset}" for (name, _), (offset, _) in zip(phases, lay))
    panels = [{"panel": p_w, "rules": rules, "title": "Wasserstein distance",
               "x": "global step (phases concatenated)", "y": "Wasserstein distance",
               "series": [("wdist", "tab:blue line per phase")],
               "notes": f"grey rules at the phase boundaries: {names}"},
              {"panel": p_gp, "rules": rules, "title": "gradient penalty",
               "x": "global step (phases concatenated)", "y": "gradient penalty",
               "yscale": "log", "series": [("gp", "tab:orange line per phase")]}]
    return img, panels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--title", default=None,
                   help="default: the ladder's resolutions and the run directory's name")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.run_dir, "ladder_summary.png")

    phases = load_ladder(args.run_dir)
    if not phases:
        raise SystemExit(f"no phase dirs with log.jsonl under {args.run_dir}")
    first, last = (phase_order(phases[i][0])[0] for i in (0, -1))
    name = os.path.basename(os.path.normpath(os.path.abspath(args.run_dir)))
    title = args.title or f"PGGAN progressive ladder {first}^2 -> {last}^2 ({name})"
    img, panels = render(phases, title)
    figure.save(out, img, title, panels)
    print(f"wrote {out} ({len(phases)} phases)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
