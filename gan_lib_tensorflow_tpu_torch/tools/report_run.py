"""Summarize a training run's log.jsonl into a loss-curve-shape report
(port of ``tools/report_run.py``: its flags, its JSON keys and its
statistics; the ``checkpoints`` it lists are the port's ``step_<n>.pt``
files under ``RUN/ckpt``, where the reference lists orbax step directories).

BASELINE.json:2 defines parity distributionally: FID <= 25 *and matching
loss-curve shape* (exact TF1 RNG parity is unattainable — SURVEY.md §4).
This tool turns a run directory produced by any train CLI into the evidence
row that claim needs: per-quartile loss statistics, a final-decile band,
throughput, the eval-metric trajectory, and mechanical health flags
(non-finite values, D saturation, divergence). The shape verdict for SNGAN
hinge dynamics — D loss falls from its early transient into a sustained
positive band (neither pinned at 0 = saturated D, nor exploding), G loss
bounded — mirrors what the reference lineage's published curves look like;
the tool prints the statistics and the mechanical checks, and leaves the
final "matches" call to the human reading them (stated in BASELINE.md).

Usage:
  python -m gan_lib_tensorflow_tpu_torch.tools.report_run runs/sngan_100k_ref [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from ..train.checkpoint import CheckpointManager


def _series(rows, key):
    return [(r["step"], float(r[key])) for r in rows if key in r]


def _stats(vals):
    if not vals:
        return None
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / max(n - 1, 1)
    return {"n": n, "mean": mean, "std": math.sqrt(var),
            "min": min(vals), "max": max(vals)}


def _quartiles(pairs):
    """Mean of the value over each quarter of the step range."""
    if not pairs:
        return []
    lo, hi = pairs[0][0], pairs[-1][0]
    span = max(hi - lo, 1)
    buckets = [[], [], [], []]
    for s, v in pairs:
        q = min(int(4 * (s - lo) / span), 3)
        buckets[q].append(v)
    return [sum(b) / len(b) if b else float("nan") for b in buckets]


def analyze(run_dir):
    log_path = os.path.join(run_dir, "log.jsonl")
    rows = []
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    rows.sort(key=lambda r: r["step"])
    if not rows:
        raise SystemExit(f"{log_path}: empty")

    keys = sorted({k for r in rows for k in r} - {"step"})
    first, last = rows[0]["step"], rows[-1]["step"]
    report = {"run_dir": run_dir, "first_step": first, "last_step": last,
              "log_rows": len(rows), "losses": {}, "eval": {}, "flags": []}

    # mechanical health: every logged value finite (the loop itself aborts on
    # non-finite training metrics, so a hit here can only come from eval rows)
    bad = [(r["step"], k) for r in rows for k, v in r.items()
           if k != "step" and not math.isfinite(float(v))]
    if bad:
        report["flags"].append(f"non-finite values: {bad[:5]}")

    for key in keys:
        pairs = _series(rows, key)
        vals = [v for _, v in pairs]
        tail = [v for s, v in pairs if s >= first + 0.9 * (last - first)]
        entry = {"overall": _stats(vals), "quartile_means": _quartiles(pairs),
                 "final_decile": _stats(tail)}
        if key in ("fid", "inception_score", "inception_score_std",
                   "swd", "ms_ssim"):
            best = (min if key in ("fid", "swd") else max)(pairs, key=lambda p: p[1])
            entry["best"] = {"step": best[0], "value": best[1]}
            entry["final"] = {"step": pairs[-1][0], "value": pairs[-1][1]}
            report["eval"][key] = entry
        else:
            report["losses"][key] = entry

    # shape heuristics for the adversarial pair
    d = report["losses"].get("d_loss")
    if d and d["final_decile"]:
        q = d["quartile_means"]
        fd = d["final_decile"]
        if fd["mean"] < 1e-4:
            report["flags"].append(
                "D saturated: final-decile d_loss ~ 0 (hinge margins met on "
                "every sample — G no longer receives signal)")
        if fd["mean"] > 10 * max(q[0], 1e-9):
            report["flags"].append("D loss diverging: final decile >> first quartile")
        report["shape"] = (
            f"d_loss quartile means {['%.3f' % v for v in q]} -> final-decile "
            f"band {fd['mean']:.3f} +/- {fd['std']:.3f}; "
            "expected hinge shape: early transient, then a sustained positive "
            "band (not pinned at 0, not exploding)")
    g = report["losses"].get("g_loss")
    if g and g["final_decile"] and abs(g["final_decile"]["mean"]) > 100:
        report["flags"].append("G loss left its band (|mean| > 100 in final decile)")

    sps = report["losses"].pop("sec_per_step", None)
    if sps:
        # drop the first point (includes compile)
        pairs = _series(rows, "sec_per_step")[1:]
        vals = [v for _, v in pairs] or [sps["overall"]["mean"]]
        report["throughput"] = {"sec_per_step": _stats(vals)}

    ckpt_dir = os.path.join(run_dir, "ckpt")
    if os.path.isdir(ckpt_dir):
        report["checkpoints"] = CheckpointManager.steps_in(ckpt_dir)
    samples_dir = os.path.join(run_dir, "samples")
    if os.path.isdir(samples_dir):
        report["sample_grids"] = len(os.listdir(samples_dir))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--json", help="also write the full report as JSON")
    args = ap.parse_args(argv)
    rep = analyze(args.run_dir)

    print(f"# Run report: {rep['run_dir']}")
    print(f"steps {rep['first_step']}..{rep['last_step']} "
          f"({rep['log_rows']} log rows)")
    if "throughput" in rep:
        s = rep["throughput"]["sec_per_step"]
        print(f"throughput: {s['mean']*1e3:.1f} ms/step mean "
              f"(min {s['min']*1e3:.1f}, max {s['max']*1e3:.1f}, n={s['n']})")
    for k, e in rep["losses"].items():
        q = ", ".join(f"{v:.3f}" for v in e["quartile_means"])
        fd = e["final_decile"]
        print(f"{k}: quartile means [{q}]  final-decile "
              f"{fd['mean']:.3f} +/- {fd['std']:.3f}")
    for k, e in rep["eval"].items():
        print(f"{k}: best {e['best']['value']:.3f} @ step {e['best']['step']}, "
              f"final {e['final']['value']:.3f} @ {e['final']['step']}")
    if "shape" in rep:
        print(f"shape: {rep['shape']}")
    if "checkpoints" in rep:
        ck = rep["checkpoints"]
        print(f"checkpoints: {len(ck)}"
              + (f" (first {ck[0]}, last {ck[-1]})" if ck else ""))
    if "sample_grids" in rep:
        print(f"sample grids: {rep['sample_grids']}")
    print("flags: " + ("; ".join(rep["flags"]) if rep["flags"] else "none"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
    return 0 if not rep["flags"] else 1


if __name__ == "__main__":
    sys.exit(main())
