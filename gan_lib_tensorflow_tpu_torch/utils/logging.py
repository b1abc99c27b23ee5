"""Scalar logging (port of ``gan_lib_tensorflow_tpu/utils/logging.py``):
running means since the last flush, ``sec_per_step``, one printed line,
``log.jsonl`` under ``out_dir``, the history of every flushed value, and two
options: ``curves`` (one ``{metric}.png`` line plot per metric, drawn in
numpy and written by ``utils/images.py:png_bytes``, no matplotlib) and
``tensorboard`` (torch's ``SummaryWriter`` under ``out_dir/tb`` when it
imports; otherwise a printed note, and logging goes on without it)."""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .images import png_bytes

CURVE_H, CURVE_W, CURVE_MARGIN = 300, 600, 20  # pixels, as the reference's 6x3 in figure


def curve_image(points: List[Tuple[int, float]]) -> np.ndarray:
    """A line plot of ``(step, value)`` points: a uint8 ``[H, W, 3]`` white
    canvas, a grey frame, and the polyline in blue, scaled to fill the frame."""
    img = np.full((CURVE_H, CURVE_W, 3), 255, np.uint8)
    m = CURVE_MARGIN
    img[m, m:-m] = img[-m - 1, m:-m] = img[m:-m, m] = img[m:-m, -m - 1] = 160
    xs = np.array([p[0] for p in points], np.float64)
    ys = np.array([p[1] for p in points], np.float64)
    finite = np.isfinite(ys)
    if not finite.any():
        return img

    def scale(v, lo, hi, n):
        span = hi - lo
        return (v - lo) / span * (n - 1) if span > 0 else np.full_like(v, (n - 1) / 2)

    lo, hi = ys[finite].min(), ys[finite].max()
    px = m + 1 + scale(xs, xs.min(), xs.max(), CURVE_W - 2 * m - 2)
    py = CURVE_H - m - 2 - scale(np.where(finite, ys, lo), lo, hi, CURVE_H - 2 * m - 2)
    for i in range(len(points) - 1):
        if not (finite[i] and finite[i + 1]):
            continue
        n = int(max(abs(px[i + 1] - px[i]), abs(py[i + 1] - py[i]))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        cols = np.rint(px[i] + t * (px[i + 1] - px[i])).astype(int)
        rows = np.rint(py[i] + t * (py[i + 1] - py[i])).astype(int)
        img[rows, cols] = (31, 119, 180)
    return img


class ScalarLogger:
    def __init__(self, out_dir: Optional[str] = None, curves: bool = False,
                 tensorboard: bool = False):
        self.out_dir = out_dir
        self.curves = curves
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self._since_flush: Dict[str, list] = collections.defaultdict(list)
        self._history: Dict[str, list] = collections.defaultdict(list)
        self._t_last: Optional[float] = None
        self._step_last = 0
        self._tb = None
        if tensorboard and out_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception as e:  # the package is optional: say so, go on
                print(f"tensorboard logging unavailable: {e}", flush=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._since_flush[k].append(float(v))

    def log_images(self, step: int, tag: str, images) -> None:
        """TensorBoard images of NHWC ``images`` in [-1, 1] (pix2pix's
        inputs, outputs and targets); nothing without TensorBoard."""
        if self._tb is None:
            return
        arr = np.clip((np.asarray(images, np.float32) + 1.0) / 2.0, 0.0, 1.0)
        self._tb.add_images(tag, arr, step, dataformats="NHWC")
        self._tb.flush()

    def flush(self, step: int, extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Print and record the means since the last flush (plus ``extra``,
        e.g. eval scores or an ``aux_skip/<kind>`` count); returns them."""
        means = {k: sum(v) / len(v) for k, v in self._since_flush.items() if v}
        if extra:
            means.update(extra)
        now = time.time()
        if self._t_last is not None and step > self._step_last:
            means["sec_per_step"] = (now - self._t_last) / (step - self._step_last)
        self._t_last, self._step_last = now, step
        line = "  ".join(f"{k} {v:.5g}" for k, v in sorted(means.items()))
        print(f"step {step}  {line}", flush=True)
        if self.out_dir:
            with open(os.path.join(self.out_dir, "log.jsonl"), "a") as f:
                f.write(json.dumps({"step": step, **means}) + "\n")
        for k, v in means.items():
            self._history[k].append((step, v))
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        if self._tb is not None:
            self._tb.flush()
        self._since_flush.clear()
        if self.curves and self.out_dir:
            self._write_curves()
        return means

    def _write_curves(self) -> None:
        for k, hist in self._history.items():
            if len(hist) < 2:
                continue
            with open(os.path.join(self.out_dir, f"{k.replace('/', '_')}.png"), "wb") as f:
                f.write(png_bytes(curve_image(hist)))
