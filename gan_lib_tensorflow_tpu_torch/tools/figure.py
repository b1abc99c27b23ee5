"""Figures drawn in numpy on a uint8 RGB canvas, for the plot tools and
``--curves`` (the card's machine has no matplotlib, and the port no font).

A ``Panel`` is a framed plot area of a canvas with its own data limits:
polylines (solid or dashed, one or more pixels wide), markers, and thin
vertical rules, on linear or logarithmic axes. Colours are matplotlib's
``tab10`` RGBs, so a figure here and the reference's figure of the same run
use the same colour for the same series. No text is drawn: a figure's
title, axis labels and legend travel as PNG text chunks
(``utils/images.py:png_bytes(image, text)``), built by ``describe``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# matplotlib's tab10 cycle, in order (C0 ... C9)
TAB10 = {"tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14),
         "tab:green": (44, 160, 44), "tab:red": (214, 39, 40),
         "tab:purple": (148, 103, 189), "tab:brown": (140, 86, 75),
         "tab:pink": (227, 119, 194), "tab:gray": (127, 127, 127),
         "tab:olive": (188, 189, 34), "tab:cyan": (23, 190, 207)}
CYCLE = list(TAB10)
BLACK = (0, 0, 0)
FRAME_GREY = 160
RULE_GREY = 217  # matplotlib's "0.85"
GREY = 128       # matplotlib's "gray"


def canvas(height: int, width: int) -> np.ndarray:
    """A white uint8 ``[H, W, 3]`` canvas."""
    return np.full((height, width, 3), 255, np.uint8)


def limits(values, log_base: Optional[float] = None, pad: float = 0.0) -> Tuple[float, float]:
    """The finite (and, on a log axis, positive) range of ``values``, widened
    by ``pad`` of its span on each side (in log space on a log axis);
    (0, 1) when nothing is left."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v) & (v > 0 if log_base else True)]
    if not v.size:
        return (1.0, 10.0) if log_base else (0.0, 1.0)
    lo, hi = float(v.min()), float(v.max())
    if log_base:
        llo, lhi = math.log(lo, log_base), math.log(hi, log_base)
        span = lhi - llo
        return log_base ** (llo - pad * span), log_base ** (lhi + pad * span)
    span = hi - lo
    return lo - pad * span, hi + pad * span


class Panel:
    """The frame ``top``..``bottom`` x ``left``..``right`` (inclusive pixel
    rows and columns, drawn in grey at once) of ``img``; data map into the
    pixels inside it, ``xlim``/``ylim`` to its first and last ones, on a log
    axis of base ``xlog``/``ylog`` in log space."""

    def __init__(self, img: np.ndarray, top: int, left: int, bottom: int, right: int,
                 xlim: Tuple[float, float], ylim: Tuple[float, float],
                 xlog: Optional[float] = None, ylog: Optional[float] = None):
        self.img, self.top, self.left, self.bottom, self.right = img, top, left, bottom, right
        self.xlim, self.ylim, self.xlog, self.ylog = xlim, ylim, xlog, ylog
        img[top, left:right + 1] = img[bottom, left:right + 1] = FRAME_GREY
        img[top:bottom + 1, left] = img[top:bottom + 1, right] = FRAME_GREY

    @staticmethod
    def _scale(v, lim, log, n):
        lo, hi = lim
        if log:
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.where(v > 0, np.log(np.where(v > 0, v, 1.0)) / math.log(log), np.nan)
            lo, hi = math.log(lo, log), math.log(hi, log)
        span = hi - lo
        return (v - lo) / span * (n - 1) if span > 0 else np.full_like(v, (n - 1) / 2)

    def px(self, x) -> np.ndarray:
        """Column (float) of data ``x``."""
        x = np.asarray(x, np.float64)
        return self.left + 1 + self._scale(x, self.xlim, self.xlog, self.right - self.left - 1)

    def py(self, y) -> np.ndarray:
        """Row (float) of data ``y``."""
        y = np.asarray(y, np.float64)
        return self.bottom - 1 - self._scale(y, self.ylim, self.ylog, self.bottom - self.top - 1)

    def _put(self, rows: np.ndarray, cols: np.ndarray, color) -> None:
        keep = ((rows > self.top) & (rows < self.bottom)
                & (cols > self.left) & (cols < self.right))
        self.img[rows[keep], cols[keep]] = color

    def line(self, xs, ys, color, width: int = 1,
             dash: Optional[Tuple[int, int]] = None) -> None:
        """A polyline through the points; a segment with a non-finite end is
        left out. ``width`` pixels wide (rows added below and above);
        ``dash`` = (on, off) pixels along the line."""
        px, py = self.px(xs), self.py(ys)
        ok = np.isfinite(px) & np.isfinite(py)
        along = 0.0
        for i in range(len(px) - 1):
            if not (ok[i] and ok[i + 1]):
                continue
            n = int(max(abs(px[i + 1] - px[i]), abs(py[i + 1] - py[i]))) + 1
            t = np.linspace(0.0, 1.0, n + 1)
            cols = np.rint(px[i] + t * (px[i + 1] - px[i])).astype(int)
            rows = np.rint(py[i] + t * (py[i + 1] - py[i])).astype(int)
            if dash is not None:
                dist = along + t * math.hypot(px[i + 1] - px[i], py[i + 1] - py[i])
                along = float(dist[-1])
                on = np.mod(dist, dash[0] + dash[1]) < dash[0]
                cols, rows = cols[on], rows[on]
            for dy in range(-(width // 2), width - width // 2):
                self._put(rows + dy, cols, color)

    def markers(self, xs, ys, color, radius: int = 2, square: bool = False) -> None:
        """A filled disc (or square) of ``radius`` pixels at each finite point."""
        px, py = self.px(xs), self.py(ys)
        ok = np.isfinite(px) & np.isfinite(py)
        cols0, rows0 = np.rint(px[ok]).astype(int), np.rint(py[ok]).astype(int)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                if square or dx * dx + dy * dy <= radius * radius:
                    self._put(rows0 + dy, cols0 + dx, color)

    def vrule(self, x: float, grey: int = RULE_GREY, dotted: bool = False) -> int:
        """A one-pixel vertical rule over the panel's height at data ``x``
        (one pixel in three when ``dotted``); returns its column."""
        col = int(np.rint(self.px(x)))
        rows = np.arange(self.top + 1, self.bottom)
        if dotted:
            rows = rows[::3]
        self._put(rows, np.full_like(rows, col), grey)
        return col

    def xticks(self, xs, length: int = 5) -> None:
        """Tick marks up from the frame's bottom edge at data ``xs``."""
        for x in xs:
            col = int(np.rint(self.px(x)))
            if self.left < col < self.right:
                self.img[self.bottom - length:self.bottom, col] = FRAME_GREY

    def yticks(self, ys, length: int = 5) -> None:
        """Tick marks in from the frame's left edge at data ``ys``."""
        for y in ys:
            row = int(np.rint(self.py(y)))
            if self.top < row < self.bottom:
                self.img[row, self.left + 1:self.left + 1 + length] = FRAME_GREY


def decades(lim: Tuple[float, float]) -> list:
    """The powers of ten inside ``lim`` (a log axis' major ticks)."""
    lo, hi = lim
    return [10.0 ** e for e in range(math.floor(math.log10(lo)), math.ceil(math.log10(hi)) + 1)
            if lo <= 10.0 ** e <= hi]


def describe(panels: Sequence[Dict]) -> str:
    """The figure's text as the ``Description`` of its PNG, one line per
    panel: its title, axis labels and scales, and each series' legend entry
    with its colour and style."""
    lines = []
    for i, p in enumerate(panels, 1):
        axes = f"x: {p['x']}" + (f" ({p['xscale']})" if p.get("xscale") else "")
        axes += f"; y: {p['y']}" + (f" ({p['yscale']})" if p.get("yscale") else "")
        if p.get("y2"):
            axes += f"; right y: {p['y2']}"
        series = "; ".join(f"{label}: {style}" for label, style in p.get("series", []))
        extra = f"; {p['notes']}" if p.get("notes") else ""
        lines.append(f"panel {i} '{p['title']}': {axes}; series: {series}{extra}")
    return "\n".join(lines)


def save(path: str, img: np.ndarray, title: str, panels: Sequence[Dict]) -> None:
    """Write ``img`` as a PNG whose ``Title`` and ``Description`` text
    chunks carry the figure's text."""
    import os

    from ..utils.images import png_bytes

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img, {"Title": title, "Description": describe(panels)}))
