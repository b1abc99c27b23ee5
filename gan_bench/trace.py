"""The traced window's device operations, read from ``torch.profiler``'s
events of the device's activity (no trace file is written): each kernel,
copy and set with its device interval and the benchmark span the host was
in when it launched it (``bench.data`` around ``next(batches)``,
``bench.step`` around the step; the spans are bounded by the harness's own
``cudaEventRecord`` calls at each step's marks); the union of their
intervals within the window (``busy_s``); the window's length
(``window_s``); and the ``breakdown``: the device operations with the most
time, and the longest idle gaps by the span the host was in when each
began.

Kinds of kernel are told by name (``KINDS``, frozen from the program's
``profile_torch_step.py``)."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

SPANS = ("bench.data", "bench.step")
WINDOW = "bench.window"
KINDS = [("hand-written", ("power_iteration", "fadein")),
         ("sort", ("radixsort", "sort")),
         ("conv/matmul", ("xmma", "cudnn", "conv", "gemm", "nvjet")),
         ("cast/copy", ("copy",)),
         ("reduction", ("reduce_kernel",)),
         ("pooling", ("pool",)),
         ("adam/ema (foreach)", ("multi_tensor", "foreach")),
         ("elementwise", ("elementwise",))]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


@dataclasses.dataclass
class Op:
    name: str
    start: int   # ns, on the profiler's clock
    end: int
    span: Optional[str]

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    busy_s: float
    window_s: float
    breakdown: dict


class _SpanIndex:
    """Which benchmark span holds a host time (the spans do not overlap)."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def host_spans(marks: List[int], steps: int) -> List[Tuple[int, int, str]]:
    """The host's spans from the window's ``cudaEventRecord`` calls, in time
    order: step k's mark, its data mark, ..., the closing mark (``2 steps +
    1`` of them; any other count gives none)."""
    if len(marks) != 2 * steps + 1:
        return []
    out = []
    for k in range(steps):
        out.append((marks[2 * k], marks[2 * k + 1], SPANS[0]))
        out.append((marks[2 * k + 1], marks[2 * k + 2], SPANS[1]))
    return out


def collect(prof, steps: int, wall_s: float) -> Trace:
    """Read a stopped ``torch.profiler.profile`` of the device's activity over
    one window of ``steps`` steps (``wall_s`` on the host's clock): the
    CUDA runtime calls, each device operation and its launch's correlation.
    The window runs from its first mark to the end of its last operation."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    marks, launch_at, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            if e.name().startswith("cudaEventRecord"):
                marks.append(e.start_ns())
            if e.correlation_id():
                launch_at[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append(e)
    marks.sort()
    spans = host_spans(marks, steps)
    if len(marks) != 2 * steps + 1:
        print(f"trace: {len(marks)} cudaEventRecord calls where the window made "
              f"{2 * steps + 1}: no operation is given a host span", file=sys.stderr)
    index = _SpanIndex(spans)
    ops = []
    for e in device:
        t = launch_at.get(e.correlation_id()) if e.correlation_id() else None
        ops.append(Op(e.name(), e.start_ns(), e.end_ns(), None if t is None else index.at(t)))
    if marks and ops:
        lo, hi = marks[0], max(marks[-1], max(o.end for o in ops))
    else:
        lo, hi = 0, int(wall_s * 1e9)
    busy = _union([(o.start, o.end) for o in ops], lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    return Trace(ops, busy_ns * 1e-9, (hi - lo) * 1e-9, _breakdown(ops, busy, lo, hi, index))


def _breakdown(ops: List[Op], busy, lo: int, hi: int, index: _SpanIndex) -> dict:
    by_name: Dict[str, float] = collections.Counter()
    for o in ops:
        by_name[o.name] += o.seconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(key=lambda g: (-g[0], g[1]))
    idle = [[index.at(t) or WINDOW, g * 1e-9] for g, t in gaps[:10]]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": idle}
