"""The program's own spans in a traced window: each device operation and each
idle gap put under the innermost span of the program (its span recorder,
``gan_lib_tensorflow_tpu_torch/utils/profiler.py``) the host was in, on the
clock ``torch.profiler``'s events use, and what the readers
``metrics/data_wait_ms.py``, ``step_launch_ms.py``, ``step_idle_ms.py`` and
``host_syncs.py`` read from them (``ctx.program``, a ``ProgramTrace``).

An operation goes under the innermost span open at its launch's runtime
call: first on the launching thread, else on any thread (the autograd
engine's device thread launches the backward's kernels while the step's
thread waits in ``d.backward``). A gap goes under the innermost span open,
on any thread, when it began, and is named by the harness's span and the
program's span path: ``bench.step/step/step.d_update/d.backward``.

``run.py`` does not turn the recorder on yet, so a ``--trace 1`` run has no
``ctx.program`` and the four readers read nothing. Until it does,

    python3 -m gan_bench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced window of the cell as ``run.py`` does, with the recorder on
from the window's first mark to the closing synchronise, and prints on
standard error, before ``run.py``'s own lines, how far the recorder's clock
read just before each of the window's marks lies from that mark's
``cudaEventRecord``, the operations (and their time) under no program span,
the idle split by span, and whether the idle inside and outside the ``step``
spans adds up to the window's; then ``run.py``'s result line with the four
metrics and the program's idle gaps added.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "step"
WAITS = ("data.upload", "data.queue_wait")
HOST_SYNCS = "host_syncs"
UNITS = {"data_wait_ms": "ms/step", "step_launch_ms": "ms/step", "step_idle_ms": "ms/step",
         "host_syncs": "count/step"}


@dataclasses.dataclass
class ProgramTrace:
    """A window's program spans (the recorder's, in opening order: ``name``,
    ``start``, ``end``, ``parent`` index, ``tid``, ``counts``), its idle
    intervals on the same clock, the device operations (and their seconds)
    in the window, under no span, and placed by their launching thread; the
    host's CUDA runtime calls in the window (name: [ns, calls]) and the
    thread ids the trace gives them."""
    spans: list
    idle: List[Tuple[int, int]]
    unplaced_ops: int = 0
    unplaced_s: float = 0.0
    ops: int = 0
    op_s: float = 0.0
    own_thread: int = 0
    runtime: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    launch_tids: Dict[tuple, int] = dataclasses.field(default_factory=dict)


class SpanIndex:
    """The innermost program span open at a host time, on one thread or on
    any (spans of one thread nest)."""

    def __init__(self, spans: Sequence):
        self.spans = spans
        self.by_tid: Dict[int, Tuple[List[int], List[int]]] = {}
        for i in sorted(range(len(spans)), key=lambda i: spans[i].start):
            starts, ids = self.by_tid.setdefault(spans[i].tid, ([], []))
            starts.append(spans[i].start)
            ids.append(i)

    def _on(self, tid: int, t: int) -> Optional[int]:
        starts, ids = self.by_tid[tid]
        k = bisect.bisect_right(starts, t) - 1
        i = ids[k] if k >= 0 else -1
        while i >= 0 and self.spans[i].end < t:
            i = self.spans[i].parent
        return i if i >= 0 else None

    def at(self, t: int, tid: Optional[int] = None) -> Optional[int]:
        if tid in self.by_tid:
            i = self._on(tid, t)
            if i is not None:
                return i
        found = [i for i in (self._on(k, t) for k in self.by_tid) if i is not None]
        return max(found, key=lambda i: self.spans[i].start) if found else None

    def path(self, i: Optional[int]) -> str:
        names = []
        while i is not None and i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))


def idle_intervals(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The gaps between merged busy intervals within ``[lo, hi]``."""
    out, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def overlap(intervals: List[Tuple[int, int]], spans: List[Tuple[int, int]]) -> int:
    """Nanoseconds of sorted, disjoint ``intervals`` inside the sorted,
    disjoint ``spans``."""
    total, j = 0, 0
    for s, e in intervals:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            total += max(0, min(e, spans[k][1]) - max(s, spans[k][0]))
            k += 1
    return total


def step_spans(trace: ProgramTrace) -> List[Tuple[int, int]]:
    return sorted((s.start, s.end) for s in trace.spans if s.name == STEP)


def gap_names(trace: ProgramTrace, harness_at, top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps as ``[harness span/program path, s]``."""
    index = SpanIndex(trace.spans)
    gaps = sorted(trace.idle, key=lambda g: (g[0] - g[1], g[0]))[:top]
    out = []
    for s, e in gaps:
        name = "/".join(p for p in (harness_at(s), index.path(index.at(s))) if p)
        out.append([name, (e - s) * 1e-9])
    return out


def idle_by_span(trace: ProgramTrace) -> Dict[str, float]:
    """Seconds of idle device time by the program span path the host was in
    when each gap began ("" outside every span)."""
    index = SpanIndex(trace.spans)
    out: Dict[str, float] = collections.Counter()
    for s, e in trace.idle:
        out[index.path(index.at(s))] += (e - s) * 1e-9
    return dict(out)


# --- reading a stopped torch.profiler over the window ------------------------

def read_profile(prof, recording, lo: int, hi: int, busy: List[Tuple[int, int]]
                 ) -> ProgramTrace:
    """Place each device operation of ``prof`` within ``[lo, hi]`` under the
    recording's spans by its launch's runtime call."""
    import torch

    spans = recording.spans
    index = SpanIndex(spans)
    # the trace names a runtime call's thread by its pthread id cut to 32 bits
    native = {ident & 0xFFFFFFFF: tid for tid, ident in recording.threads.items()}
    cpu = torch.autograd.DeviceType.CPU
    launch: Dict[int, Tuple[int, Optional[int]]] = {}
    device = []
    out = ProgramTrace(spans, idle_intervals(busy, lo, hi))
    runtime, launch_tids = collections.defaultdict(lambda: [0, 0]), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            if e.correlation_id():
                tid = native.get(e.device_resource_id() & 0xFFFFFFFF)
                launch[e.correlation_id()] = (e.start_ns(), tid)
                if lo <= e.start_ns() <= hi:
                    runtime[e.name()][0] += e.end_ns() - e.start_ns()
                    runtime[e.name()][1] += 1
                    launch_tids[(e.device_resource_id(), tid)] += 1
        elif not e.is_user_annotation():
            device.append(e)
    out.runtime, out.launch_tids = dict(runtime), dict(launch_tids)
    for e in device:
        if e.end_ns() < lo or e.start_ns() > hi:
            continue
        out.ops += 1
        out.op_s += (e.end_ns() - e.start_ns()) * 1e-9
        t = launch.get(e.correlation_id())
        placed = index.at(*t) if t is not None else None
        if placed is None:
            out.unplaced_ops += 1
            out.unplaced_s += (e.end_ns() - e.start_ns()) * 1e-9
        elif t[1] in index.by_tid and placed == index._on(t[1], t[0]):
            out.own_thread += 1
    return out


def _quantiles(xs: List[float]) -> str:
    xs = sorted(xs)
    return (f"median {statistics.median(xs):.1f} us, largest {max(xs, key=abs):.1f} us, "
            f"least {min(xs, key=abs):.1f} us over {len(xs)} marks")


def main(argv=None) -> int:
    import argparse
    import json

    import torch
    from gan_lib_tensorflow_tpu_torch.utils import profiler

    from . import run
    from . import trace as tracing

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run._cache_dirs()
    held: dict = {}

    class Clock(run._Clock):
        """The window's marks, each with the recorder's clock read just
        before it; the recorder turns on with the window."""

        def __init__(self, device):
            super().__init__(device)
            self.readings: List[int] = []
            held["clock"] = self
            profiler.enable()

        def _event(self):  # run._Clock's, with the clock read around the record
            if not self.cuda:
                return super()._event()
            ev = torch.cuda.Event(enable_timing=True)
            before = profiler._now()
            ev.record()
            self.readings.append((before, profiler._now()))
            return ev

    sync, collect = run._sync, tracing.collect

    def closing_sync(device) -> None:
        if profiler.enabled():  # the window's end
            held["recording"] = profiler.drain()
        sync(device)

    def read(prof, steps: int, wall_s: float):
        tr = collect(prof, steps, wall_s)
        cpu = torch.autograd.DeviceType.CPU
        marks = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == cpu and e.name().startswith("cudaEventRecord"))
        readings = held["clock"].readings
        if marks and len(marks) == len(readings):
            print("clock: mark's cudaEventRecord start_ns minus the recorder's reading "
                  "just before it: "
                  f"{_quantiles([(m - r[0]) / 1e3 for m, r in zip(marks, readings)])}; the "
                  "reading just after it minus start_ns: "
                  f"{_quantiles([(r[1] - m) / 1e3 for m, r in zip(marks, readings)])}",
                  file=sys.stderr)
        else:
            print(f"clock: {len(marks)} marks in the trace, {len(readings)} readings",
                  file=sys.stderr)
        lo = marks[0] if marks else 0
        hi = lo + int(round(tr.window_s * 1e9))
        busy = tracing._union([(o.start, o.end) for o in tr.ops], lo, hi)
        prog = read_profile(prof, held["recording"], lo, hi, busy)
        harness = tracing._SpanIndex(tracing.host_spans(marks, steps))
        ctx = run.Context(steps=steps, images_per_step=0, wall_s=wall_s, step_ms=[],
                          peak_bytes=0, setup_s=0.0, counts={})
        ctx.program = prog
        idle_ns = sum(e - s for s, e in prog.idle)
        in_step = overlap(prog.idle, step_spans(prog))
        print(f"coverage: {prog.unplaced_ops} of {prog.ops} device operations "
              f"({prog.unplaced_s:.6f} of {prog.op_s:.6f} s) under no program span; "
              f"{prog.own_thread} placed on their launching thread's spans, over threads "
              f"{sorted(SpanIndex(prog.spans).by_tid)}", file=sys.stderr)
        calls = sorted(prog.runtime.items(), key=lambda kv: -kv[1][0])
        print(f"runtime: the host in CUDA runtime calls "
              f"{sum(v[0] for _, v in calls) / 1e6 / max(steps, 1):.3f} ms/step: "
              + ", ".join(f"{n} {v[0] / 1e6 / max(steps, 1):.3f} ms ({v[1] / max(steps, 1):.0f})"
                          for n, v in calls[:6])
              + "; by thread (trace's id, recorder's): "
              + f"{sorted(prog.launch_tids.items(), key=lambda kv: -kv[1])[:3]}",
              file=sys.stderr)
        print(f"idle: {in_step * 1e-9:.6f} s inside the step spans + "
              f"{(idle_ns - in_step) * 1e-9:.6f} s outside = {idle_ns * 1e-9:.6f} s; the "
              f"window's (window - busy) {tr.window_s - tr.busy_s:.6f} s", file=sys.stderr)
        for path, s in sorted(idle_by_span(prog).items(), key=lambda kv: -kv[1]):
            print(f"idle by span: {1e3 * s / max(steps, 1):9.3f} ms/step  {path or '(none)'}",
                  file=sys.stderr)
        held["metrics"] = {m: run.module("metrics", m).read(ctx) for m in UNITS}
        held["idle_gaps"] = gap_names(prog, lambda t: harness.at(t) or tracing.WINDOW)
        return tr

    run._Clock, run._sync, tracing.collect = Clock, closing_sync, read
    try:
        result = run.run_cell(args.workload, args.seed, args.seconds, True)
    except run.NoCard as e:
        print(f"gan_bench: {e}", file=sys.stderr)
        return 3
    finally:
        run._Clock, run._sync, tracing.collect = Clock.__base__, sync, collect
    result.pop("_where")
    result["metrics"].update({k: {"value": v, "unit": UNITS[k]}
                              for k, v in held["metrics"].items() if v is not None})
    result.setdefault("breakdown", {})["program_idle_gaps"] = held["idle_gaps"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
