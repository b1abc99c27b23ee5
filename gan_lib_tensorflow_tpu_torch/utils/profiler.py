"""Profiling hooks (port of ``gan_lib_tensorflow_tpu/utils/profiler.py:
15-70``): a device barrier, a step timer in images per second per card, a
``torch.profiler`` trace that the train loop opens and closes around its
``--trace-steps`` window, and the port's span recorder.

The recorder: ``span(name, **attrs)`` marks a stretch of host time at a
layer boundary (a context manager), ``count(name, n)`` adds to a counter of
the innermost open span. Off (the default) ``span`` hands back one shared
no-op context after a single flag test and ``count`` returns at the same
test: nothing is allocated and the device is not touched. ``enable()``
turns it on; spans then go into a preallocated list in memory, each with
its name, start and end, parent span, thread id, the loop's step number and
attributes; ``drain()`` turns it off and hands them back. A span given
``step=`` sets the step number of every span opened after it. Times are
``time.time_ns()``, the clock of ``torch.profiler``'s events (its
approximate clock is converted to Unix time), so a trace's device
operations can be placed under the spans their launches were made in.
While on, each wait of the host for the device is counted as ``host_syncs``
(CUDA's sync debug mode set to warn, each warning counted, not printed).

Spans of the port, by layer: ``data.batch`` > ``data.indices``,
``data.upload``, ``data.gather`` (``data/device_cache.py``),
``data.queue_wait`` (``parallel/prefetch.py``); ``step`` > ``step.fakes``,
``step.d_update`` (``i``) > ``d.loss`` (> ``d.penalty``), ``d.backward``,
``d.allreduce``, ``d.optimizer``; ``step.g_update`` > ``g.loss``,
``g.backward``, ``g.allreduce``, ``g.optimizer``; ``step.ema``
(``train/step.py``, ``losses/gradient_penalty.py``);
``kernel.power_iteration`` (``path``, ``weights``), ``kernel.fadein``,
``kernel.batch_norm`` (each forward call) (``ops/``); ``train_step <n>`` (``train/loop.py``, inside a trace window).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def hard_sync(device=None) -> None:
    """Wait until the rank's device has finished its queued work (nothing on
    the CPU)."""
    dev = torch.device(device) if device is not None else None
    if (dev is None and torch.cuda.is_available()) or (dev is not None and dev.type == "cuda"):
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock images per second over ``tick``-ed steps, synchronized with
    the device at both ends. ``n_cards`` is the number of distinct cards
    the run uses (a mesh's ``n_cards``): two ranks on one card are one card,
    so the per-card rate is not divided by the rank count."""

    def __init__(self, images_per_step: int, n_cards: int = 1, device=None):
        self.images_per_step = images_per_step
        self.n_cards = n_cards
        self.device = device
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self) -> None:
        hard_sync(self.device)
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def stop(self) -> dict:
        hard_sync(self.device)
        dt = time.perf_counter() - self._t0
        ips = self._steps * self.images_per_step / dt
        return {"steps": self._steps, "seconds": dt,
                "sec_per_step": dt / max(self._steps, 1),
                "images_per_sec": ips, "images_per_sec_per_card": ips / self.n_cards}


def start_trace() -> torch.profiler.profile:
    """Start a ``torch.profiler`` trace of the host and, with a card, the
    device, and the span recorder; ``stop_trace`` writes both."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    enable()
    return prof


def stop_trace(prof: torch.profiler.profile, trace_dir: str, device=None) -> str:
    """Wait for the device, stop ``prof`` and the span recorder, and write
    the Chrome trace with the recorder's spans in it as
    ``trace_dir/trace_rank<r>.json``; returns the path."""
    hard_sync(device)
    prof.stop()
    recording = drain()
    os.makedirs(trace_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(chrome_events(recording, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
    print(f"[profiler] trace written to {path}", flush=True)
    return path


# --- the span recorder ------------------------------------------------------

_on = False               # the one flag every span and count tests
_now = time.time_ns       # torch.profiler's clock, in Unix nanoseconds
_SYNC_WARNING = "called a synchronizing CUDA operation"
HOST_SYNCS = "host_syncs"


@dataclasses.dataclass
class Recording:
    """What ``drain`` hands back: the closed spans in the order they were
    opened (``parent`` is an index into ``spans``, -1 for none), each
    counter's total, and each recording thread's ``threading.get_ident()``
    by its native id (a trace names the threads of CUDA runtime calls by
    the former)."""
    spans: List["Span"]
    counts: Dict[str, int]
    threads: Dict[int, int]


class _Noop:
    """The context every span is while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One span: ``name``, ``start`` and ``end`` (ns on ``torch.profiler``'s
    clock), ``parent`` (index of the enclosing span of its thread, -1 for
    none), ``tid`` (the thread's native id), ``step`` (the loop's step
    number when it opened), ``attrs`` and ``counts`` (counters added while
    it was the thread's innermost span)."""
    __slots__ = ("name", "attrs", "start", "end", "parent", "tid", "step", "counts", "index")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start = self.end = None
        self.parent, self.tid, self.step, self.counts, self.index = -1, 0, None, None, -1

    def __enter__(self):
        rec = _rec
        stack = _stack()
        self.parent = stack[-1].index if stack else -1
        self.tid = _local.tid
        if "step" in self.attrs:
            rec.step = self.attrs["step"]
        self.step = rec.step
        self.index = rec.put(self)
        stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = _now()
        _local.stack.pop()
        return False


class _Recorder:
    """The spans of one ``enable``/``drain`` period (``_rec``)."""

    def __init__(self, capacity: int = 0):
        self.buf: list = [None] * capacity
        self.next_index = itertools.count()
        self.lock = threading.Lock()
        self.loose: Dict[str, int] = {}   # counts made outside every span
        self.step = None
        self.warnings = None              # the catch_warnings of the sync count
        self.show = None                  # the showwarning it stands in for
        self.sync_mode = 0                # CUDA's sync debug mode before it

    def put(self, s: Span) -> int:
        i = next(self.next_index)
        if i >= len(self.buf):
            with self.lock:
                while i >= len(self.buf):
                    self.buf.extend([None] * max(len(self.buf), 1024))
        self.buf[i] = s
        return i


_rec = _Recorder()
_local = threading.local()
_threads: Dict[int, int] = {}  # native id: threading.get_ident(), of every recording thread


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        _threads[_local.tid] = threading.get_ident()
        return _local.stack


def span(name: str, **attrs):
    """A context manager marking one span ``name`` with ``attrs``; the shared
    no-op while the recorder is off."""
    if not _on:
        return _NOOP
    return Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's innermost open span
    (outside every span, to the recording's loose count); nothing while the
    recorder is off."""
    if not _on:
        return
    stack = _stack()
    if stack:
        s = stack[-1]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n
    else:
        with _rec.lock:
            _rec.loose[name] = _rec.loose.get(name, 0) + n


def enabled() -> bool:
    return _on


def _count_sync(message, category, filename, lineno, file=None, line=None) -> None:
    if _SYNC_WARNING in str(message):
        count(HOST_SYNCS)
    else:
        _rec.show(message, category, filename, lineno, file, line)


def enable(capacity: int = 1 << 16) -> None:
    """Start recording into a list of ``capacity`` spans (grown if a period
    opens more). On an initialized card the host's waits for it are counted
    as ``host_syncs`` until ``drain``."""
    global _on, _rec
    if _on:
        drain()
    _rec = _Recorder(capacity)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _rec.warnings, _rec.sync_mode = warnings.catch_warnings(), torch.cuda.get_sync_debug_mode()
        _rec.warnings.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        _rec.show, warnings.showwarning = warnings.showwarning, _count_sync
        torch.cuda.set_sync_debug_mode("warn")
    _on = True


def drain() -> Recording:
    """Stop recording and hand back the closed spans and the counters; the
    recorder is left empty. Spans still open are dropped."""
    global _on
    _on = False
    rec = _rec
    if rec.warnings is not None:
        torch.cuda.set_sync_debug_mode(rec.sync_mode)
        rec.warnings.__exit__(None, None, None)
        rec.warnings = None
    closed = [s for s in rec.buf if s is not None and s.end is not None]
    rec.buf = []
    where = {s.index: i for i, s in enumerate(closed)}
    counts = dict(rec.loose)
    for i, s in enumerate(closed):
        s.index, s.parent = i, where.get(s.parent, -1)
        for k, v in (s.counts or {}).items():
            counts[k] = counts.get(k, 0) + v
    return Recording(closed, counts, dict(_threads))


def chrome_events(recording: Recording, base_ns: int = 0) -> List[dict]:
    """The spans as Chrome trace events on a ``torch.profiler`` trace's
    clock (``base_ns``: the exported trace's ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    out = []
    for s in recording.spans:
        args = {**s.attrs, "step": s.step, **(s.counts or {})}
        if s.parent >= 0:
            args["parent"] = recording.spans[s.parent].name
        out.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                    "tid": s.tid, "ts": (s.start - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3, "args": args})
    return out
