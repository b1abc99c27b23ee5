"""Run one cell of the benchmark (``BENCHMARK.json``) once and print its
result as the last line of standard output.

    python3 -m gan_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up builds the program's train state with its own builders
(``builders/<config>.py``), loads the weights the benchmark makes from the
seed (``weights.py``), fills the store with the seed's images
(``traffic.py``) and drives the first three steps through the window's own
call, reading what the comparison needs. The window then calls the step,
batch after batch, until ``--seconds`` have passed, and synchronises. With
``--trace 1`` a ``torch.profiler`` trace of the window gives the per-layer
metrics; with ``--trace 0`` the end-to-end ones. Each metric is read by its
own file, ``metrics/<name>.py``. Once the window has closed and the
program's state is freed, the plain reference (``reference/<config>.py``)
follows the same three steps in float32 and ``correct.py`` compares.

Exits 3 without a result when the cell's cards are missing, 4 when the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gan_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_lib_tensorflow_tpu")
FIRST_STEPS = 3   # the steps the reference follows
WARM_STEPS = 1    # one more before the window


class NoCard(RuntimeError):
    pass


def _process_age(fallback_start: float) -> float:
    """Seconds since this process started (Linux's clock ticks, 10 ms), else
    since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_start


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's nvcc builds go to its own ``_build/`` there)."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


# --- what the harness finds by name -------------------------------------

def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``gan_bench/<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return importlib.import_module(f"gan_bench.{kind}.{name}")


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    steps: int
    images_per_step: int
    wall_s: float
    step_ms: List[float]
    peak_bytes: int
    setup_s: float
    counts: dict
    ops: list = dataclasses.field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    kind: Callable[[str], str] = str


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    kink_margin: float = 0.0

    @classmethod
    def load(cls, bench: dict, name: str, overrides: Optional[dict] = None) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        spec = load_json("workloads", name)
        cfg = load_json("configs", entry["config"])
        traffic, limits = dict(spec["traffic"]), dict(spec["limits"])
        over = overrides or {}
        cfg.update(over.get("config", {}))
        traffic.update(over.get("traffic", {}))
        limits.update(over.get("limits", {}))
        return cls(name, entry, cfg, traffic, limits,
                   float(over.get("kink_margin", spec.get("kink_margin", 0.0))))


# --- the run ---------------------------------------------------------------

class _Clock:
    """Step boundaries: CUDA events on the step's stream (recording one makes
    the host wait for nothing), or the host's clock on the CPU (tests).
    ``mark`` opens a step (and its data span), ``mark_data`` closes the data
    span; in a trace their ``cudaEventRecord`` calls bound the host's spans
    (``trace.py``)."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []
        self._data: list = []

    def _event(self):
        import torch
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self) -> None:
        self.marks.append(self._event())

    def mark_data(self) -> None:
        self._data.append(self._event())

    def step_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _first_steps(prog, leaves: list, weights_seed: int, device) -> dict:
    """Drive the first steps through the window's own call; the program's
    readings (``reference/plain.py`` ``readings``)."""
    from . import weights as wt
    from .reference.plain import readings

    grads, unwatch = prog.watch_first_grads()
    metrics = [prog.run_step(prog.next_batch()) for _ in range(FIRST_STEPS)]
    unwatch()
    start = prog.start_of(wt.make(leaves, weights_seed, device))
    out = readings([{}] * FIRST_STEPS, grads, start, prog.tensors())
    out["losses"] = [{n: (float(v), None) for n, v in m.items() if n in ("d_loss", "g_loss")}
                     for m in metrics]
    out["first_logits"] = prog.first_logits()
    return out


def prepare(cell: Cell, seeds, device, program_hook: Optional[Callable] = None):
    """Set-up: the program built, the benchmark's weights loaded, the first
    steps driven and read. ``(program, its readings)``."""
    from . import weights as wt

    cfg_name = cell.entry["config"]
    t0 = time.perf_counter()
    builder, reference = module("builders", cfg_name), module("reference", cfg_name)
    leaves = reference.leaves(cell.cfg, cell.traffic)
    t1 = time.perf_counter()
    prog = builder.build(cell.cfg, cell.traffic, seeds, device)
    prog.load(wt.make(leaves, seeds.weights, device))
    if program_hook is not None:
        program_hook(prog)
    _sync(device)
    t2 = time.perf_counter()
    readings = _first_steps(prog, leaves, seeds.weights, device)
    _sync(device)
    print(f"set-up: importing the program {t1 - t0:.3f} s, building it with the store and "
          f"weights {t2 - t1:.3f} s, the first {FIRST_STEPS} steps and their readings "
          f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return prog, readings


def check_card(cell: Cell) -> None:
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"{cell.name} needs {chips} CUDA card(s); this machine has "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             require_card: bool = True, overrides: Optional[dict] = None,
             program_hook: Optional[Callable] = None, started: float = _IMPORTED) -> dict:
    """One run of cell ``name``; returns the result's fields. ``overrides``
    (``{"config": {...}, "traffic": {...}, "limits": {...}}``) and
    ``program_hook(prog)`` serve the tests: a small cell on the CPU, a
    fault planted in the program."""
    bench = benchmark()
    cell = Cell.load(bench, name, overrides)
    if require_card:
        check_card(cell)
    import torch

    from . import trace as tracing
    from . import traffic as tr
    from .correct import gaps, judge

    counts = module("counts", cell.entry["config"]).counts(cell.cfg, cell.traffic)
    seeds = tr.Seeds(seed)
    prog, prog_readings = prepare(cell, seeds, device, program_hook)
    for _ in range(WARM_STEPS):
        prog.run_step(prog.next_batch())
    _sync(device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = _process_age(started)

    clock, step_metrics, prof, batch = _Clock(device), [], None, None
    if trace:  # the device's activity only: recording every host op slows the step
        on_card = torch.device(device).type == "cuda"
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA
                                                  if on_card else
                                                  torch.profiler.ProfilerActivity.CPU])
        prof.start()
    t0 = time.perf_counter()
    while True:
        clock.mark()
        if time.perf_counter() - t0 >= seconds:
            break
        batch = prog.next_batch()
        clock.mark_data()
        step_metrics.append(prog.run_step(batch))
    _sync(device)
    wall_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    steps = len(step_metrics)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    finite = [bool(torch.isfinite(torch.stack([v.float() for v in m.values()])).all())
              for m in step_metrics]
    step_ms = clock.step_ms()
    if step_ms:
        print(f"window: {steps} steps in {wall_s:.3f} s; step ms min {min(step_ms):.3f}, median "
              f"{statistics.median(step_ms):.3f}, max {max(step_ms):.3f}, first "
              f"{[round(x, 3) for x in step_ms[:3]]}", file=sys.stderr)
    ctx = Context(steps=steps, images_per_step=prog.images_per_step, wall_s=wall_s,
                  step_ms=step_ms, peak_bytes=peak, setup_s=setup_s, counts=counts,
                  kind=tracing.kind_of)
    breakdown = None
    if prof is not None:
        t_read = time.perf_counter()
        tr_data = tracing.collect(prof, steps, wall_s)
        ctx.ops, ctx.busy_s, ctx.window_s = tr_data.ops, tr_data.busy_s, tr_data.window_s
        breakdown = tr_data.breakdown
        by_span = collections.Counter(o.span for o in tr_data.ops)
        print(f"trace: {len(tr_data.ops)} device operations over {steps} steps, by host "
              f"span {dict(by_span)}; busy {tr_data.busy_s:.6f} s of {tr_data.window_s:.6f} s; "
              f"read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        del prof
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, kind):
        value = module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    del prog, step_metrics, batch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, where = gaps(prog_readings, follow_reference(cell, seeds, device))
    print(f"reference: {FIRST_STEPS} steps followed and compared in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    ok, checks = judge(numbers, cell.limits)
    failed = steps - sum(finite)
    result = {"correct": bool(ok and steps > 0 and failed == 0),
              "attempted": steps, "failed": failed, "metrics": metrics,
              "device": _device(device, cell.entry["chips"], peak, ctx if trace else None)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_where"] = where
    return result


def follow_reference(cell: Cell, seeds, device, steps: int = FIRST_STEPS, **kw) -> dict:
    """The reference's readings of the first steps, from the seed alone (with
    the alternatives of a hinge's kink where the cell sets a margin)."""
    from . import traffic as tr
    from . import weights as wt
    from .reference.plain import no_tf32

    reference = module("reference", cell.entry["config"])
    t = cell.traffic
    margin = kw.pop("kink_margin", cell.kink_margin)
    if margin:
        kw["kink_margin"] = margin
    images = tr.store_images(t, seeds, device)
    stream = tr.StoreStream(images, tr.store_labels(t, seeds, device),
                            cell.cfg.get("n_critic", 1), t["batch"], seeds.store)
    with no_tf32():
        weights = wt.make(reference.leaves(cell.cfg, t), seeds.weights, device)
        return reference.follow(cell.cfg, t, weights, stream, (seeds.g_noise, seeds.d_noise),
                                steps=steps, **kw)


def _num(x: float):
    return x if math.isfinite(x) else None


def _device(device, chips: int, peak: int, ctx: Optional[Context]) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if ctx is not None:
        out.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    return out


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"gan_bench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"gan_bench: this process has loaded {', '.join(found)}", file=sys.stderr)
        return 4
    where = result.pop("_where")
    print(f"card: {_card_line()}", file=sys.stderr)
    print(f"correct: {result['correct']} ({result['failed']} of {result['attempted']} "
          "steps non-finite)", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']}; worst at {where[k]})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
