"""Training loop (port of ``gan_lib_tensorflow_tpu/train/loop.py:28-201``):
auto-resume, steps, the NaN guard, the fade-in schedule, fault injection,
and the periodic log, sample, eval and checkpoint, in the reference's order.
A source with ``yields_stacks`` (on-device sources) is iterated as it is;
any other (host numpy batches) is stacked into ``[n_micro, B, ...]`` and
copied to the card by ``prefetch_to_device``. ``trace_steps`` captures a
``torch.profiler`` trace (``utils/profiler.py``). ``curves`` and
``tensorboard`` go to the ``ScalarLogger`` the loop builds.

On a mesh (``state.mesh``) every rank steps on its rows of each batch;
rank 0 logs, draws the sample grids and writes the checkpoints (every rank
takes part in gathering them), every rank resumes from the same checkpoint
and runs its share of an eval, and a barrier closes the run."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from ..data.base import microbatch_stack
from ..parallel import barrier, data_rows, is_writer, prefetch_to_device
from ..parallel.sharding import spatial_axis_of
from ..utils import profiler
from ..utils.logging import ScalarLogger
from .checkpoint import CheckpointManager
from .state import gathered


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100_000
    log_every: int = 100
    sample_every: int = 1000
    checkpoint_every: int = 5000
    eval_every: int = 0              # 0 = no periodic eval
    out_dir: Optional[str] = None
    curves: bool = False             # a curve PNG per metric under out_dir
    tensorboard: bool = False        # TensorBoard scalars under out_dir/tb
    fault_inject_step: int = 0       # raise after this step (resume testing)
    # trace this many steps with torch.profiler, from the 10th step of the
    # run; as in the reference (loop.py:160-170, 196-198) the window ends
    # after step start + 10 + trace_steps, so it holds trace_steps + 1 steps
    trace_steps: int = 0             # written under <out_dir>/trace


# Faults worth retrying in an eval or sample pause: the reference's backend
# (RPC) faults. Status names match only as line prefixes, so a program error
# that merely mentions "INTERNAL" still propagates; the transport markers
# come only from the RPC layer. CUDA's sticky errors ("CUDA error: ...")
# match neither and propagate at once: the context is lost, a retry cannot
# help.
_TRANSIENT_STATUS_PREFIXES = ("INTERNAL:", "UNAVAILABLE:", "DEADLINE_EXCEEDED:")
_TRANSIENT_TRANSPORT_MARKERS = ("remote_compile", "response body closed",
                                "Connection reset")
_AUX_RETRIES = 2
_AUX_BACKOFF_S = 30.0
# a fault that survives the retries this many consecutive times for the same
# kind of callback is not transient, and is re-raised
_AUX_MAX_CONSECUTIVE_SKIPS = 3


def _is_transient(msg: str) -> bool:
    if any(m in msg for m in _TRANSIENT_TRANSPORT_MARKERS):
        return True
    return any(line.lstrip().startswith(p)
               for line in msg.splitlines()
               for p in _TRANSIENT_STATUS_PREFIXES)


def _run_aux(label: str, fn: Callable[[], Any],
             skip_counts: Optional[dict] = None,
             logger: Optional[ScalarLogger] = None,
             step: int = 0) -> Any:
    """Run an auxiliary callback (a periodic eval or sample). A transient
    fault is retried twice with a backoff, then this one call is skipped
    loudly (printed, and an ``aux_skip/<kind>`` entry in ``log.jsonl``) and
    None returned; the third consecutive skip of one kind re-raises."""
    kind = label.split("@", 1)[0]
    for attempt in range(_AUX_RETRIES + 1):
        try:
            result = fn()
            if skip_counts is not None:
                skip_counts[kind] = 0
            return result
        except RuntimeError as e:
            msg = str(e)
            if not _is_transient(msg):
                raise
            first_line = msg.splitlines()[0] if msg else repr(e)
            if attempt == _AUX_RETRIES:
                n_skips = 1
                if skip_counts is not None:
                    n_skips = skip_counts[kind] = skip_counts.get(kind, 0) + 1
                if n_skips >= _AUX_MAX_CONSECUTIVE_SKIPS:
                    print(f"[loop] {label} failed on {n_skips} consecutive "
                          f"invocations: treating it as deterministic, re-raising",
                          flush=True)
                    raise
                print(f"[loop] {label} SKIPPED after {attempt + 1} transient "
                      f"failures: {first_line}", flush=True)
                if logger is not None:
                    logger.flush(step, extra={f"aux_skip/{kind}": float(n_skips)})
                return None
            print(f"[loop] transient failure in {label} (attempt {attempt + 1}/"
                  f"{_AUX_RETRIES + 1}): {first_line}; retrying in "
                  f"{_AUX_BACKOFF_S:.0f}s", flush=True)
            time.sleep(_AUX_BACKOFF_S)


def device_batches(source: Iterable, n_micro: int, device, mesh=None) -> Iterator:
    """The loop's batches on ``device``: an on-device source's own stacks,
    or a host source's batches stacked by ``n_micro`` and prefetched
    (reference ``train/loop.py:130-154``). On a ``mesh`` an on-device
    source must have been made for it (it yields the rank's rows, and over
    an 'sp' axis the rank's height rows), and a host source's global
    batches are cut to the rank's rows (and height rows) before the copy."""
    spatial = spatial_axis_of(mesh)
    if getattr(source, "yields_stacks", False):
        if getattr(source, "mesh", None) is not mesh:
            raise ValueError(f"{type(source).__name__} was not made for this mesh: "
                             "pass it mesh=")
        if getattr(source, "spatial_axis", None) != spatial:
            raise ValueError(f"{type(source).__name__} was not made for this mesh's "
                             f"'sp' axis: pass it spatial_axis={spatial!r}")
        return iter(source)
    rows = None if mesh is None else data_rows(source.batch_size, mesh)
    return prefetch_to_device(microbatch_stack(source, n_micro), device, rows=rows,
                              mesh=mesh, spatial_axis=spatial)


def train_loop(state, step_fn: Callable, source: Iterable, config: LoopConfig,
               log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
               alpha_fn: Optional[Callable[[int], float]] = None,
               sample_fn: Optional[Callable[[Any, int], None]] = None,
               ckpt: Optional[CheckpointManager] = None,
               logger: Optional[ScalarLogger] = None,
               eval_fn: Optional[Callable[[Any, int], dict]] = None,
               n_micro: int = 1):
    """Run ``step_fn(state, batch)`` from ``state.step`` to
    ``config.total_steps``, resuming first from ``ckpt``'s newest checkpoint
    when there is one. Metrics are read (which waits for the device) only
    on log steps, where non-finite ones raise; they go to ``logger`` (printed,
    and ``log.jsonl`` under its ``out_dir``) and to ``log_fn(step, metrics)``
    when given. ``alpha_fn(step)`` sets the PGGAN fade-in weight
    ``state.alpha`` (a host float) before each step. After step ``it``: log,
    sample, eval, checkpoint, each when ``it`` is a multiple of its period or
    the last step. Pending checkpoint writes are waited for on the way out,
    an exception's way included. ``n_micro`` is the stack depth a host
    source's batches are grouped into (the spec's n_critic)."""
    writer = is_writer()
    logger = logger or ScalarLogger(config.out_dir if writer else None,
                                    curves=config.curves, tensorboard=config.tensorboard)
    if ckpt is not None and ckpt.restore_latest(state) is not None and writer:
        print(f"resumed from step {state.step}", flush=True)
    start_step = state.step
    if hasattr(source, "set_stream_position"):
        source.set_stream_position(start_step)  # one batch per step
    device = next(state.g.parameters()).device
    batches = device_batches(source, n_micro, device, state.mesh)
    aux_skips: dict = {}
    trace = None
    trace_dir = os.path.join(config.out_dir or ".", "trace")
    try:
        for step in range(start_step, config.total_steps):
            if config.trace_steps and step == start_step + 10:
                trace = profiler.start_trace()
            if alpha_fn is not None:
                state.alpha = float(alpha_fn(step))
            with (profiler.span(f"train_step {step + 1}", step=step + 1)
                  if trace is not None else contextlib.nullcontext()):
                metrics = step_fn(state, next(batches))
            if trace is not None and step == start_step + 10 + config.trace_steps:
                profiler.stop_trace(trace, trace_dir, device)
                trace = None
            if config.fault_inject_step and step + 1 == config.fault_inject_step:
                raise RuntimeError(f"fault injected at step {step + 1}")
            it = step + 1
            last = it == config.total_steps
            if it % config.log_every == 0 or last:
                host = {k: float(v) for k, v in metrics.items()}
                if not all(math.isfinite(v) for v in host.values()):
                    raise FloatingPointError(f"non-finite metrics at step {it}: {host}")
                if writer:
                    logger.log(it, host)
                    logger.flush(it)
                    if log_fn is not None:
                        log_fn(it, host)
            if sample_fn is not None and (it % config.sample_every == 0 or last):
                view = gathered(state)
                if writer:
                    _run_aux(f"sample@{it}", lambda: sample_fn(view, it),
                             skip_counts=aux_skips, logger=logger, step=it)
            if eval_fn is not None and config.eval_every and (
                    it % config.eval_every == 0 or last):
                view = gathered(state)
                scores = _run_aux(f"eval@{it}", lambda: eval_fn(view, it),
                                  skip_counts=aux_skips, logger=logger, step=it)
                if scores is not None and writer:
                    logger.flush(it, extra=scores)
            if ckpt is not None and (it % config.checkpoint_every == 0 or last):
                ckpt.save(it, state)
    finally:
        if trace is not None:  # the window outlived the loop: keep what it caught
            profiler.stop_trace(trace, trace_dir, device)
        if ckpt is not None:
            ckpt.wait()
    barrier()
    return state
