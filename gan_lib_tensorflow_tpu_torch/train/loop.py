"""Training loop (port of ``gan_lib_tensorflow_tpu/train/loop.py:28-201``):
auto-resume, steps, the NaN guard, the fade-in schedule, fault injection,
and the periodic log, sample, eval and checkpoint, in the reference's order.
Profiler capture, curves and TensorBoard are not ported."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, Optional

from ..utils.logging import ScalarLogger
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100_000
    log_every: int = 100
    sample_every: int = 1000
    checkpoint_every: int = 5000
    eval_every: int = 0              # 0 = no periodic eval
    out_dir: Optional[str] = None
    fault_inject_step: int = 0       # raise after this step (resume testing)


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


def train_loop(state, step_fn: Callable, source: Iterable, config: LoopConfig,
               log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
               alpha_fn: Optional[Callable[[int], float]] = None,
               sample_fn: Optional[Callable[[Any, int], None]] = None,
               ckpt: Optional[CheckpointManager] = None,
               logger: Optional[ScalarLogger] = None,
               eval_fn: Optional[Callable[[Any, int], dict]] = None):
    """Run ``step_fn(state, batch)`` from ``state.step`` to
    ``config.total_steps``, resuming first from ``ckpt``'s newest checkpoint
    when there is one. Metrics are read (which waits for the device) only
    on log steps, where non-finite ones raise; they go to ``logger`` (printed,
    and ``log.jsonl`` under its ``out_dir``) and to ``log_fn(step, metrics)``
    when given. ``alpha_fn(step)`` sets the PGGAN fade-in weight
    ``state.alpha`` (a host float) before each step. After step ``it``: log,
    sample, eval, checkpoint, each when ``it`` is a multiple of its period or
    the last step. Pending checkpoint writes are waited for on the way out,
    an exception's way included."""
    logger = logger or ScalarLogger(config.out_dir)
    if ckpt is not None and ckpt.restore_latest(state) is not None:
        print(f"resumed from step {state.step}", flush=True)
    start_step = state.step
    if hasattr(source, "set_stream_position"):
        source.set_stream_position(start_step)  # one batch per step
    batches = iter(source)
    aux_skips: dict = {}
    try:
        for step in range(start_step, config.total_steps):
            if alpha_fn is not None:
                state.alpha = float(alpha_fn(step))
            metrics = step_fn(state, next(batches))
            if config.fault_inject_step and step + 1 == config.fault_inject_step:
                raise RuntimeError(f"fault injected at step {step + 1}")
            it = step + 1
            last = it == config.total_steps
            if it % config.log_every == 0 or last:
                host = {k: float(v) for k, v in metrics.items()}
                if not all(math.isfinite(v) for v in host.values()):
                    raise FloatingPointError(f"non-finite metrics at step {it}: {host}")
                logger.log(it, host)
                logger.flush(it)
                if log_fn is not None:
                    log_fn(it, host)
            if sample_fn is not None and (it % config.sample_every == 0 or last):
                _run_aux(f"sample@{it}", lambda: sample_fn(state, it),
                         skip_counts=aux_skips, logger=logger, step=it)
            if eval_fn is not None and config.eval_every and (
                    it % config.eval_every == 0 or last):
                scores = _run_aux(f"eval@{it}", lambda: eval_fn(state, it),
                                  skip_counts=aux_skips, logger=logger, step=it)
                if scores is not None:
                    logger.flush(it, extra=scores)
            if ckpt is not None and (it % config.checkpoint_every == 0 or last):
                ckpt.save(it, state)
    finally:
        if ckpt is not None:
            ckpt.wait()
    return state
