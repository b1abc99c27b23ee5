"""Minimal training loop (port of ``gan_lib_tensorflow_tpu/train/loop.py:
119-201``): steps, log lines, the NaN guard and the fade-in schedule.
Checkpoint, resume, sampling and eval are not ported yet."""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, Iterable, Optional


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100_000
    log_every: int = 100


def _print_log(step: int, metrics: Dict[str, float]) -> None:
    print(json.dumps({"step": step, **metrics}), flush=True)


def train_loop(state, step_fn: Callable, source: Iterable, config: LoopConfig,
               log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
               alpha_fn: Optional[Callable[[int], float]] = None):
    """Run ``step_fn(state, batch)`` from ``state.step`` to
    ``config.total_steps``. Metrics are read (which waits for the device)
    only on log steps, and non-finite ones raise. ``alpha_fn(step)`` sets
    the PGGAN fade-in weight ``state.alpha`` (a host float, so no device
    sync) before each step (reference ``loop.py:163-166``)."""
    log_fn = log_fn or _print_log
    batches = iter(source)
    for step in range(state.step, config.total_steps):
        if alpha_fn is not None:
            state.alpha = float(alpha_fn(step))
        metrics = step_fn(state, next(batches))
        it = step + 1
        if it % config.log_every == 0 or it == config.total_steps:
            host = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in host.values()):
                raise FloatingPointError(f"non-finite metrics at step {it}: {host}")
            log_fn(it, host)
    return state
