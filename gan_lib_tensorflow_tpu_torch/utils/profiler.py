"""Profiling hooks (port of ``gan_lib_tensorflow_tpu/utils/profiler.py:
15-70``): a device barrier, a step timer in images per second per card, and
a ``torch.profiler`` trace that the train loop opens and closes around
its ``--trace-steps`` window."""

from __future__ import annotations

import os
import time
from typing import Optional

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
    device; ``stop_trace`` writes it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, trace_dir: str, device=None) -> str:
    """Wait for the device, stop ``prof`` and write its Chrome trace as
    ``trace_dir/trace_rank<r>.json``; returns the path."""
    hard_sync(device)
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}", flush=True)
    return path
