"""Checkpoint and resume (port of ``gan_lib_tensorflow_tpu/train/checkpoint.py``,
which saves through orbax).

One ``torch.save`` file per step, ``step_000123.pt``, holding everything
that decides the next step (``state.to_checkpoint``). ``save`` copies the
state to host memory at once, so training may go on mutating it, and writes
the file on a background thread: to a temporary name first, then
``os.replace``-d into place, so a crash mid-write leaves the previous
checkpoint as the latest. Older files beyond ``max_to_keep`` are removed
only after a write has succeeded. Files hold only CPU tensors, numbers,
strings, lists and dicts: they load under ``torch.load(weights_only=True)``
in any process, a CPU-only one included, whatever device wrote them.

On a mesh every rank calls ``save`` (the state is gathered to the one-rank
format first, a collective under 'model' sharding) and only rank 0 writes;
every rank restores from the same file.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Any, List, Optional

import torch

from ..parallel.mesh import is_writer
from .state import GANTrainState, load_checkpoint, to_checkpoint

_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = concurrent.futures.ThreadPoolExecutor(1)
        self._pending: Optional[concurrent.futures.Future] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:06d}.pt")

    def save(self, step: int, state: GANTrainState, wait: bool = False) -> None:
        """Snapshot ``state`` to host memory now and write it in the
        background (one write in flight; the previous one is waited for)."""
        self.save_payload(step, to_checkpoint(state), wait)

    def save_payload(self, step: int, payload: dict, wait: bool = False) -> None:
        """``save`` of any dict of tensors, numbers, strings, lists and dicts
        (an export bundle's generator payload); only rank 0 writes."""
        if not is_writer():
            return
        payload = _to_host(payload)
        self.wait()
        self._pending = self._writer.submit(self._write, step, payload)
        if wait:
            self.wait()

    def _write(self, step: int, payload: dict) -> None:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    @staticmethod
    def steps_in(directory: str) -> List[int]:
        """Steps of the complete checkpoints in ``directory``, oldest first."""
        found = (_FILE.match(f) for f in os.listdir(directory))
        return sorted(int(m.group(1)) for m in found if m)

    def steps(self) -> List[int]:
        """Steps of the complete checkpoints on disk, oldest first."""
        return self.steps_in(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self, state: GANTrainState) -> Optional[GANTrainState]:
        """Load the newest checkpoint into ``state`` in place (its devices
        stay) and return it; None if there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        load_checkpoint(state, torch.load(self.path(step), map_location="cpu",
                                          weights_only=True))
        return state

    def restore_latest_raw(self, map_location="cpu") -> Optional[dict]:
        """The newest checkpoint as a plain dict on ``map_location``, without
        the noise generators' states: the inference view (``state.
        eval_state_from_raw``; an export bundle's payload reads the same
        way). None if there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        raw = torch.load(self.path(step), map_location=map_location, weights_only=True)
        for key in ("g_noise", "d_noise"):
            raw.pop(key, None)
        return raw

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()
