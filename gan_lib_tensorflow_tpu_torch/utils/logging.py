"""Scalar logging (port of ``ScalarLogger.log`` and ``flush`` from
``gan_lib_tensorflow_tpu/utils/logging.py``): running means since the last
flush, ``sec_per_step``, one printed line, and ``log.jsonl`` under
``out_dir``. Metric curves and TensorBoard are not ported (no matplotlib or
tensorboard on the card)."""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional


class ScalarLogger:
    def __init__(self, out_dir: Optional[str] = None):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self._since_flush: Dict[str, list] = collections.defaultdict(list)
        self._t_last: Optional[float] = None
        self._step_last = 0

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._since_flush[k].append(float(v))

    def flush(self, step: int, extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Print and record the means since the last flush (plus ``extra``,
        e.g. eval scores or an ``aux_skip/<kind>`` count); returns them."""
        means = {k: sum(v) / len(v) for k, v in self._since_flush.items() if v}
        if extra:
            means.update(extra)
        now = time.time()
        if self._t_last is not None and step > self._step_last:
            means["sec_per_step"] = (now - self._t_last) / (step - self._step_last)
        self._t_last, self._step_last = now, step
        line = "  ".join(f"{k} {v:.5g}" for k, v in sorted(means.items()))
        print(f"step {step}  {line}", flush=True)
        if self.out_dir:
            with open(os.path.join(self.out_dir, "log.jsonl"), "a") as f:
                f.write(json.dumps({"step": step, **means}) + "\n")
        self._since_flush.clear()
        return means
