"""Serving-bundle writer shared by every export surface (port of
``gan_lib_tensorflow_tpu/train/export.py``, which writes an orbax checkpoint
and StableHLO): ``cli.train_pix2pix --mode export`` and ``cli.sample
--export-dir``. The port's bundle, in one directory:

1. the generator payload as a checkpoint in ``CheckpointManager``'s format
   (``step_000123.pt``; ``restore_latest_raw`` and ``eval_state_from_raw``
   read it), and
2. ``generator.pt2``: ``torch.export`` of the serve module, its weights and
   every constant it holds (pix2pix's dropout masks, a conditional G's
   classes) inside; ``torch.export.load(path).module()(x)`` runs it with no
   model code. It is traced inside ``ops.norms.plain_version()``, so its
   batch norms are the plain version's ATen ops, not the port's CUDA
   kernels (which the bundle could not call without the package).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn

from ..ops import norms
from .checkpoint import CheckpointManager

BUNDLE_FILENAME = "generator.pt2"


def write_serving_bundle(export_dir: str, step: int, payload: Dict[str, Any],
                         serve: nn.Module, example_input: torch.Tensor) -> str:
    """Write the two-artifact bundle for inputs shaped like
    ``example_input``; returns the ``generator.pt2`` path."""
    ckpt = CheckpointManager(export_dir)
    try:
        ckpt.save_payload(step, {"step": int(step), **payload}, wait=True)
    finally:
        ckpt.close()
    with torch.no_grad(), norms.plain_version():
        program = torch.export.export(serve, (example_input,))
    path = os.path.join(export_dir, BUNDLE_FILENAME)
    torch.export.save(program, path)
    print(f"exported generator to {export_dir} (checkpoint + {BUNDLE_FILENAME})",
          flush=True)
    return path
