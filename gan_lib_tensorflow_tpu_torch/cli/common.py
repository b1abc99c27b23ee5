"""Shared CLI plumbing (port of the parts of
``gan_lib_tensorflow_tpu/cli/common.py`` that the SNGAN CIFAR and PGGAN paths
use)."""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from ..data import DeviceFakeImages


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=100_000, help="total G steps")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="fake", choices=["fake"],
                   help="data backend: 'fake' renders synthetic blob images "
                        "on the device (the only source ported so far)")
    p.add_argument("--out-dir", default="runs/out",
                   help="checkpoints, sample grids and log.jsonl go here; a "
                        "re-run with the same directory resumes")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--sample-every", type=int, default=1000)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--fault-inject-step", type=int, default=0,
                   help="raise after this step (resume testing; 0 = never)")
    p.add_argument("--compute-dtype", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    return p


def compute_dtype(args) -> Optional[torch.dtype]:
    return {"fp32": None, "bf16": torch.bfloat16}[args.compute_dtype]


def image_source(args, batch_size: int, image_size: int, num_classes: int,
                 n_micro: int = 1):
    """Resolve --data to a source of ``[n_micro, B, ...]`` stacks."""
    return DeviceFakeImages(batch_size=batch_size, image_size=image_size,
                            num_classes=num_classes, seed=args.seed,
                            n_micro=n_micro, device=args.device)
