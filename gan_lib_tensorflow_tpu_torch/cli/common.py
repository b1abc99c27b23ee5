"""Shared CLI plumbing (port of the parts of
``gan_lib_tensorflow_tpu/cli/common.py`` that the SNGAN, SNGAN-projection and
PGGAN paths use: the flag vocabulary, ``device_cache_kwargs`` and
``image_source``)."""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from .. import data

DATA_HELP = ("data backend: 'auto' (real CIFAR-10 when it is found, else "
             "synthetic with a note), 'cifar10' (must be found), 'fake' "
             "(synthetic blob images rendered on the device; it stands in for "
             "the reference's 'fake' and 'device-fake'), or a PATH: a packed "
             "store or a cifar-10-batches-py directory, which must resolve")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=100_000, help="total G steps")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="auto", help=DATA_HELP)
    p.add_argument("--device-cache", default="auto", choices=["auto", "on", "off"],
                   help="hold real-data stores resident on the card and ship only "
                        "each step's indices (auto: when the store fits "
                        "--device-cache-gb; off: stream uint8 batches from the host)")
    p.add_argument("--device-cache-gb", type=float, default=2.0,
                   help="device-memory budget of --device-cache auto/on, GiB")
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


def device_cache_kwargs(args) -> dict:
    """--device-cache flags -> ``packed_training_source`` keywords."""
    return {"policy": args.device_cache,
            "budget_bytes": int(args.device_cache_gb * 2**30)}


def image_source(args, batch_size: int, image_size: int, num_classes: int,
                 n_micro: int = 1):
    """Resolve --data to a source for ``train_loop``.

    'auto' prefers real CIFAR-10 and falls back to synthetic data with a
    printed note; 'cifar10' requires it; a PATH must resolve (a packed store
    of ``image_size``, with labels when ``num_classes`` > 0, or a CIFAR-10
    pickle directory) and never falls back. Real data is held on the card
    (``DeviceCachedStore``) when the --device-cache policy allows, else
    streamed as uint8 by one host worker and normalized on the card."""
    def cifar(data_dir=None):
        store = data.Cifar10(batch_size=batch_size, data_dir=data_dir, seed=args.seed)
        kw = device_cache_kwargs(args)
        # the store's constructor is the one budget check under 'on'
        nbytes = store.images.nbytes + store.labels.nbytes
        if kw["policy"] == "on" or (kw["policy"] == "auto" and nbytes <= kw["budget_bytes"]):
            return data.DeviceCachedStore(
                images=store.images, labels=store.labels, num_classes=10,
                batch_size=batch_size, n_micro=n_micro, seed=args.seed,
                device=args.device, max_bytes=kw["budget_bytes"])
        return data.ThreadedSource(store, num_workers=1)

    if args.data in ("auto", "cifar10"):
        if image_size != 32:
            if args.data == "cifar10":
                raise ValueError(f"--data cifar10 is 32^2 but this model trains at "
                                 f"{image_size}^2; point --data at a packed store")
        else:
            try:
                return cifar()
            except FileNotFoundError:
                if args.data == "cifar10":
                    raise
                print("note: CIFAR-10 not found on disk; using synthetic data", flush=True)
    elif args.data != "fake":
        if not os.path.isdir(args.data):
            raise FileNotFoundError(f"--data {args.data!r}: no such directory")
        if data.is_packed_dir(args.data):
            store = data.PackedImageStore(args.data, batch_size=batch_size, seed=args.seed)
            if store.image_size != image_size:
                raise ValueError(f"--data {args.data}: packed store is "
                                 f"{store.image_size}^2 but this model trains at "
                                 f"{image_size}^2")
            if num_classes > 0 and store.labels is None:
                raise ValueError(f"--data {args.data}: packed store has no labels.npy "
                                 f"but the model is conditional (num_classes="
                                 f"{num_classes})")
            return data.packed_training_source(
                args.data, batch_size=batch_size, n_micro=n_micro, seed=args.seed,
                device=args.device, **device_cache_kwargs(args))
        if not os.path.isfile(os.path.join(args.data, "data_batch_1")):
            raise FileNotFoundError(f"--data {args.data}: neither a packed store "
                                    f"({data.packed.META_NAME}) nor a CIFAR-10 "
                                    f"directory (data_batch_1)")
        if image_size != 32:
            raise ValueError(f"--data {args.data}: a CIFAR-10 directory is 32^2 but "
                             f"this model trains at {image_size}^2")
        return cifar(data_dir=args.data)
    return data.DeviceFakeImages(batch_size=batch_size, image_size=image_size,
                                 num_classes=num_classes, seed=args.seed,
                                 n_micro=n_micro, device=args.device)
