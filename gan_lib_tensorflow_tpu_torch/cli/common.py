"""Shared CLI plumbing (port of ``gan_lib_tensorflow_tpu/cli/common.py``):
the flag vocabulary, ``configure``, ``maybe_mesh``, ``device_cache_kwargs``
and ``image_source``. ``--compile-cache`` configures XLA's compile cache in
the reference; it is accepted here and ignored with a note.

Multi-device runs start one process per rank with ``torchrun
--nproc_per_node R -m gan_lib_tensorflow_tpu_torch.cli.<x> ...``; a plain
``python -m`` is one rank. ``--batch-size`` is the global batch."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from .. import data
from ..parallel import Mesh, create_mesh
from ..utils import debug_nans

SYNTHETIC = ("fake", "fake-rich", "device-fake", "device-rich")
DATA_HELP = ("data backend: 'auto' (real CIFAR-10 when it is found, else 'fake' "
             "with a note), 'cifar10' (must be found), 'fake' / 'fake-rich' "
             "(synthetic class blobs, or the richer multi-blob style, rendered "
             "on the host by two workers), 'device-fake' / 'device-rich' (the "
             "same styles rendered on the device), or a PATH: a packed store or "
             "a cifar-10-batches-py directory, which must resolve")


def base_parser(description: str, data_help: str = DATA_HELP) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=100_000, help="total G steps")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="auto", help=data_help)
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
    p.add_argument("--no-mesh", action="store_true",
                   help="one device, no mesh (refused under more than one rank)")
    p.add_argument("--tp-shards", type=int, default=1,
                   help="tensor-parallel ('model' axis) shards: the ranks split as "
                        "(data = world / tp, model = tp), and the wide weights, "
                        "their Adam slots and the EMA shard their output features "
                        "(parallel.train_state_shardings)")
    p.add_argument("--trace-steps", type=int, default=0,
                   help="write a torch.profiler trace of N + 1 steps from the "
                        "run's 10th (under --out-dir/trace)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first operation that "
                        "makes a NaN, in forward and backward (slow)")
    p.add_argument("--curves", action="store_true",
                   help="write a curve PNG per logged metric under --out-dir")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars (and pix2pix's images) "
                        "under --out-dir/tb, when torch's SummaryWriter imports")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="the reference's XLA compile-cache directory; accepted "
                        "and ignored (nothing here is compiled ahead)")
    return p


def configure(args) -> None:
    """Apply the process-wide debug flags before anything is built."""
    if getattr(args, "debug_nans", False):
        debug_nans.enable()
    if getattr(args, "compile_cache", None) is not None:
        print(f"note: --compile-cache {args.compile_cache} configures XLA's compile "
              "cache in the JAX package and is ignored here", flush=True)


def maybe_mesh(args) -> Optional[Mesh]:
    """The mesh the flags and the launcher ask for, or None for one process
    (reference ``cli/common.py:115-129``): ``('data',)`` over every rank,
    ``(world / tp, tp)`` over ``('data', 'model')`` with ``--tp-shards``, or
    ``(world / sp, sp)`` over ``('data', 'sp')`` with PGGAN's
    ``--sp-shards`` (reference ``cli/train_pggan.py:93-98``). A process that
    ``torchrun`` started gets a mesh even alone (a one-rank group).
    ``args.device`` becomes the rank's device."""
    tp = getattr(args, "tp_shards", 1)
    sp = getattr(args, "sp_shards", 1)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if args.no_mesh and tp > 1:
        raise SystemExit("--no-mesh and --tp-shards > 1 conflict: tensor "
                         "parallelism needs the device mesh")
    if args.no_mesh and sp > 1:
        raise SystemExit("--no-mesh and --sp-shards > 1 conflict: spatial "
                         "partitioning needs the device mesh")
    if world % sp:
        raise ValueError(f"--sp-shards {sp} must divide the world size {world}")
    if args.no_mesh:
        if world > 1:
            print(f"--no-mesh trains on one device, but {world} ranks were "
                  "started: launch one process, or drop --no-mesh", file=sys.stderr)
            raise SystemExit(2)
        return None
    if world % tp:
        raise ValueError(f"--tp-shards {tp} does not divide the world size {world}")
    if "RANK" not in os.environ and not dist.is_initialized():
        return None
    if sp > 1:
        mesh = create_mesh((world // sp, sp), ("data", "sp"), device=args.device)
    elif tp > 1:
        mesh = create_mesh((world // tp, tp), ("data", "model"), device=args.device)
    else:
        mesh = create_mesh(device=args.device)
    args.device = str(mesh.device)
    return mesh


def refuse_image_folder(p: argparse.ArgumentParser, path: str, prepack_flag: str,
                        members=()) -> None:
    """Exit 2 through ``p.error`` when ``path`` is a directory that is no
    packed store, and none of its ``members`` is one: image folders are
    decoded with Pillow, which this package does not use."""
    if os.path.isdir(path) and not any(
            data.is_packed_dir(os.path.join(path, m)) for m in ("", *members)):
        p.error(f"--data {path}: not a packed store; image folders are decoded "
                "with Pillow, which this package does not use: pack it first with "
                f"tools/prepack_dataset.py {prepack_flag}")


def compute_dtype(args) -> Optional[torch.dtype]:
    return {"fp32": None, "bf16": torch.bfloat16}[args.compute_dtype]


def device_cache_kwargs(args) -> dict:
    """--device-cache flags -> ``packed_training_source`` keywords."""
    return {"policy": args.device_cache,
            "budget_bytes": int(args.device_cache_gb * 2**30)}


def synthetic_source(word: str, args, batch_size: int, image_size: int,
                     num_classes: int, n_micro: int = 1, mesh: Optional[Mesh] = None):
    """The source of a word of ``SYNTHETIC``: host ``FakeImages`` behind a
    ``ThreadedSource`` for 'fake' / 'fake-rich', ``DeviceFakeImages`` on
    ``args.device`` (on ``mesh``) for 'device-fake' / 'device-rich'."""
    style = "rich" if word.endswith("-rich") else "blobs"
    if word.startswith("device-"):
        return data.DeviceFakeImages(batch_size=batch_size, image_size=image_size,
                                     num_classes=num_classes, seed=args.seed,
                                     n_micro=n_micro, style=style, device=args.device,
                                     mesh=mesh)
    return data.ThreadedSource(data.FakeImages(
        batch_size=batch_size, image_size=image_size, num_classes=num_classes,
        seed=args.seed, style=style))


def image_source(args, batch_size: int, image_size: int, num_classes: int,
                 n_micro: int = 1, mesh: Optional[Mesh] = None):
    """Resolve --data to a source for ``train_loop`` (reference
    ``cli/common.py:141-218``).

    'auto' prefers real CIFAR-10 and falls back to 'fake' with a printed
    note; 'cifar10' requires it; the four synthetic words are
    ``synthetic_source``'s; a PATH must resolve (a packed store of
    ``image_size``, with labels when ``num_classes`` > 0, or a CIFAR-10
    pickle directory) and never falls back. Real data is held on the card
    (``DeviceCachedStore``) when the --device-cache policy allows, else
    streamed as uint8 by one host worker and normalized on the card. On a
    ``mesh`` the on-device sources yield the rank's rows of each global
    ``batch_size``, and the train loop cuts a host stream's global batches
    the same way (``ThreadedSource`` delivers them in a fixed order)."""
    def cifar(data_dir=None):
        store = data.Cifar10(batch_size=batch_size, data_dir=data_dir, seed=args.seed)
        kw = device_cache_kwargs(args)
        # the store's constructor is the one budget check under 'on'
        nbytes = store.images.nbytes + store.labels.nbytes
        if kw["policy"] == "on" or (kw["policy"] == "auto" and nbytes <= kw["budget_bytes"]):
            return data.DeviceCachedStore(
                images=store.images, labels=store.labels, num_classes=10,
                batch_size=batch_size, n_micro=n_micro, seed=args.seed,
                device=args.device, max_bytes=kw["budget_bytes"], mesh=mesh)
        return data.ThreadedSource(store, num_workers=1)

    if args.data in SYNTHETIC:
        return synthetic_source(args.data, args, batch_size, image_size, num_classes,
                                n_micro, mesh)
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
        return synthetic_source("fake", args, batch_size, image_size, num_classes,
                                n_micro, mesh)
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
            device=args.device, mesh=mesh, **device_cache_kwargs(args))
    if not os.path.isfile(os.path.join(args.data, "data_batch_1")):
        raise FileNotFoundError(f"--data {args.data}: neither a packed store "
                                f"({data.packed.META_NAME}) nor a CIFAR-10 "
                                f"directory (data_batch_1)")
    if image_size != 32:
        raise ValueError(f"--data {args.data}: a CIFAR-10 directory is 32^2 but "
                         f"this model trains at {image_size}^2")
    return cifar(data_dir=args.data)
