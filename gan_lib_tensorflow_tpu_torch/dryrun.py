"""Multi-rank dry runs on the CPU (port of ``__graft_entry__.py:43-361``'s
``dryrun_multichip``, ``_dryrun_sharded_eval``, the ACGAN, ImageNet-128
and pix2pix DP dry runs and ``_dryrun_pggan_spatial``), and the launcher
they and the tests use.

``launch(target, world, workdir)`` starts ``world`` processes of this
module, one per rank, joined in a gloo group through a ``FileStore`` under
``workdir`` (no port to race for), each with one thread; every rank calls
``target`` (``"module:function"``) with its keyword arguments. Each spawn
has its own time limit: a hung collective fails the launch, and every rank
is killed.

``dryrun_multichip(n)`` runs the fused step of every family on small
shapes over n CPU ranks, through the same code the CLIs run: SNGAN under
DP, and DP x TP when n is even and at least 4, from a device-cached store
too; the sharded IS/FID eval; ACGAN, SNGAN-projection 128^2 (one image per
rank) and pix2pix (batch 1 per rank) under DP; PGGAN under DP x SP (n/2 x
2, when n is even) at 32^2 with the fade-in at alpha 0.5 and the top level
on the space-to-depth grid. Every metric must be finite.

Usage: python -m gan_lib_tensorflow_tpu_torch.dryrun [n_ranks]
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(target: str, world: int, workdir: str, kwargs: Optional[dict] = None,
           timeout: float = 300.0, pythonpath: Optional[str] = None) -> None:
    """Run ``target(**kwargs)`` on ``world`` CPU ranks; raise with the
    failing rank's output if any rank fails or the time runs out."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{os.getpid()}_{id(kwargs)}")
    if os.path.exists(store):
        os.remove(store)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (_REPO, pythonpath,
                                                     os.environ.get("PYTHONPATH")) if p)}
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gan_lib_tensorflow_tpu_torch.dryrun", "--worker",
             str(rank), str(world), store, target, json.dumps(kwargs or {})],
            env=env, cwd=workdir, stdout=log, stderr=subprocess.STDOUT))
    failed = None
    try:
        for rank, p in enumerate(procs):
            try:
                if p.wait(timeout=timeout) != 0 and failed is None:
                    failed = (rank, f"exit code {p.returncode}")
            except subprocess.TimeoutExpired:
                failed = failed or (rank, f"no end within {timeout:.0f} s")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        rank, why = failed
        logs[rank].seek(0)
        tail = logs[rank].read()[-6000:]
        for log in logs:
            log.close()
        raise RuntimeError(f"{target} on {world} ranks: rank {rank} failed ({why}):\n{tail}")
    for log in logs:
        log.close()


def _worker(rank: int, world: int, store: str, target: str, kwargs: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        module, fn = target.split(":")
        getattr(importlib.import_module(module), fn)(**json.loads(kwargs))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int = 2, timeout: float = 600.0) -> None:
    """The dry runs on ``n_ranks`` CPU ranks (rank 0 prints each line)."""
    with tempfile.TemporaryDirectory() as td:
        launch("gan_lib_tensorflow_tpu_torch.dryrun:_dryrun_ranks", n_ranks, td,
               timeout=timeout)
        with open(os.path.join(td, "rank0.log")) as f:
            print(f.read(), end="")


def _finite(name: str, metrics: dict, mesh) -> None:
    host = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in host.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(f"dryrun {name}: non-finite {bad}")
    if mesh.rank == 0:
        print(f"dryrun {name} ok: mesh={dict(zip(mesh.axis_names, mesh.shape))} "
              f"metrics={ {k: round(v, 4) for k, v in host.items()} }", flush=True)


def _dryrun_ranks() -> None:
    from . import data
    from .eval.features import FixedFeatureNet
    from .eval.metrics import DeviceEvalAccumulator
    from .models import acgan, pix2pix, sngan
    from .parallel import create_mesh, shard_batch
    from .train import create_state, make_train_step
    from .train.state import gathered

    n = dist.get_world_size()
    tp = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = (create_mesh((n // tp, tp), ("data", "model"), device="cpu") if tp > 1
            else create_mesh(device="cpu"))
    dp = mesh.size("data")
    g = sngan.ResNetGenerator(channels=(64, 64, 64), bottom_ch=64, z_dim=16)
    d = sngan.ResNetDiscriminator(channels=(64, 64, 64, 64))
    spec = sngan.make_sngan_spec(g, d, n_critic=2, ema_decay=0.999)
    state = create_state(g, d, ema_decay=0.999, device="cpu", mesh=mesh, min_features=64)
    step = make_train_step(spec)
    bs = 4 * dp
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
        (2, bs, 32, 32, 3)).astype(np.float32))}
    _finite("sngan", step(state, shard_batch(batch, mesh, 1)), mesh)

    with tempfile.TemporaryDirectory() as td:  # a store held on the device
        store = os.path.join(td, "store")
        images, _ = data.packed.write_store(store, 64, 32, 32)
        images[:] = np.random.default_rng(1).integers(0, 256, images.shape, np.uint8)
        data.packed.finalize_store(store, images, None)
        src = data.DeviceCachedStore(store, batch_size=bs, n_micro=2, device="cpu",
                                     mesh=mesh)
        _finite("device-cached-input", step(state, next(iter(src))), mesh)

    net = FixedFeatureNet(image_size=32, feature_dim=16, device="cpu")
    sampler = sngan.make_sampler(g)
    acc = DeviceEvalAccumulator(net, 16, splits=2, split_size=bs, mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    view = gathered(state)
    for _ in range(2):
        acc.add_images(sampler(view, shard_batch(torch.randn(bs, 16, generator=gen), mesh)))
    mu, cov = acc.moments()
    if not (np.isfinite(mu).all() and np.isfinite(cov).all()) or acc.count != 2 * bs:
        raise FloatingPointError("dryrun sharded-eval: bad moments")
    if mesh.rank == 0:
        print(f"dryrun sharded-eval ok: n={acc.count} trace(cov)={np.trace(cov):.4f}",
              flush=True)

    dp_mesh = create_mesh(device="cpu")
    rng = np.random.default_rng(1)
    bs = 2 * n
    g, d = acgan.ACGANGenerator(base_ch=32, z_dim=16), acgan.ACGANDiscriminator(base_ch=8)
    state = create_state(g, d, device="cpu", mesh=dp_mesh)
    batch = {"image": torch.from_numpy(rng.standard_normal((1, bs, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 10, (1, bs)).astype(np.int32))}
    _finite("acgan-dp", make_train_step(acgan.make_acgan_spec(g, d))(
        state, shard_batch(batch, dp_mesh, 1)), dp_mesh)

    g = pix2pix.UNetGenerator(64, base_ch=4)
    d = pix2pix.PatchGANDiscriminator(base_ch=4)
    state = create_state(g, d, device="cpu", mesh=dp_mesh)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.standard_normal((1, n, 64, 64, 3)).astype(np.float32))
             for k in ("input", "target")}
    _finite("pix2pix-dp", make_train_step(pix2pix.make_pix2pix_spec(g, d))(
        state, shard_batch(batch, dp_mesh, 1)), dp_mesh)

    n_cls = 12
    g = sngan.imagenet128_generator(num_classes=n_cls, width_mul=1 / 32)
    d = sngan.imagenet128_discriminator(num_classes=n_cls, width_mul=1 / 32)
    spec = sngan.make_sngan_spec(g, d, n_critic=2, ema_decay=0.999)
    state = create_state(g, d, ema_decay=0.999, device="cpu", mesh=dp_mesh)
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, n, 128, 128, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, n_cls, (2, n)).astype(np.int32))}
    _finite("imagenet-dp", make_train_step(spec)(state, shard_batch(batch, dp_mesh, 1)),
            dp_mesh)
    _dryrun_pggan_spatial(n)


def _dryrun_pggan_spatial(n: int) -> None:
    """The PGGAN WGAN-GP step under DP x SP (reference ``__graft_entry__.py:
    204-252``): the batch over 'data', the image height over 'sp', the top
    level at ``s2d_from=res`` as every ladder stage runs it under the CLI's
    default ``--s2d-from``."""
    from .models import pggan
    from .parallel import create_mesh, shard_batch
    from .train import create_state, make_train_step

    if n % 2:
        if dist.get_rank() == 0:
            print("dryrun pggan-spatial skipped (odd rank count)", flush=True)
        return
    sp, res = 2, 32
    mesh = create_mesh((n // sp, sp), ("data", "sp"), device="cpu")
    g = pggan.PGGANGenerator(resolution=res, fade_in=True, z_dim=16, width_mul=1 / 32,
                             s2d_from=res)
    d = pggan.PGGANDiscriminator(resolution=res, fade_in=True, width_mul=1 / 32,
                                 mbstd_group_size=2, s2d_from=res)
    spec = pggan.make_pggan_spec(g, d, ema_decay=0.999)
    state = create_state(g, d, lr=1e-3, beta2=0.99, ema_decay=0.999, device="cpu", mesh=mesh)
    state.alpha = 0.5
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
        (1, 2 * mesh.size("data"), res, res, 3)).astype(np.float32))}
    _finite("pggan-spatial", make_train_step(spec)(
        state, shard_batch(batch, mesh, 1, spatial_axis="sp")), mesh)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
