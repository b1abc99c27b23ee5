"""What the tools share: the reference tools' model configurations built with
the port's constructors, batches drawn as the reference tools draw them
(``np.random.default_rng(0)``), step timing synchronized with the device at
both ends, the card's name and power limit, and the reference tools' habit
of printing an ``{"error": ...}`` row for a configuration that fails, after
which the tool exits non-zero."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import traceback
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import acgan, pggan, pix2pix, sngan
from ..train import create_state, make_train_step
from ..train.state import GANTrainState
from ..train.step import GANSpec
from ..utils.profiler import StepTimer

BF16 = torch.bfloat16


@dataclasses.dataclass
class Family:
    """One model family at one configuration: its spec, train state, one
    batch of ``[n_micro, batch, ...]`` device tensors and the step."""
    spec: GANSpec
    state: GANTrainState
    data: Dict[str, torch.Tensor]
    batch: int

    def __post_init__(self):
        self.step = make_train_step(self.spec)

    @property
    def images_per_step(self) -> int:
        return self.spec.n_critic * self.batch


def _images(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32).clip(-1, 1)


def _to(data: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def sngan_cifar(batch: Optional[int] = None, device="cuda", dtype=BF16) -> Family:
    """SNGAN CIFAR-10: batch 64, n_critic 5, hinge, Adam(2e-4, 0, 0.9), EMA
    0.9999 (reference ``tools/bench_step.py:33-41``)."""
    g = sngan.cifar_generator(compute_dtype=dtype)
    d = sngan.cifar_discriminator(compute_dtype=dtype)
    spec = sngan.make_sngan_spec(g, d, n_critic=5, ema_decay=0.9999)
    state = create_state(g, d, lr=2e-4, beta1=0.0, beta2=0.9, ema_decay=0.9999,
                         device=device)
    return _labelled(spec, state, batch or 64, 32, 10)


def acgan_cifar(batch: Optional[int] = None, device="cuda", dtype=BF16) -> Family:
    """ACGAN CIFAR-10: batch 100, n_critic 1, BCE + aux CE, Adam(2e-4, 0.5,
    0.999) (reference ``tools/bench_step.py:42-51``)."""
    g = acgan.ACGANGenerator(compute_dtype=dtype)
    d = acgan.ACGANDiscriminator(compute_dtype=dtype)
    spec = acgan.make_acgan_spec(g, d)
    state = create_state(g, d, lr=2e-4, beta1=0.5, beta2=0.999, device=device)
    return _labelled(spec, state, batch or 100, 32, 10)


def sngan_imagenet(batch: Optional[int] = None, device="cuda", num_classes: int = 1000,
                   width_mul: float = 1.0, dtype=BF16) -> Family:
    """SNGAN-projection ImageNet-128: batch 64, n_critic 5, TTUR Adam (G
    1e-4, D 4e-4, betas 0 and 0.9), EMA 0.9999 (reference
    ``tools/bench_step.py:52-62``); ``num_classes`` 0 is the unconditional
    build of ``tools/probe_cond_cost.py``."""
    g = sngan.imagenet128_generator(compute_dtype=dtype, num_classes=num_classes,
                                    width_mul=width_mul)
    d = sngan.imagenet128_discriminator(compute_dtype=dtype, num_classes=num_classes,
                                        width_mul=width_mul)
    spec = sngan.make_sngan_spec(g, d, n_critic=5, ema_decay=0.9999)
    state = create_state(g, d, lr=1e-4, d_lr=4e-4, beta1=0.0, beta2=0.9,
                         ema_decay=0.9999, device=device)
    return _labelled(spec, state, batch or 64, 128, max(num_classes, 1))


def _labelled(spec: GANSpec, state: GANTrainState, batch: int, size: int,
              n_cls: int) -> Family:
    rng = np.random.default_rng(0)
    data = {"image": _images(rng, (spec.n_critic, batch, size, size, 3)),
            "label": rng.integers(0, n_cls, (spec.n_critic, batch)).astype(np.int32)}
    return Family(spec, state, _to(data, next(state.g.parameters()).device), batch)


def pix2pix_facades(batch: int = 4, device="cuda", image_size: int = 256, ngf: int = 64,
                    ndf: int = 64, dtype=BF16) -> Family:
    """pix2pix at 256^2: U-Net ngf 64, PatchGAN ndf 64, cGAN + 100 L1,
    Adam(2e-4, 0.5, 0.999), batch 4 (reference ``tools/calibrate_rungs.py:
    62-84``)."""
    g = pix2pix.UNetGenerator(image_size, ngf, compute_dtype=dtype)
    d = pix2pix.PatchGANDiscriminator(ndf, compute_dtype=dtype)
    spec = pix2pix.make_pix2pix_spec(g, d)
    state = create_state(g, d, lr=2e-4, beta1=0.5, beta2=0.999, device=device)
    rng = np.random.default_rng(0)
    shape = (1, batch, image_size, image_size, 3)
    data = {"input": _images(rng, shape), "target": _images(rng, shape)}
    return Family(spec, state, _to(data, next(g.parameters()).device), batch)


def pggan_top(resolution: int, batch: int, device="cuda", remat_from: int = 0,
              fused_from: int = 128, s2d_from: int = 0, width_mul: float = 1.0,
              dtype=BF16) -> Family:
    """The PGGAN top rung without fade-in: WGAN-GP + drift, n_critic 1,
    Adam(1e-3, 0, 0.99), EMA 0.999 (reference ``tools/bench_pggan.py:
    35-65``)."""
    g = pggan.PGGANGenerator(resolution=resolution, width_mul=width_mul,
                             remat_from=remat_from, s2d_from=s2d_from, compute_dtype=dtype)
    d = pggan.PGGANDiscriminator(resolution=resolution, width_mul=width_mul,
                                 remat_from=remat_from, fused_from=fused_from,
                                 s2d_from=s2d_from, compute_dtype=dtype)
    spec = pggan.make_pggan_spec(g, d)
    state = create_state(g, d, lr=1e-3, beta1=0.0, beta2=0.99, ema_decay=0.999,
                         device=device)
    rng = np.random.default_rng(0)
    data = {"image": _images(rng, (1, batch, resolution, resolution, 3))}
    return Family(spec, state, _to(data, next(g.parameters()).device), batch)


def seconds_per_step(fam: Family, warm: int, timed: int) -> float:
    """``warm`` steps, then ``timed`` steps between two device syncs (the
    reference tools' one end-of-chain sync): seconds per timed step."""
    dev = next(fam.state.g.parameters()).device
    for _ in range(warm):
        fam.step(fam.state, fam.data)
    timer = StepTimer(images_per_step=fam.images_per_step, device=dev)
    timer.start()
    for _ in range(timed):
        fam.step(fam.state, fam.data)
    timer.tick(timed)
    return timer.stop()["sec_per_step"]


def timed_ms(fn: Callable[[], object], reps: int, device) -> float:
    """ms per call of ``fn`` over ``reps`` calls after two warm-up calls,
    synchronized with ``device`` before and after."""
    fn()
    fn()
    timer = StepTimer(images_per_step=1, device=device)
    timer.start()
    for _ in range(reps):
        fn()
    timer.tick(reps)
    return 1e3 * timer.stop()["sec_per_step"]


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device type off the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def free(device) -> None:
    """Release the cached blocks of the configuration just measured."""
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def run_rows(rows: Iterable[dict], measure: Callable[[dict], dict]) -> int:
    """Print each row updated by ``measure(row)``; a configuration that
    raises prints ``{"error": ...}`` in its row (its traceback on stderr),
    and the return code is then 1."""
    rc = 0
    for row in rows:
        try:
            row.update(measure(row))
        except Exception as e:  # an OOM or a failed build is a data point
            traceback.print_exc()
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            rc = 1
        emit(row)
    return rc
