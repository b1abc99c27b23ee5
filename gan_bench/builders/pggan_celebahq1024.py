"""PGGAN CelebA-HQ at one rung of its ladder as the program trains it:
``train/pggan_loop.build_phase`` on ``cli/train_pggan.ladder_config`` at
the configuration's settings, for the traffic's resolution and phase; the
store of the traffic's synthetic images held on the card
(``DeviceCachedStore``), ``device_batches`` over it, and the phase's
``alpha_fn`` from the traffic's ``start_step``."""

from __future__ import annotations

from gan_lib_tensorflow_tpu_torch.cli import train_pggan
from gan_lib_tensorflow_tpu_torch.data import DeviceCachedStore
from gan_lib_tensorflow_tpu_torch.models import pggan
from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase

from .. import traffic as tr
from ..program import Program
from ..reference.pggan_celebahq1024 import lrate, minibatch, nf


def build(cfg, traffic, seeds: tr.Seeds, device) -> Program:
    res, batch = traffic["resolution"], traffic["batch"]
    if batch != minibatch(cfg, res):
        raise ValueError(f"the traffic's batch {batch} is not the configuration's "
                         f"{minibatch(cfg, res)} at {res}x{res}")
    width = cfg["fmap_max"] / 512
    args = train_pggan.parse_args([
        "--device", str(device), "--seed", str(seeds.weights % 2**31),
        "--final-resolution", str(res), "--width-mul", repr(width),
        "--z-dim", str(cfg["latent_size"]), "--lr", repr(lrate(cfg, res)),
        "--images-per-phase", str(cfg["images_per_phase"]),
        "--fused-from", str(cfg["fused_scale_from"]), "--s2d-from", str(cfg["s2d_from"]),
        "--batch-by-res", f"{res}:{batch}", "--compute-dtype", cfg["compute_dtype"]])
    ladder = train_pggan.ladder_config(args)
    settings = {"beta1": ladder.beta1, "beta2": ladder.beta2, "ema_decay": ladder.ema_decay}
    if any(settings[k] != cfg[k] for k in settings):
        raise ValueError(f"the program's ladder has {settings}, not the configuration's")
    widths = {r: pggan.nf(r, width) for r in (2 ** i for i in range(2, res.bit_length()))}
    if any(widths[r] != nf(cfg, r) for r in widths):
        raise ValueError(f"the program's widths {widths} are not the configuration's")
    phase = build_phase(ladder, res, traffic["phase"])
    phase.state.g_noise.manual_seed(seeds.g_noise)
    phase.state.d_noise.manual_seed(seeds.d_noise)
    store = DeviceCachedStore(images=tr.store_images(traffic, seeds, device).cpu().numpy(),
                              batch_size=batch, n_micro=1, seed=seeds.store, device=device)
    batches = device_batches(store, 1, device, phase.state.mesh)
    return Program(phase.state, phase.spec, batches, images_per_step=batch,
                   alpha_fn=phase.alpha_fn, start_step=traffic["start_step"])
