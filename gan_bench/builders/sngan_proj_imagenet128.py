"""SNGAN-projection ImageNet-128 as the program trains it: ``cli/
train_sngan_imagenet.build`` at the configuration's settings, the store of
the traffic's synthetic images held on the card (``DeviceCachedStore``),
and ``device_batches`` over it."""

from __future__ import annotations

from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
from gan_lib_tensorflow_tpu_torch.data import DeviceCachedStore
from gan_lib_tensorflow_tpu_torch.train.loop import device_batches

from .. import traffic as tr
from ..program import Program


def build(cfg, traffic, seeds: tr.Seeds, device) -> Program:
    if cfg["n_gen_samples"] != traffic["batch"]:
        raise ValueError("the program's G update runs at the critic's batch: "
                         f"n_gen_samples {cfg['n_gen_samples']} needs batch {traffic['batch']}")
    width = cfg["g_channels"][0] / 1024
    args = train_sngan_imagenet.parse_args([
        "--device", str(device), "--seed", str(seeds.weights % 2**31),
        "--batch-size", str(traffic["batch"]), "--n-critic", str(cfg["n_critic"]),
        "--g-lr", repr(cfg["g_lr"]), "--d-lr", repr(cfg["d_lr"]),
        "--beta1", repr(cfg["beta1"]), "--beta2", repr(cfg["beta2"]),
        "--num-classes", str(cfg["num_classes"]), "--ema-decay", repr(cfg["ema_decay"]),
        "--steps", str(cfg["total_steps"]), "--width-mul", repr(width),
        "--compute-dtype", cfg["compute_dtype"]])
    g, d, spec, state = train_sngan_imagenet.build(args)
    built_g = [getattr(g, f"block{i}").conv2.weight.shape[0] for i in range(g.n_blocks)]
    built_d = [getattr(d, f"block{i}").conv1.weight.shape[0] for i in range(d.n_blocks)]
    if built_g != cfg["g_channels"] or built_d != cfg["d_channels"]:
        raise ValueError(f"the program built G {built_g} and D {built_d}, not the "
                         f"configuration's {cfg['g_channels']} and {cfg['d_channels']}")
    state.g_noise.manual_seed(seeds.g_noise)
    state.d_noise.manual_seed(seeds.d_noise)
    labels = tr.store_labels(traffic, seeds, device)
    store = DeviceCachedStore(
        images=tr.store_images(traffic, seeds, device).cpu().numpy(),
        labels=labels.cpu().numpy(), num_classes=traffic["num_classes"],
        batch_size=traffic["batch"], n_micro=spec.n_critic, seed=seeds.store, device=device)
    batches = device_batches(store, spec.n_critic, device, state.mesh)
    return Program(state, spec, batches,
                   images_per_step=spec.n_critic * traffic["batch"])
