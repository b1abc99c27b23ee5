"""SNGAN ResNet family (port of ``gan_lib_tensorflow_tpu/models/sngan.py``):
CIFAR-10, unconditional or conditional on 10 classes, and SNGAN-projection
ImageNet-128, conditional.

CIFAR-10:
  G: z in R^128 -> Dense -> 4x4x256 -> 3 x (up-ResBlock 256) -> BN -> ReLU ->
     3x3 conv -> tanh -> [N, 32, 32, 3] (NHWC)
  D: NHWC image -> OptimizedBlock(128, down) -> ResBlock(128, down) ->
     2 x ResBlock(128) -> ReLU -> global SUM pool -> SN-Dense(1)
ImageNet-128 (Miyato & Koyama 2018):
  G: Dense -> 4x4x1024 -> up-blocks (1024, 512, 256, 128, 64) with BN
     conditional on the class -> BN -> ReLU -> conv -> tanh -> [N, 128, 128, 3]
  D: OptimizedBlock(64) -> down-blocks (128, 256, 512, 1024) ->
     ResBlock(1024) -> ReLU -> sum-pool phi -> SN-Dense(1) + <SN-embed(y), phi>

D's spectral-norm weights (11 for CIFAR, 12 with its projection embedding; 19
for ImageNet-128, the projection embedding last) get their sigmas from one launch of the batched
power-iteration kernel per forward (``ops/power_iteration.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..losses import hinge_d_loss, hinge_g_loss
from ..ops import (BatchNorm, Conv, Dense, DiscOptimizedBlock, DiscResBlock,
                   Embedding, GenResBlock, global_sum_pool)
from ..ops.power_iteration import PowerIterationTable, batched_power_iteration
from ..train.step import GANSpec


class ResNetGenerator(nn.Module):
    bottom = 4  # spatial size of the Dense output

    def __init__(self, channels: Sequence[int] = (256, 256, 256),
                 bottom_ch: int = 256, z_dim: int = 128, num_classes: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        """``num_classes`` > 0: every block's BN is conditional on the
        labels (the final ``bn_out`` is not, as in the reference)."""
        super().__init__()
        self.bottom_ch, self.z_dim, self.num_classes = bottom_ch, z_dim, num_classes
        bottom = self.bottom
        self.n_blocks = len(channels)
        self.dense = Dense(z_dim, bottom * bottom * bottom_ch,
                           compute_dtype=compute_dtype)
        in_ch = bottom_ch
        for i, ch in enumerate(channels):
            self.add_module(f"block{i}", GenResBlock(in_ch, ch, compute_dtype,
                                                     num_classes=num_classes))
            in_ch = ch
        self.bn_out = BatchNorm(in_ch, compute_dtype=compute_dtype)
        self.conv_out = Conv(in_ch, 3, 3, compute_dtype=compute_dtype)

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
                train: bool = True, groups: int = 1,
                update_stats: bool = True) -> torch.Tensor:
        """z ``[N, z_dim]`` (and labels ``[N]`` when conditional) -> images
        ``[N, S, S, 3]`` float32 NHWC. ``groups`` > 1 gives each of that many
        equal microbatches its own BN batch statistics (and then running
        stats must not update)."""
        b, c = self.bottom, self.bottom_ch
        # the reference reshapes the Dense output NHWC; permuting that to NCHW
        # keeps its column order and gives channels-last strides
        h = self.dense(z).view(-1, b, b, c).permute(0, 3, 1, 2)
        bn = dict(groups=groups, update_stats=update_stats)
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h, labels, train=train, **bn)
        h = self.bn_out(h, use_running_average=not train, relu=True, **bn)
        h = self.conv_out(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)


class ResNetDiscriminator(nn.Module):
    """``fused=True`` computes every down-block's conv2-then-pool as one
    stride-2 conv; same parameters either way. ``num_classes`` > 0 adds the
    projection: an SN embedding of the label dotted with phi."""

    def __init__(self, channels: Sequence[int] = (128, 128, 128, 128),
                 downsample: Sequence[bool] = (True, True, False, False),
                 num_classes: int = 0, fused: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(channels) != len(downsample):
            raise ValueError(f"channels ({len(channels)}) and downsample "
                             f"({len(downsample)}) must have equal length")
        self.n_blocks = len(channels)
        # the input block always downsamples; downsample[0] only aligns tuples
        self.block0 = DiscOptimizedBlock(3, channels[0], fused, compute_dtype)
        for i, (ch, down) in enumerate(zip(channels[1:], downsample[1:])):
            self.add_module(f"block{i + 1}", DiscResBlock(
                channels[i], ch, down, fused, compute_dtype))
        self.dense_out = Dense(channels[-1], 1, spectral_norm=True)  # float32
        self.num_classes = num_classes
        if num_classes > 0:
            self.proj_embed = Embedding(num_classes, channels[-1], spectral_norm=True)
        # registration order: block0.conv1, conv2, conv_skip, block1...,
        # dense_out, proj_embed
        self.sn_layers = [m for m in self.modules() if getattr(m, "spectral_norm", False)]
        self._sn_table = PowerIterationTable()

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                update_sn: bool = False) -> torch.Tensor:
        """x: NHWC images (and labels ``[N]`` when conditional) -> logits
        ``[N, 1]`` float32. ``update_sn`` advances every ``u`` by one
        power-iteration step."""
        sig = batched_power_iteration([m.weight for m in self.sn_layers],
                                      [m.u for m in self.sn_layers],
                                      update_sn, self._sn_table)
        sigmas = dict(zip(self.sn_layers, sig.unbind(0)))
        h = x.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h, sigmas=sigmas)
        phi = global_sum_pool(F.relu(h)).float()
        out = self.dense_out(phi, sigma=sigmas[self.dense_out])
        if self.num_classes > 0:
            emb = self.proj_embed(labels, sigma=sigmas[self.proj_embed])
            out = out + torch.sum(emb * phi, dim=-1, keepdim=True)
        return out


def cifar_generator(compute_dtype=None, num_classes: int = 0) -> ResNetGenerator:
    """``num_classes`` > 0: the conditional CIFAR G (conditional BN)."""
    return ResNetGenerator(num_classes=num_classes, compute_dtype=compute_dtype)


def cifar_discriminator(compute_dtype=None, num_classes: int = 0) -> ResNetDiscriminator:
    """``num_classes`` > 0: the projection D, 12 SN weights with
    ``proj_embed`` ``[128, num_classes]`` last."""
    return ResNetDiscriminator(num_classes=num_classes, compute_dtype=compute_dtype)


def _scale_channels(chs, width_mul: float):
    return tuple(max(int(c * width_mul), 8) for c in chs)


def imagenet128_generator(compute_dtype=None, num_classes: int = 1000,
                          width_mul: float = 1.0) -> ResNetGenerator:
    """128^2 projection-SNGAN G (reference config); ``width_mul`` scales
    every channel count (1.0 is the reference width; at least 8)."""
    chs = _scale_channels((1024, 512, 256, 128, 64), width_mul)
    return ResNetGenerator(channels=chs, bottom_ch=chs[0], num_classes=num_classes,
                           compute_dtype=compute_dtype)


def imagenet128_discriminator(compute_dtype=None, num_classes: int = 1000,
                              width_mul: float = 1.0) -> ResNetDiscriminator:
    return ResNetDiscriminator(
        channels=_scale_channels((64, 128, 256, 512, 1024, 1024), width_mul),
        downsample=(True, True, True, True, True, False),
        num_classes=num_classes, compute_dtype=compute_dtype)


def make_sngan_spec(g_model: ResNetGenerator, d_model: ResNetDiscriminator,
                    n_critic: int = 5, ema_decay: float = 0.0) -> GANSpec:
    """Hinge-loss spec (reference ``make_sngan_spec``): every critic substep
    sees fresh real images and fresh z; ``u`` advances only in ``d_loss``.
    Conditional (G's ``num_classes`` > 0): the real labels come from the
    batch, the fakes' classes from the step's draws (uniform per critic
    substep and for the G update). The fade-in ``alpha``, the noise
    generators, ``u_gp`` and ``masks`` are unused."""
    conditional = g_model.num_classes > 0

    def prepare_fakes(z_stack: torch.Tensor, alpha: float,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """All n_critic fake microbatches in one G forward, each microbatch
        with its own BN batch statistics; running stats do not move."""
        n_micro, n = z_stack.shape[:2]
        flat = labels.reshape(n_micro * n) if conditional else None
        with torch.no_grad():
            fake = g_model(z_stack.reshape(n_micro * n, -1), flat, train=True,
                           groups=n_micro, update_stats=False)
        return fake.reshape(n_micro, n, *fake.shape[1:])

    def d_loss(real: torch.Tensor, fake: torch.Tensor, alpha: float, noise, u_gp,
               labels=None, masks=None):
        # one D pass over [real; fake]: exactly one u advance per substep
        n = real.shape[0]
        both = torch.cat(labels) if conditional else None
        logits = d_model(torch.cat([real, fake], dim=0), both, update_sn=True)
        real_logits, fake_logits = logits[:n], logits[n:]
        loss = hinge_d_loss(real_logits, fake_logits)
        return loss, {"d_loss": loss.detach(),
                      "d_real": real_logits.detach().mean(),
                      "d_fake": fake_logits.detach().mean()}

    def g_loss(z: torch.Tensor, alpha: float, labels: Optional[torch.Tensor] = None,
               noise=None, masks=None):
        fake = g_model(z, labels, train=True)
        return hinge_g_loss(d_model(fake, labels, update_sn=False)), {}

    return GANSpec(prepare_fakes=prepare_fakes, d_loss=d_loss, g_loss=g_loss,
                   n_critic=n_critic, ema_decay=ema_decay, z_dim=g_model.z_dim,
                   num_classes=g_model.num_classes)


def make_sampler(g_model: ResNetGenerator):
    """``sample(state, z)``: G at ``train=False`` with the EMA parameters
    (G's own when the state has no EMA) and the training run's BN running
    stats, as the reference pairs them (``sngan.py:231-255``). A conditional
    G samples the classes ``arange(n) % num_classes``."""

    @torch.no_grad()
    def sample(state, z: torch.Tensor) -> torch.Tensor:
        labels = None
        if g_model.num_classes > 0:
            labels = torch.arange(z.shape[0], device=z.device) % g_model.num_classes
        if state.ema_params is not None:
            return functional_call(g_model, state.ema_params, (z, labels),
                                   {"train": False})
        return g_model(z, labels, train=False)

    return sample
