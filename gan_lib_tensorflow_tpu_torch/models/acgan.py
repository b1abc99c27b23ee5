"""ACGAN on CIFAR-10 (port of ``gan_lib_tensorflow_tpu/models/acgan.py``,
Odena et al. 2017's CIFAR variant):

  G: [z | one-hot(y)] -> Dense -> 4x4x384 -> ReLU -> 2 x (5x5 stride-2
     ConvTranspose + BN + ReLU) at 192 and 96 -> 5x5 stride-2 ConvTranspose
     to 3 -> tanh -> [N, 32, 32, 3] (NHWC)
  D: six 3x3 convs (64, 64, 128, 128, 256, 256 at strides 2, 1, 2, 1, 2, 1),
     each followed by LeakyReLU 0.2 and dropout 0.3 -> flatten (NHWC order)
     -> float32 heads: an adversarial logit and 10 class logits

Neither network has spectral norm or a fade-in, so an ACGAN step launches
neither hand-written kernel.

Dropout masks: D takes its keep masks as arguments, one bool tensor per conv
laid out NHWC like the reference's activations (``ACGANDiscriminator.
mask_shapes``). The spec draws them from the step's generators, or takes
them from the caller (the parity tests hand in the reference's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..losses import acgan_aux_loss, bce_d_loss, bce_g_loss, hinge_d_loss, hinge_g_loss
from ..ops import BatchNorm, Conv, ConvTranspose, Dense, dropout
from ..parallel.sharding import global_batch, local_rows
from ..train.step import GANSpec


class ACGANGenerator(nn.Module):
    bottom = 4  # spatial size of the Dense output

    def __init__(self, num_classes: int = 10, z_dim: int = 110, base_ch: int = 384,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes, self.z_dim, self.base_ch = num_classes, z_dim, base_ch
        b = self.bottom
        self.dense = Dense(z_dim + num_classes, b * b * base_ch, compute_dtype=compute_dtype)
        chs = (base_ch, base_ch // 2, base_ch // 4)
        for i in range(2):
            self.add_module(f"deconv{i}", ConvTranspose(chs[i], chs[i + 1], 5, 2,
                                                        compute_dtype=compute_dtype))
            self.add_module(f"bn{i}", BatchNorm(chs[i + 1], compute_dtype=compute_dtype))
        self.deconv_out = ConvTranspose(chs[2], 3, 5, 2, compute_dtype=compute_dtype)

    def forward(self, z: torch.Tensor, labels: torch.Tensor, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """z ``[N, z_dim]``, labels ``[N]`` -> images ``[N, 32, 32, 3]``
        float32 NHWC. In training BN uses batch statistics, and its running
        stats advance only with ``update_stats``."""
        onehot = F.one_hot(labels.long(), self.num_classes).to(z.dtype)
        b, c = self.bottom, self.base_ch
        # the reference reshapes the Dense output NHWC; permuting that to NCHW
        # keeps its column order and gives channels-last strides
        h = F.relu(self.dense(torch.cat([z, onehot], dim=-1)).view(-1, b, b, c)
                   .permute(0, 3, 1, 2))
        for i in range(2):
            h = getattr(self, f"deconv{i}")(h)
            h = getattr(self, f"bn{i}")(h, use_running_average=not train,
                                        update_stats=update_stats, relu=True)
        return torch.tanh(self.deconv_out(h).float()).permute(0, 2, 3, 1)


class ACGANDiscriminator(nn.Module):
    strides = (2, 1, 2, 1, 2, 1)
    image_size = 32

    def __init__(self, num_classes: int = 10, base_ch: int = 64,
                 dropout_rate: float = 0.3,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes, self.dropout_rate = num_classes, dropout_rate
        chs = (base_ch, base_ch, base_ch * 2, base_ch * 2, base_ch * 4, base_ch * 4)
        self.channels = chs
        in_ch = 3
        for i, (ch, s) in enumerate(zip(chs, self.strides)):
            self.add_module(f"conv{i}", Conv(in_ch, ch, 3, compute_dtype=compute_dtype,
                                             stride=s))
            in_ch = ch
        size = self.image_size
        for s in self.strides:
            size = -(-size // s)
        feat = size * size * chs[-1]
        self.head_adv = Dense(feat, 1)  # float32, as the reference's heads
        self.head_cls = Dense(feat, num_classes)

    def mask_shapes(self, n: int) -> List[tuple]:
        """NHWC shapes of the six dropout masks of a batch of ``n``."""
        shapes, size = [], self.image_size
        for ch, s in zip(self.channels, self.strides):
            size = -(-size // s)
            shapes.append((n, size, size, ch))
        return shapes

    def draw_masks(self, n: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Keep masks (``uniform < 1 - rate``, the reference's bernoulli) for
        a batch of ``n``, drawn in one call from ``generator`` on its device."""
        shapes = self.mask_shapes(n)
        sizes = [torch.Size(s).numel() for s in shapes]
        u = torch.rand(sum(sizes), generator=generator, device=generator.device)
        keep = u < 1.0 - self.dropout_rate
        return [m.view(s) for m, s in zip(torch.split(keep, sizes), shapes)]

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None):
        """x: NHWC images -> (adversarial logits ``[N, 1]``, class logits
        ``[N, num_classes]``), float32. ``masks`` (six NHWC bool tensors)
        apply dropout after each conv, as the reference's D in training;
        None runs it without (``train=False``)."""
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), 0.2)
            if masks is not None:
                h = dropout(h, self.dropout_rate, masks[i].permute(0, 3, 1, 2))
        # the reference flattens NHWC (acgan.py:71): flatten an NHWC view so
        # the heads' input rows keep its order
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
        return self.head_adv(h), self.head_cls(h)


def make_acgan_spec(g_model: ACGANGenerator, d_model: ACGANDiscriminator,
                    adversarial: str = "bce", aux_weight: float = 1.0) -> GANSpec:
    """ACGAN spec (reference ``make_acgan_spec``), n_critic 1. D minimizes
    adv(real, fake) + CE(real) + CE(fake), G adv(fake) + CE(fake), both
    wanting fakes classified as their conditioning class; ``aux_weight``
    weighs the CE terms. D runs in training mode, with dropout, in both
    losses: one pass over ``[real; fake]`` in the D loss (D has no batch
    statistics, so that is the reference's two passes). Its fakes come from G
    in training mode on their own batch statistics without moving G's
    running stats, which only the G loss advances.

    Masks, when handed in: the D loss takes the six ``[2B, ...]`` masks of
    its pass over ``[real; fake]`` (the real half first), the G loss the six
    ``[B, ...]`` of its pass; otherwise each draws them from its noise
    generator. ``alpha`` and ``u_gp`` are unused."""
    if adversarial not in ("bce", "hinge"):
        raise ValueError(f"adversarial must be bce|hinge, got {adversarial!r}")
    adv_d = {"bce": bce_d_loss, "hinge": hinge_d_loss}[adversarial]
    adv_g = {"bce": bce_g_loss, "hinge": hinge_g_loss}[adversarial]

    def prepare_fakes(z_stack: torch.Tensor, alpha: float,
                      labels: torch.Tensor) -> torch.Tensor:
        n_micro, n = z_stack.shape[:2]
        with torch.no_grad():
            fake = g_model(z_stack.reshape(n_micro * n, -1), labels.reshape(n_micro * n),
                           train=True, update_stats=False)
        return fake.reshape(n_micro, n, *fake.shape[1:])

    def d_loss(real, fake, alpha: float, noise, u_gp, labels, masks=None):
        real_labels, fake_labels = labels
        n = real.shape[0]
        if masks is None:  # of the global [real; fake]; the rank keeps its rows
            masks = d_model.draw_masks(2 * global_batch(n), noise)
        masks = [local_rows(m, parts=2) for m in masks]
        adv, cls = d_model(torch.cat([real, fake], dim=0), masks)
        d_adv = adv_d(adv[:n], adv[n:])
        d_aux = acgan_aux_loss(cls[:n], real_labels) + acgan_aux_loss(cls[n:], fake_labels)
        loss = d_adv + aux_weight * d_aux
        acc = (cls[:n].argmax(-1) == real_labels.long()).float().mean()
        return loss, {"d_loss": loss.detach(), "d_adv": d_adv.detach(),
                      "d_aux": d_aux.detach(), "cls_acc": acc}

    def g_loss(z: torch.Tensor, alpha: float, labels: torch.Tensor, noise, masks=None):
        fake = g_model(z, labels, train=True)
        if masks is None:
            masks = d_model.draw_masks(global_batch(z.shape[0]), noise)
        adv, cls = d_model(fake, [local_rows(m) for m in masks])
        g_adv = adv_g(adv)
        g_aux = acgan_aux_loss(cls, labels)
        return g_adv + aux_weight * g_aux, {"g_adv": g_adv.detach(), "g_aux": g_aux.detach()}

    return GANSpec(prepare_fakes=prepare_fakes, d_loss=d_loss, g_loss=g_loss,
                   n_critic=1, z_dim=g_model.z_dim, num_classes=g_model.num_classes)


def make_sampler(g_model: ACGANGenerator):
    """``sample(state, z)``: G at ``train=False`` on the classes ``arange(n)
    % num_classes``, with the EMA parameters when the state has them (ACGAN
    trains without) and G's own otherwise (reference ``acgan.py:130-143``)."""

    @torch.no_grad()
    def sample(state, z: torch.Tensor) -> torch.Tensor:
        labels = torch.arange(z.shape[0], device=z.device) % g_model.num_classes
        if state.ema_params is not None:
            return functional_call(g_model, state.ema_params, (z, labels),
                                   {"train": False})
        return g_model(z, labels, train=False)

    return sample
