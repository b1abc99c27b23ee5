"""pix2pix (port of ``gan_lib_tensorflow_tpu/models/pix2pix.py``): a U-Net
generator and a PatchGAN discriminator trained with cGAN + L1.

  G: encoder C64-C128-C256-C512 x 5 at 256^2 (4x4 stride-2 convs, LeakyReLU
     0.2 before all but the first, BN on all but the first and the last);
     decoder of 4x4 stride-2 ConvTransposes with BN, each after a ReLU of
     [h, skip] (the skip concat comes before the ReLU), dropout 0.5 after the
     first three; ``dec_out`` to 3 channels, tanh in float32. The depth
     follows the input: log2(size) levels, so the bottleneck is 1x1 and the
     last encoder level, which has no BN, never normalizes a single value.
  D: PatchGAN over the channel concat (input, target): 4x4 convs with
     explicit pads (1, 1) at strides 2, 2, 2, 1 and ``conv_out`` at stride 1
     in float32 whatever the compute dtype; at 256^2 the map goes
     256 -> 128 -> 64 -> 32 -> 31 -> 30 and the logits are [N, 30, 30, 1].

Neither network has spectral norm or a fade-in, so a pix2pix step launches
neither hand-written kernel.

Dropout stays on at test time (the reference never switches it off): the
generator's ``train`` gates only BN's use of the running averages. Its keep
masks are arguments, one bool tensor per dropout level laid out NHWC like
the reference's activations (``UNetGenerator.mask_shapes``). The spec draws
them from the step's generators, or takes them from the caller (the parity
tests hand in the reference's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..losses import bce_d_loss, bce_g_loss, l1_loss
from ..ops import BatchNorm, Conv, ConvTranspose, dropout
from ..parallel.sharding import global_batch, local_rows
from ..train.step import GANSpec

N_DROPOUT = 3  # decoder levels with dropout


class UNetGenerator(nn.Module):
    def __init__(self, image_size: int = 256, base_ch: int = 64, in_ch: int = 3,
                 out_ch: int = 3, drop_rate: float = 0.5,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        depth = int(image_size).bit_length() - 1
        if not 2 ** depth == image_size >= 8:
            raise ValueError(f"U-Net needs a power-of-two input of at least 8, got {image_size}")
        c = base_ch
        full = (c, c * 2, c * 4, c * 8, c * 8, c * 8, c * 8, c * 8)
        self.enc_chs = full[:depth]
        self.dec_chs = tuple(reversed(self.enc_chs[:-1]))
        self.image_size, self.drop_rate = image_size, drop_rate
        prev = in_ch
        for i, ch in enumerate(self.enc_chs):
            self.add_module(f"enc{i}", Conv(prev, ch, 4, compute_dtype=compute_dtype, stride=2))
            if 0 < i < depth - 1:
                self.add_module(f"enc_bn{i}", BatchNorm(ch, compute_dtype=compute_dtype))
            prev = ch
        for i, ch in enumerate(self.dec_chs):
            # after level 0 the input is [h, skip]: the previous level's
            # channels, then those of the encoder level of the same size
            in_c = prev + (self.enc_chs[depth - 1 - i] if i > 0 else 0)
            self.add_module(f"dec{i}", ConvTranspose(in_c, ch, 4, 2, compute_dtype=compute_dtype))
            self.add_module(f"dec_bn{i}", BatchNorm(ch, compute_dtype=compute_dtype))
            prev = ch
        self.dec_out = ConvTranspose(prev + self.enc_chs[0], out_ch, 4, 2,
                                     compute_dtype=compute_dtype)

    @property
    def n_dropout(self) -> int:
        return min(N_DROPOUT, len(self.dec_chs)) if self.drop_rate > 0 else 0

    def mask_shapes(self, n: int) -> List[tuple]:
        """NHWC shapes of the dropout masks of a batch of ``n``: decoder
        level i outputs ``2 ** (i + 1)`` squared."""
        return [(n, 2 ** (i + 1), 2 ** (i + 1), self.dec_chs[i])
                for i in range(self.n_dropout)]

    def draw_masks(self, n: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Keep masks (``uniform < 1 - rate``, the reference's bernoulli) for
        a batch of ``n``, drawn in one call from ``generator`` on its device."""
        shapes = self.mask_shapes(n)
        sizes = [torch.Size(s).numel() for s in shapes]
        u = torch.rand(sum(sizes), generator=generator, device=generator.device)
        keep = u < 1.0 - self.drop_rate
        return [m.view(s) for m, s in zip(torch.split(keep, sizes), shapes)]

    def forward(self, x: torch.Tensor, masks: Sequence[torch.Tensor], train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """x: NHWC ``[N, S, S, 3]`` -> ``[N, S, S, out_ch]`` float32 NHWC.
        ``masks``: the keep masks of ``mask_shapes(N)``, applied in training
        and at test time alike. In training BN uses batch statistics, and its
        running stats advance only with ``update_stats``."""
        ura = not train
        depth = len(self.enc_chs)
        h = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(depth):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"enc{i}")(h)
            if 0 < i < depth - 1:
                h = getattr(self, f"enc_bn{i}")(h, use_running_average=ura,
                                                 update_stats=update_stats)
            skips.append(h)
        for i in range(len(self.dec_chs)):
            if i > 0:
                h = torch.cat([h, skips[depth - 1 - i]], dim=1)
            h = getattr(self, f"dec{i}")(F.relu(h))
            h = getattr(self, f"dec_bn{i}")(h, use_running_average=ura,
                                             update_stats=update_stats)
            if i < self.n_dropout:
                h = dropout(h, self.drop_rate, masks[i].permute(0, 3, 1, 2))
        h = self.dec_out(F.relu(torch.cat([h, skips[0]], dim=1)))
        return torch.tanh(h.float()).permute(0, 2, 3, 1)


class PatchGANDiscriminator(nn.Module):
    """The 70x70 PatchGAN: logits (not probabilities; the losses are the
    stable softplus BCE) per patch, ``[N, 30, 30, 1]`` at 256^2."""

    def __init__(self, base_ch: int = 64, n_layers: int = 3, in_ch: int = 6,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        pad1 = ((1, 1), (1, 1))
        self.n_layers = n_layers
        self.conv0 = Conv(in_ch, base_ch, 4, compute_dtype=compute_dtype, stride=2,
                          padding=pad1)
        ch = base_ch
        for i in range(1, n_layers + 1):
            prev, ch = ch, min(ch * 2, base_ch * 8)
            self.add_module(f"conv{i}", Conv(prev, ch, 4, compute_dtype=compute_dtype,
                                             stride=2 if i < n_layers else 1, padding=pad1))
            self.add_module(f"bn{i}", BatchNorm(ch, compute_dtype=compute_dtype))
        self.conv_out = Conv(ch, 1, 4, compute_dtype=torch.float32, padding=pad1)

    def forward(self, inp: torch.Tensor, tgt: torch.Tensor, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """inp, tgt: NHWC ``[N, S, S, 3]`` -> float32 logits NHWC."""
        h = torch.cat([inp, tgt], dim=-1).permute(0, 3, 1, 2)
        h = F.leaky_relu(self.conv0(h), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{i}")(h)
            h = getattr(self, f"bn{i}")(h, use_running_average=not train,
                                        update_stats=update_stats)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def make_pix2pix_spec(g_model: UNetGenerator, d_model: PatchGANDiscriminator,
                      gan_weight: float = 1.0, l1_weight: float = 100.0) -> GANSpec:
    """cGAN + L1 spec (reference ``make_pix2pix_spec``), n_critic 1: D and G
    update on the same paired microbatch.

    D loss: BCE(real pair) + BCE(fake pair). Its fake comes from G in
    training mode (batch statistics) without grad and without moving G's
    running stats (the reference discards them). D's running stats advance
    through the real tower, then the fake tower, as the TF1 reference's two
    towers both update them; the logits use each tower's own batch.
    G loss: ``gan_weight`` BCE + ``l1_weight`` L1; G's running stats advance
    once, D runs in training mode without moving its own. The two G
    forwards draw different dropout masks, so the D step's fake is not
    reused. Masks, when handed in: G's keep masks of that forward; otherwise
    each loss draws them from its noise generator."""

    def d_loss(micro, noise, masks=None):
        inp, tgt = micro["input"], micro["target"]
        if masks is None:  # of the global batch; the rank keeps its rows
            masks = g_model.draw_masks(global_batch(inp.shape[0]), noise)
        with torch.no_grad():
            fake = g_model(inp, [local_rows(m) for m in masks], train=True,
                           update_stats=False)
        real_logits = d_model(inp, tgt, train=True)
        fake_logits = d_model(inp, fake, train=True)
        loss = bce_d_loss(real_logits, fake_logits)
        return loss, {"d_loss": loss.detach()}

    def g_loss(micro, noise, masks=None):
        inp, tgt = micro["input"], micro["target"]
        if masks is None:
            masks = g_model.draw_masks(global_batch(inp.shape[0]), noise)
        fake = g_model(inp, [local_rows(m) for m in masks], train=True)
        gan = bce_g_loss(d_model(inp, fake, train=True, update_stats=False))
        l1 = l1_loss(tgt, fake)
        return gan_weight * gan + l1_weight * l1, {"g_gan": gan.detach(), "g_l1": l1.detach()}

    return GANSpec(prepare_fakes=None, d_loss=d_loss, g_loss=g_loss, n_critic=1,
                   paired=True)


def make_translator(g_model: UNetGenerator):
    """``translate(inp, generator)``: G at ``train=False`` (BN's running
    averages) with dropout still on, its masks drawn from ``generator``
    (reference ``make_translator``, the ``--mode test`` path)."""

    @torch.no_grad()
    def translate(inp: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return g_model(inp, g_model.draw_masks(inp.shape[0], generator), train=False)

    return translate


class FixedMaskTranslator(nn.Module):
    """The export bundle's serve function: G at ``train=False`` with its
    dropout masks fixed when the module is made (the reference exports with
    a fixed ``PRNGKey(0)``, ``cli/train_pix2pix.py:232-235``); the masks are
    buffers, so ``torch.export`` keeps them."""

    def __init__(self, g_model: UNetGenerator, masks: Sequence[torch.Tensor]):
        super().__init__()
        self.g = g_model
        self.n_masks = len(masks)
        for i, m in enumerate(masks):
            # own storage: torch.export saves views of one draw as partial tensors
            self.register_buffer(f"mask{i}", m.clone())

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.g(inp, [getattr(self, f"mask{i}") for i in range(self.n_masks)],
                      train=False)
