"""Adversarial and auxiliary losses (port of
``gan_lib_tensorflow_tpu/losses/adversarial.py``): logit-space functions,
computed in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


# --- hinge (SNGAN) ----------------------------------------------------------

def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return (torch.mean(F.relu(1.0 - _f32(real_logits)))
            + torch.mean(F.relu(1.0 + _f32(fake_logits))))


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -torch.mean(_f32(fake_logits))


# --- Wasserstein (PGGAN's WGAN-GP base) --------------------------------------

def wgan_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(_f32(fake_logits)) - torch.mean(_f32(real_logits))


def wgan_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -torch.mean(_f32(fake_logits))


# --- saturating BCE on logits (pix2pix): -log(sigmoid(x)) = softplus(-x) ----

def bce_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return (torch.mean(F.softplus(-_f32(real_logits)))
            + torch.mean(F.softplus(_f32(fake_logits))))


def bce_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss: -E[log D(fake)]."""
    return torch.mean(F.softplus(-_f32(fake_logits)))


def l1_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_f32(target) - _f32(output)))


# --- AC-GAN auxiliary classifier cross-entropy --------------------------------

def acgan_aux_loss(class_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy, mean over the batch."""
    logp = F.log_softmax(_f32(class_logits), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))
