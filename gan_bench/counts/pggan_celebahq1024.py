"""The work of one PGGAN training step at one rung, from the configuration's
published shapes alone (not from what the program dispatches): the model
FLOPs and the fade-in blends' bytes.

FLOPs count the multiply-adds (2 FLOPs each) of every convolution and
linear layer as the architecture defines it, composed: G's level convs on
the 2x-upsampled input, D's before their pooling, whatever the program
fuses or lays out otherwise (fused_scale, space-to-depth). A forward
without gradients counts once; a network differentiated only through (D in
the G update) twice; a network updated three times (forward, input and
weight gradients); the gradient penalty's D pass six times (its forward
and input gradients, and the gradients of both). Normalization,
activations, pooling, the blend, the optimizer and the EMA count nothing.

A transition step blends six times: G's RGB in the fakes' forward and in
the G update, D's top level in the real, fake, penalty and G-update
passes; each blend reads two float32 tensors and writes one (12 bytes per
element).
"""

from __future__ import annotations

import math

from ..reference.pggan_celebahq1024 import nf


def _levels(res: int):
    return [2 ** i for i in range(3, int(math.log2(res)) + 1)]


def _g_forward(cfg, res: int, n: int, fade: bool) -> int:
    n4, z = nf(cfg, 4), cfg["latent_size"]
    flops = 2 * n * z * 16 * n4 + 2 * n * 16 * n4 * n4 * 9
    for r in _levels(res):
        flops += 2 * n * r * r * nf(cfg, r) * 9 * (nf(cfg, r // 2) + nf(cfg, r))
    flops += 2 * n * res * res * 3 * nf(cfg, res)
    if fade:
        flops += 2 * n * (res // 2) ** 2 * 3 * nf(cfg, res // 2)
    return flops


def _d_forward(cfg, res: int, n: int, fade: bool) -> int:
    n4 = nf(cfg, 4)
    flops = 2 * n * res * res * nf(cfg, res) * 3
    for r in _levels(res):
        flops += 2 * n * r * r * nf(cfg, r) * 9 * (nf(cfg, r) + nf(cfg, r // 2))
    if fade:
        flops += 2 * n * (res // 2) ** 2 * nf(cfg, res // 2) * 3
    return flops + 2 * n * 16 * n4 * (n4 + 1) * 9 + 2 * n * 16 * n4 * n4 + 2 * n * n4


def fadein_elements(cfg, res: int, n: int):
    """Elements of G's blend and of D's."""
    return 3 * n * res * res, n * nf(cfg, res // 2) * (res // 2) ** 2


def counts(cfg, traffic) -> dict:
    res, b = traffic["resolution"], traffic["batch"]
    fade = traffic["phase"] == "transition"
    fg, fd = _g_forward(cfg, res, b, fade), _d_forward(cfg, res, b, fade)
    out = {"flops_per_step": 4 * fg + 14 * fd}
    if fade:
        g_el, d_el = fadein_elements(cfg, res, b)
        out.update(fadein_bytes_per_step=12 * (2 * g_el + 4 * d_el),
                   fadein_launches_per_step=6)
    return out
