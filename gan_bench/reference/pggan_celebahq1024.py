"""Plain reference of PGGAN (Karras et al. 2018, arXiv:1710.10196; the
CelebA-HQ 1024x1024 config of tkarras/progressive_growing_of_gans) at one
rung of its ladder, and of its training step: float32, TF32 off, no
kernels, every level composed (nearest 2x then conv; conv then 2x2 mean
pool), written from the published description.

Channels: ``nf(res) = min(fmap_base / 2^(log2(res) - 1), fmap_max)``.
Every conv and linear layer has an equalized learning rate: its unit-normal
weight times ``gain / sqrt(fan_in)`` at run time (gain sqrt(2); 1 for toRGB
and D's output).
G: pixel-normed z -> linear -> 4x4 -> LReLU, PN -> 3x3 conv, LReLU, PN ->
per level (nearest 2x, 3x3 conv, LReLU, PN, 3x3 conv, LReLU, PN) -> 1x1
toRGB; in a transition phase alpha * toRGB(top) + (1 - alpha) * upsampled
toRGB(level below).
D: 1x1 fromRGB, LReLU -> per level (3x3 conv, LReLU, 3x3 conv, then either
pool after LReLU, or, at and above ``fused_scale_from``, LReLU after the
pool: the published fused_scale order) -> after the top level of a
transition, alpha * h + (1 - alpha) * LReLU(fromRGB(pooled image)) ->
minibatch stddev (groups of 4) -> 3x3 conv, LReLU -> linear, LReLU ->
linear to one logit.
The step: one WGAN-GP critic update (lambda 10, target 1, drift 1e-3: real,
fake and interpolates through three separate D passes), one G update, the
EMA of G's parameters; Adam(1e-3, 0, 0.99, 1e-8).

Departures from the published code, all of them the program's too: the
minibatch stddev adds epsilon 1e-8 under its root and groups sample i
with the samples i mod (n / 4); weights are NCHW/[out, in] tensors named as
the program names them; the images carry no tanh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .plain import Adam, Numerics, ema_update, pool2x, readings, upsample2x


def nf(cfg, res: int) -> int:
    stage = int(math.log2(res)) - 1
    return min(int(cfg["fmap_base"] / 2.0 ** (stage * cfg["fmap_decay"])), cfg["fmap_max"])


def _levels(res: int) -> List[int]:
    return [2 ** i for i in range(3, int(math.log2(res)) + 1)]


def leaves(cfg, traffic) -> List[Tuple[str, tuple, tuple]]:
    """Every tensor of the initial state of the traffic's rung:
    ``(name, shape, rule)``; equalized weights are unit normal."""
    res, fade = traffic["resolution"], traffic["phase"] == "transition"
    z, n4 = cfg["latent_size"], nf(cfg, 4)
    out: List[Tuple[str, tuple, tuple]] = []

    def layer(name, shape):
        out.append((f"{name}.weight", shape, ("normal", 1.0)))
        out.append((f"{name}.bias", (shape[0],), ("const", 0.0)))

    layer("g.dense_4", (16 * n4, z))
    layer("g.conv_4", (n4, n4, 3, 3))
    for r in _levels(res):
        layer(f"g.block_{r}.conv1", (nf(cfg, r), nf(cfg, r // 2), 3, 3))
        layer(f"g.block_{r}.conv2", (nf(cfg, r), nf(cfg, r), 3, 3))
    layer(f"g.torgb_{res}", (3, nf(cfg, res), 1, 1))
    if fade:
        layer(f"g.torgb_{res // 2}", (3, nf(cfg, res // 2), 1, 1))
    layer(f"d.fromrgb_{res}", (nf(cfg, res), 3, 1, 1))
    for r in reversed(_levels(res)):
        layer(f"d.block_{r}.conv1", (nf(cfg, r), nf(cfg, r), 3, 3))
        layer(f"d.block_{r}.conv2", (nf(cfg, r // 2), nf(cfg, r), 3, 3))
    if fade:
        layer(f"d.fromrgb_{res // 2}", (nf(cfg, res // 2), 3, 1, 1))
    layer("d.conv_4", (n4, n4 + 1, 3, 3))
    layer("d.dense_4", (n4, 16 * n4))
    layer("d.dense_out", (1, n4))
    return out


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _pixel_norm(x, eps=1e-8):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def _minibatch_stddev(x, group_size=4, eps=1e-8):
    n, c, h, w = x.shape
    g = min(group_size, n)
    m = n // g
    xg = x.reshape(g, m, c, h, w)
    var = ((xg - xg.mean(dim=0, keepdim=True)) ** 2).mean(dim=0)
    avg = torch.sqrt(var + eps).mean(dim=(1, 2, 3))           # [m]
    feat = avg.repeat(g).view(n, 1, 1, 1).expand(n, 1, h, w)  # sample i -> group i % m
    return torch.cat([x, feat], dim=1)


class _Nets:
    def __init__(self, cfg, traffic, t: Dict[str, torch.Tensor], num: Numerics):
        self.cfg, self.t, self.num = cfg, t, num
        self.res = traffic["resolution"]
        self.fade = traffic["phase"] == "transition"

    def _w(self, name, gain=math.sqrt(2.0)):
        w = self.t[f"{name}.weight"]
        return w * (gain / math.sqrt(w[0].numel()))

    def conv(self, x, name, gain=math.sqrt(2.0)):
        w = self._w(name, gain)
        return self.num.conv(x, w, self.t[f"{name}.bias"], padding=w.shape[-1] // 2)

    def linear(self, x, name, gain=math.sqrt(2.0)):
        return self.num.linear(x, self._w(name, gain), self.t[f"{name}.bias"])

    def generator(self, z, alpha: float):
        n4 = nf(self.cfg, 4)
        h = self.linear(_pixel_norm(z), "g.dense_4").view(-1, 4, 4, n4).permute(0, 3, 1, 2)
        h = _pixel_norm(_lrelu(h))
        h = _pixel_norm(_lrelu(self.conv(h, "g.conv_4")))
        prev = h
        for r in _levels(self.res):
            prev = h
            h = _pixel_norm(_lrelu(self.conv(upsample2x(h), f"g.block_{r}.conv1")))
            h = _pixel_norm(_lrelu(self.conv(h, f"g.block_{r}.conv2")))
        rgb = self.conv(h, f"g.torgb_{self.res}", gain=1.0)
        if self.fade:
            low = self.conv(prev, f"g.torgb_{self.res // 2}", gain=1.0)
            rgb = alpha * rgb + (1.0 - alpha) * upsample2x(low)
        return rgb.permute(0, 2, 3, 1)

    def discriminator(self, x, alpha: float):
        x = x.permute(0, 3, 1, 2)
        h = _lrelu(self.conv(x, f"d.fromrgb_{self.res}"))
        fused_from = self.cfg["fused_scale_from"]
        for r in reversed(_levels(self.res)):
            h = _lrelu(self.conv(h, f"d.block_{r}.conv1"))
            if fused_from and r >= fused_from:
                h = _lrelu(pool2x(self.conv(h, f"d.block_{r}.conv2")))
            else:
                h = pool2x(_lrelu(self.conv(h, f"d.block_{r}.conv2")))
            if r == self.res and self.fade:
                skip = _lrelu(self.conv(pool2x(x), f"d.fromrgb_{self.res // 2}"))
                h = alpha * h + (1.0 - alpha) * skip
        h = _minibatch_stddev(h, self.cfg["mbstd_group_size"])
        h = _lrelu(self.conv(h, "d.conv_4"))
        h = _lrelu(self.linear(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1), "d.dense_4"))
        return self.linear(h, "d.dense_out", gain=1.0)


def lrate(cfg, res: int) -> float:
    """Adam's rate at rung ``res``: the published schedule's own rate there,
    else its base rate."""
    return float(cfg["lrate_by_resolution"].get(str(res), cfg["lrate_base"]))


def minibatch(cfg, res: int) -> int:
    return int(cfg["minibatch_by_resolution"].get(str(res), cfg["minibatch_base"]))


def alpha_at(cfg, traffic, step: int) -> float:
    """The fade-in weight of a transition phase's step ``step`` (0-based):
    it rises linearly to 1 over the phase's images; 1 in a stable phase."""
    if traffic["phase"] != "transition":
        return 1.0
    steps = max(cfg["images_per_phase"] // traffic["batch"], 1)
    return min((step % steps + 1) / steps, 1.0)


def follow(cfg, traffic, weights: Dict[str, torch.Tensor], batch_fn: Callable[[int], dict],
           noise_seeds: Tuple[int, int], steps: int = 3, precision: str = "fp32",
           half_batch: bool = False) -> dict:
    """Train ``steps`` steps from ``weights`` on ``batch_fn(k)`` (``{"image":
    [1, B, R, R, 3]}``), from the traffic's ``start_step``, drawing z and the
    penalty's weights as the step does from generators seeded ``noise_seeds
    = (g_seed, d_seed)``; returns ``plain.readings``. ``half_batch`` keeps
    the first half of every batch (a fault)."""
    dev = next(iter(weights.values())).device
    t = {n: v.clone() for n, v in weights.items()}
    start = {n: v.clone() for n, v in t.items()}
    nets = _Nets(cfg, traffic, t, Numerics(precision))
    g_names = [n for n in t if n.startswith("g.")]
    d_names = [n for n in t if n.startswith("d.")]
    for n in g_names + d_names:
        t[n].requires_grad_(True)
    rate = lrate(cfg, traffic["resolution"])
    lr = lambda count: rate
    opt_g = Adam([t[n] for n in g_names], lr, cfg["beta1"], cfg["beta2"], cfg["adam_eps"])
    opt_d = Adam([t[n] for n in d_names], lr, cfg["beta1"], cfg["beta2"], cfg["adam_eps"])
    ema = {f"ema.{n[2:]}": t[n].detach().clone() for n in g_names}
    start.update({n: v.clone() for n, v in ema.items()})
    g_gen = torch.Generator(device=dev).manual_seed(noise_seeds[0])
    d_gen = torch.Generator(device=dev).manual_seed(noise_seeds[1])
    z_dim, gp_w, drift_w = cfg["latent_size"], cfg["gp_lambda"], cfg["drift_epsilon"]
    losses, first_logits = [], None
    for k in range(steps):
        alpha = alpha_at(cfg, traffic, traffic["start_step"] + k)
        real = batch_fn(k)["image"][0]
        if half_batch:
            real = real[:real.shape[0] // 2]
        n = real.shape[0]
        z_c = torch.randn(1, n, z_dim, device=dev, generator=d_gen)
        with torch.no_grad():
            fake = nets.generator(z_c.reshape(n, z_dim), alpha)
        real_logits = nets.discriminator(real, alpha)
        fake_logits = nets.discriminator(fake, alpha)
        u = torch.rand((n, 1, 1, 1), device=dev, generator=d_gen)
        x_hat = (u * real + (1.0 - u) * fake).requires_grad_(True)
        mixed_logits = nets.discriminator(x_hat, alpha)
        (gx,) = torch.autograd.grad(mixed_logits.sum(), x_hat, create_graph=True)
        gp = ((torch.sqrt(gx.pow(2).sum(dim=(1, 2, 3)) + 1e-8) - cfg["gp_target"]) ** 2).mean()
        drift = (real_logits ** 2).mean()
        wd = fake_logits.mean() - real_logits.mean()
        d_loss = wd + gp_w * gp + drift_w * drift
        d_scale = (fake_logits.abs().mean() + real_logits.abs().mean() + gp_w * gp
                   + drift_w * drift)
        if k == 0:
            first_logits = torch.cat([real_logits, fake_logits, mixed_logits]).detach().reshape(-1)
        opt_d.step(torch.autograd.grad(d_loss, opt_d.params))
        z = torch.randn(n, z_dim, device=dev, generator=g_gen)
        fake_logits = nets.discriminator(nets.generator(z, alpha), alpha)
        g_loss = -fake_logits.mean()
        opt_g.step(torch.autograd.grad(g_loss, opt_g.params))
        ema_update(list(ema.values()), opt_g.params, cfg["ema_decay"])
        losses.append({"d_loss": (float(d_loss.detach()), float(d_scale.detach())),
                       "g_loss": (float(g_loss.detach()),
                                  float(fake_logits.detach().abs().mean()))})
    grads = dict(zip(g_names + d_names, opt_g.first + opt_d.first))
    end = {**{n: t[n].detach() for n in start if not n.startswith("ema.")}, **ema}
    return readings(losses, grads, start, end, first_logits=first_logits)
