"""Plain reference of SNGAN-projection at 128x128 (Miyato & Koyama 2018,
arXiv:1802.05637; the ImageNet ResNets of pfnet-research/sngan_projection)
and of its training step: float32, TF32 off, no kernels, written from the
published description.

G: z -> linear -> 4x4x1024 -> five up-blocks (BN conditional on the class,
ReLU, nearest 2x, 3x3 conv, CBN, ReLU, 3x3 conv; a 1x1 conv of the
upsampled input as the skip) -> BN -> ReLU -> 3x3 conv -> tanh.
D: an input block (3x3 conv, ReLU, 3x3 conv, 2x2 mean pool; skip: pool then
1x1 conv), four down-blocks (ReLU, 3x3 conv, ReLU, 3x3 conv, pool; skip:
1x1 conv then pool), one block without pooling, ReLU, sum over H and W
(phi), a linear layer, plus the projection <embed(y), phi>. Every D weight
is divided by its spectral norm, from one power-iteration step per update.

The step: n_critic hinge-loss updates of D (each on fresh reals and on
fakes that one G forward made for all of them, each fake microbatch with
its own batch statistics, running statistics kept), then one G update,
then the EMA of G's parameters; Adam at the configuration's rates with a
linear decay of each optimizer's rate over its own updates.

Departures from the published code, all of them the program's too:
weights are NCHW/[out, in] tensors named as the program names them; batch
norm's variance is the biased ``max(E[x^2] - E[x]^2, 0)`` with running
statistics kept at 0.9; the conditional BN's gamma and beta tables are
stored [features, classes]; u advances once per critic update, and the G
update reads sigma without advancing it. The initial weights are the
benchmark's (``leaves``): normal with the He std (not truncated), Glorot
uniform tables, unit-normal u.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .plain import (Adam, Numerics, ema_update, kink_alternatives, pool2x, readings,
                    spectral_sigma, upsample2x)

EPS_BN = 1e-5
MOMENTUM = 0.9


def _g_blocks(cfg) -> List[Tuple[int, int]]:
    ch = cfg["g_channels"]
    return [(ch[max(i - 1, 0)], c) for i, c in enumerate(ch)]


def _d_blocks(cfg) -> List[Tuple[int, int, bool]]:
    """(in, out, pooled) of blocks 1.. (block 0 is the input block)."""
    ch, down = cfg["d_channels"], cfg["d_downsample"]
    return [(ch[i - 1], ch[i], down[i]) for i in range(1, len(ch))]


def leaves(cfg, traffic) -> List[Tuple[str, tuple, tuple]]:
    """Every tensor of the initial state: ``(name, shape, rule)`` with the
    rule ``("normal", std)``, ``("uniform", limit)`` or ``("const", v)``.
    ``g.``/``d.`` are parameters, ``gbuf.``/``dbuf.`` buffers."""
    out: List[Tuple[str, tuple, tuple]] = []

    def he(fan_in):
        return ("normal", math.sqrt(2.0 / fan_in))

    def conv(prefix, cin, cout, k, sn=False):
        out.append((f"{prefix}.weight", (cout, cin, k, k), he(cin * k * k)))
        out.append((f"{prefix}.bias", (cout,), ("const", 0.0)))
        if sn:
            out.append((f"{prefix.replace('d.', 'dbuf.', 1)}.u", (1, cout), ("normal", 1.0)))

    nc, z = cfg["num_classes"], cfg["z_dim"]
    c0 = cfg["g_channels"][0]
    out.append(("g.dense.weight", (16 * c0, z), he(z)))
    out.append(("g.dense.bias", (16 * c0,), ("const", 0.0)))
    for i, (cin, cout) in enumerate(_g_blocks(cfg)):
        for bn, ch in (("bn1", cin), ("bn2", cout)):
            out.append((f"gbuf.block{i}.{bn}.bn.running_mean", (ch,), ("const", 0.0)))
            out.append((f"gbuf.block{i}.{bn}.bn.running_var", (ch,), ("const", 1.0)))
            out.append((f"g.block{i}.{bn}.gamma.weight", (ch, nc), ("const", 1.0)))
            out.append((f"g.block{i}.{bn}.beta.weight", (ch, nc), ("const", 0.0)))
        conv(f"g.block{i}.conv1", cin, cout, 3)
        conv(f"g.block{i}.conv2", cout, cout, 3)
        conv(f"g.block{i}.conv_skip", cin, cout, 1)
    last = cfg["g_channels"][-1]
    out += [("g.bn_out.weight", (last,), ("const", 1.0)),
            ("g.bn_out.bias", (last,), ("const", 0.0)),
            ("gbuf.bn_out.running_mean", (last,), ("const", 0.0)),
            ("gbuf.bn_out.running_var", (last,), ("const", 1.0))]
    conv("g.conv_out", last, 3, 3)
    d0 = cfg["d_channels"][0]
    conv("d.block0.conv1", 3, d0, 3, sn=True)
    conv("d.block0.conv2", d0, d0, 3, sn=True)
    conv("d.block0.conv_skip", 3, d0, 1, sn=True)
    for i, (cin, cout, pooled) in enumerate(_d_blocks(cfg), start=1):
        conv(f"d.block{i}.conv1", cin, cout, 3, sn=True)
        conv(f"d.block{i}.conv2", cout, cout, 3, sn=True)
        if pooled or cin != cout:
            conv(f"d.block{i}.conv_skip", cin, cout, 1, sn=True)
    dl = cfg["d_channels"][-1]
    out += [("d.dense_out.weight", (1, dl), he(dl)), ("d.dense_out.bias", (1,), ("const", 0.0)),
            ("dbuf.dense_out.u", (1, 1), ("normal", 1.0)),
            ("d.proj_embed.weight", (dl, nc), ("uniform", math.sqrt(6.0 / (dl + nc)))),
            ("dbuf.proj_embed.u", (1, dl), ("normal", 1.0))]
    return out


class _Nets:
    """G and D as functions of the named tensors."""

    def __init__(self, cfg, t: Dict[str, torch.Tensor], num: Numerics):
        self.cfg, self.t, self.num = cfg, t, num

    def _bn(self, x, name, labels=None, groups=1, update=False):
        t = self.t
        xg = x.reshape(groups, x.shape[0] // groups, *x.shape[1:])
        mean = xg.mean(dim=(1, 3, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3, 4), keepdim=True) - mean * mean, min=0.0)
        stats = name + (".bn" if labels is not None else "")
        if update:
            with torch.no_grad():
                for stat, batch in (("running_mean", mean), ("running_var", var)):
                    t[f"gbuf.{stats}.{stat}"].mul_(MOMENTUM).add_(batch.reshape(-1),
                                                                alpha=1 - MOMENTUM)
        y = ((xg - mean) * torch.rsqrt(var + EPS_BN)).reshape(x.shape)
        if labels is None:
            shape = (1, -1, 1, 1)
            return y * t[f"g.{name}.weight"].view(shape) + t[f"g.{name}.bias"].view(shape)
        gamma = t[f"g.{name}.gamma.weight"].t()[labels]
        beta = t[f"g.{name}.beta.weight"].t()[labels]
        return y * gamma[:, :, None, None] + beta[:, :, None, None]

    def _conv(self, x, name, sigma=None):
        """A SAME convolution, its weight over ``sigma`` when given."""
        w = self.t[f"{name}.weight"]
        if sigma is not None:
            w = w / sigma
        return self.num.conv(x, w, self.t[f"{name}.bias"], padding=w.shape[-1] // 2)

    def generator(self, z, labels, groups=1, update=False):
        c0 = self.cfg["g_channels"][0]
        h = self.num.linear(z, self.t["g.dense.weight"], self.t["g.dense.bias"])
        h = h.view(-1, 4, 4, c0).permute(0, 3, 1, 2)
        bn = dict(groups=groups, update=update)
        for i in range(len(self.cfg["g_channels"])):
            x = h
            h = F.relu(self._bn(h, f"block{i}.bn1", labels, **bn))
            h = self._conv(upsample2x(h), f"g.block{i}.conv1")
            h = F.relu(self._bn(h, f"block{i}.bn2", labels, **bn))
            h = self._conv(h, f"g.block{i}.conv2")
            h = h + self._conv(upsample2x(x), f"g.block{i}.conv_skip")
        h = F.relu(self._bn(h, "bn_out", None, **bn))
        return torch.tanh(self._conv(h, "g.conv_out")).permute(0, 2, 3, 1)

    def sigmas(self, update: bool) -> Dict[str, torch.Tensor]:
        out = {}
        for name, t in list(self.t.items()):
            if name.startswith("dbuf.") and name.endswith(".u"):
                layer = name[len("dbuf."):-len(".u")]
                sigma, u_new = spectral_sigma(self.t[f"d.{layer}.weight"], t)
                if update:
                    with torch.no_grad():
                        t.copy_(u_new.reshape(t.shape))
                out[f"d.{layer}"] = sigma
        return out

    def discriminator(self, x, labels, update_sn: bool):
        s = self.sigmas(update_sn)
        conv = lambda h, n: self._conv(h, n, s[n])
        h = x.permute(0, 3, 1, 2)
        h1 = pool2x(conv(F.relu(conv(h, "d.block0.conv1")), "d.block0.conv2"))
        h = h1 + conv(pool2x(h), "d.block0.conv_skip")
        for i, (cin, cout, pooled) in enumerate(_d_blocks(self.cfg), start=1):
            h1 = conv(F.relu(conv(F.relu(h), f"d.block{i}.conv1")), f"d.block{i}.conv2")
            skip = conv(h, f"d.block{i}.conv_skip") if (pooled or cin != cout) else h
            h = (pool2x(h1) + pool2x(skip)) if pooled else h1 + skip
        phi = F.relu(h).sum(dim=(2, 3))
        out = self.num.linear(phi, self.t["d.dense_out.weight"] / s["d.dense_out"],
                              self.t["d.dense_out.bias"])
        emb = (self.t["d.proj_embed.weight"] / s["d.proj_embed"]).t()[labels]
        return out + torch.sum(emb * phi, dim=-1, keepdim=True)


def _hinge_d(real, fake):
    """The hinge loss and its scale: the mean magnitudes of its terms'
    arguments (once D separates the batch, the loss itself is 0)."""
    loss = F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean()
    real, fake = real.detach(), fake.detach()
    return loss, float((1.0 - real).abs().mean() + (1.0 + fake).abs().mean())


def follow(cfg, traffic, weights: Dict[str, torch.Tensor], batch_fn: Callable[[int], dict],
           noise_seeds: Tuple[int, int], steps: int = 3, precision: str = "fp32",
           half_batch: bool = False, kink_margin: float = 0.0) -> dict:
    """Train ``steps`` steps from ``weights`` on ``batch_fn(k)`` (``{"image":
    [n_critic, B, 128, 128, 3] float32, "label": [n_critic, B]}``), drawing
    z and the fakes' classes as the step does from generators seeded
    ``noise_seeds = (g_seed, d_seed)``; returns ``plain.readings``.
    ``half_batch`` keeps the first half of every microbatch (a fault).
    With ``kink_margin`` the readings hold D's first gradient with each
    logit within that margin of its hinge's kink counted on either side
    (``plain.kink_alternatives``)."""
    dev = next(iter(weights.values())).device
    t = {n: v.clone() for n, v in weights.items()}
    start = {n: v.clone() for n, v in t.items()}
    nets = _Nets(cfg, t, Numerics(precision))
    g_names = [n for n in t if n.startswith("g.")]
    d_names = [n for n in t if n.startswith("d.")]
    for n in g_names + d_names:
        t[n].requires_grad_(True)
    total = cfg["total_steps"]
    decay = lambda base: (lambda count: base * (1.0 - min(count, total) / total))
    opt_g = Adam([t[n] for n in g_names], decay(cfg["g_lr"]), cfg["beta1"], cfg["beta2"])
    opt_d = Adam([t[n] for n in d_names], decay(cfg["d_lr"]), cfg["beta1"], cfg["beta2"])
    ema = {f"ema.{n[2:]}": t[n].detach().clone() for n in g_names}
    start.update({n: v.clone() for n, v in ema.items()})
    g_gen = torch.Generator(device=dev).manual_seed(noise_seeds[0])
    d_gen = torch.Generator(device=dev).manual_seed(noise_seeds[1])
    n_critic, nc, z_dim = cfg["n_critic"], cfg["num_classes"], cfg["z_dim"]
    losses, alternatives, first_logits = [], None, None
    for k in range(steps):
        batch = batch_fn(k)
        images, labels = batch["image"], batch["label"].long()
        if half_batch:
            images, labels = images[:, :images.shape[1] // 2], labels[:, :labels.shape[1] // 2]
        n = images.shape[1]
        z_c = torch.randn(n_critic, n, z_dim, device=dev, generator=d_gen)
        y_c = torch.randint(0, nc, (n_critic, n), device=dev, generator=d_gen)
        with torch.no_grad():
            fakes = nets.generator(z_c.reshape(n_critic * n, z_dim), y_c.reshape(-1),
                                   groups=n_critic).reshape(n_critic, n, *images.shape[2:])
        for i in range(n_critic):
            logits = nets.discriminator(torch.cat([images[i], fakes[i]]),
                                        torch.cat([labels[i], y_c[i]]), update_sn=True)
            d_loss, d_scale = _hinge_d(logits[:n], logits[n:])
            kinked = k == 0 and i == 0 and kink_margin > 0
            grads = torch.autograd.grad(d_loss, opt_d.params, retain_graph=kinked)
            if k == 0 and i == 0:
                first_logits = logits.detach().reshape(-1)
            if kinked:
                side = torch.ones(n, device=dev)
                alternatives = kink_alternatives(
                    logits.reshape(-1), torch.cat([side, -side]),
                    torch.cat([-side, side]) / n, grads, opt_d.params, d_names, kink_margin)
            opt_d.step(grads)
        z = torch.randn(n, z_dim, device=dev, generator=g_gen)
        y = torch.randint(0, nc, (n,), device=dev, generator=g_gen)
        fake_logits = nets.discriminator(nets.generator(z, y, update=True), y, update_sn=False)
        g_loss = -fake_logits.mean()
        opt_g.step(torch.autograd.grad(g_loss, opt_g.params))
        ema_update(list(ema.values()), opt_g.params, cfg["ema_decay"])
        losses.append({"d_loss": (float(d_loss.detach()), d_scale),
                       "g_loss": (float(g_loss.detach()),
                                  float(fake_logits.detach().abs().mean()))})
    grads = dict(zip(g_names + d_names, opt_g.first + opt_d.first))
    end = {**{n: t[n].detach() for n in start if not n.startswith("ema.")}, **ema}
    return readings(losses, grads, start, end, alternatives, first_logits)
