"""PGGAN: progressive-growing G and D with equalized LR, PixelNorm,
minibatch stddev, the fade-in and the WGAN-GP loss (port of
``gan_lib_tensorflow_tpu/models/pggan.py``, with its ``remat_from``, its
space-to-depth levels ``s2d_from`` and its spatial partitioning).

Each (resolution, phase) of the ladder is a network of its own. Modules carry
the reference's flax names (``dense_4``, ``conv_4``, ``block_{res}.conv1``,
``torgb_{res}``, ``fromrgb_{res}``, ``dense_out``), so parameters line up
across stages by name (``migrate_params``) and with the JAX package
(``convert.py``). Images are NHWC at the boundary, NCHW views with
channels-last strides inside.

``remat_from``: the G and D level blocks at resolutions >= this are
rematerialized (``torch.utils.checkpoint``, non-reentrant, so the gradient
penalty's double backward goes through them): only the blocks' inputs are
stored, and the blocks' forwards run again in the backward. The parameters
and the function are the same either way (reference ``pggan.py:182-185,
243, 282-284``).

``s2d_from``: the levels at resolutions >= this run on the factor-2
space-to-depth grid (``ops/s2d.py``; reference ``pggan.py:103-176``): G's
``_GenBlockS2D`` takes the normal layout and leaves the S2D one, its toRGB
too (then ``depth_to_space``); D's fromRGB and ``_DiscBlockS2D`` take the
S2D layout and the block leaves the normal one at half size, with the
``fused_scale`` order (LeakyReLU after the downscale). The S2D blocks are
the composed blocks with another ``forward``: the same parameter names,
shapes, init and equalized scaling, so ``convert.py``, ``migrate_params``,
checkpoints and ``sampling_state`` take either.

Spatial partitioning (the 'sp' axis, ``parallel/sharding.py``): in a
``sharded_step`` with sp > 1, a level of ``res`` rows with ``res >= 4 * sp``
holds the rank's ``res / sp`` rows. G runs its low levels whole on every
rank and takes the rank's rows (``split_height``) at the first sharded
level; D gathers the height (``gather_height``) after its last sharded
block, so minibatch stddev and the 4x4 trunk run whole on every 'sp' rank,
their statistics over the whole height. The blocks of a sharded level run
inside ``height_shards()``, so their convolutions exchange halo rows.
Outside a sharded step (sampling, eval, export) every level is whole.

Both fade-ins go through the hand-written kernel ``ops/fadein.py``: G blends
its new RGB with the upsampled RGB of the level below, D its first block's
output with the fromRGB of the half-size image (on the rank's rows of both
when the top level is sharded). In the reference they are written in jnp
(``pggan.py:231-234, 293-298``); the port keeps their float32 casts outside
the kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..losses import drift_penalty, gradient_penalty, wgan_d_loss, wgan_g_loss
from ..ops import (Conv, Dense, DownsampleConv, UpsampleConv, downsample_avg,
                   fadein_blend, minibatch_stddev, pixel_norm, s2d, upsample_nearest)
from ..parallel.sharding import (gather_height, global_batch, height_is_sharded,
                                 height_shards, local_rows, sp_size, split_height)
from ..train.step import GANSpec

# Karras channel schedule (fmap_base 8192, cap 512), scaled by width_mul for
# small test configurations
_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256,
             128: 128, 256: 64, 512: 32, 1024: 16}


def nf(res: int, width_mul: float = 1.0) -> int:
    return max(int(_CHANNELS[res] * width_mul), 4)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _sharded(res: int) -> bool:
    """Whether a level of ``res`` rows holds the rank's height rows in the
    enclosing sharded step."""
    return height_is_sharded(res, sp_size())


def _in_height_shards(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    with height_shards():
        return block(h)


def _level(block: nn.Module, h: torch.Tensor, res: int, remat_from: int,
           sharded: bool = False) -> torch.Tensor:
    """``block(h)``, inside ``height_shards()`` when ``sharded`` (the
    recompute of a rematerialized block too), rematerialized when
    ``remat_from`` <= ``res``."""
    fn = functools.partial(_in_height_shards, block) if sharded else block
    if remat_from and res >= remat_from:
        return checkpoint(fn, h, use_reentrant=False)
    return fn(h)


def _s2d_conv(layer: nn.Module, h: torch.Tensor, transform, tile: bool = True) -> torch.Tensor:
    """``layer``'s equalized conv on the S2D grid: its kernel through
    ``transform``, its bias tiled over the phases unless the output is in
    the normal layout (reference ``_bias_add``)."""
    y = s2d.conv_same(h, transform(layer.kernel()), layer.compute_dtype)
    b = s2d.tile_bias(layer.bias) if tile else layer.bias
    return y + (b if layer.compute_dtype is None else b.to(layer.compute_dtype)).view(1, -1, 1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """The layout both operands of the fade-in kernel are given (a no-op on
    the card, where the convolutions already produce it)."""
    return x.contiguous(memory_format=torch.channels_last)


class _GenBlock(nn.Module):
    """One G level: fused up2 + conv3x3 -> PN -> conv3x3 -> PN."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = UpsampleConv(in_channels, features, 3, equalized=True,
                                  compute_dtype=compute_dtype)
        self.conv2 = Conv(features, features, 3, equalized=True,
                          compute_dtype=compute_dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(_lrelu(self.conv1(h)))
        return pixel_norm(_lrelu(self.conv2(h)))


class _GenBlockS2D(_GenBlock):
    """``_GenBlock`` on the space-to-depth grid: normal ``[N, Cin, H, W]``
    in, S2D ``[N, 4f, H, W]`` (the ``[N, f, 2H, 2W]`` output) out; the same
    function and parameters."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = s2d.pixel_norm_s2d(_lrelu(_s2d_conv(self.conv1, h, s2d.s2d_upconv_kernel)))
        return s2d.pixel_norm_s2d(_lrelu(_s2d_conv(self.conv2, h, s2d.s2d_conv_kernel)))


class _DiscBlock(nn.Module):
    """One D level: conv3x3 -> conv3x3 (channel step) -> avg-pool.
    ``fused_scale`` computes the second conv and the pool as one stride-2
    conv and puts the LeakyReLU after the pool (reference ``pggan.py:
    94-97``); the parameters are the same either way."""

    def __init__(self, features1: int, features2: int, fused_scale: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.fused_scale = fused_scale
        self.conv1 = Conv(features1, features1, 3, equalized=True, compute_dtype=cd)
        if fused_scale:
            self.conv2 = DownsampleConv(features1, features2, 3, equalized=True,
                                        compute_dtype=cd)
        else:
            self.conv2 = Conv(features1, features2, 3, equalized=True,
                              compute_dtype=cd)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = _lrelu(self.conv1(h))
        if self.fused_scale:
            return _lrelu(self.conv2(h))
        return downsample_avg(_lrelu(self.conv2(h)))


class _DiscBlockS2D(_DiscBlock):
    """``_DiscBlock(fused_scale=True)`` on the space-to-depth grid: S2D
    ``[N, 4C, H/2, W/2]`` (the ``[N, C, H, W]`` input) in, normal
    ``[N, f2, H/2, W/2]`` out, LeakyReLU after the downscale; the same
    parameters."""

    def __init__(self, features1: int, features2: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(features1, features2, True, compute_dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = _lrelu(_s2d_conv(self.conv1, h, s2d.s2d_conv_kernel))
        return _lrelu(_s2d_conv(self.conv2, h, s2d.s2d_downconv_kernel, tile=False))


class PGGANGenerator(nn.Module):
    """z ``[N, z_dim]`` -> float32 NHWC images ``[N, res, res, 3]`` (no tanh,
    as the reference); the rank's ``res / sp`` rows in a step whose 'sp'
    axis shards the top level. ``s2d_from``: the levels at resolutions >=
    this on the space-to-depth grid (0 = none)."""

    def __init__(self, resolution: int = 1024, fade_in: bool = False,
                 z_dim: int = 512, width_mul: float = 1.0, remat_from: int = 0,
                 s2d_from: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resolution, self.z_dim, self.width_mul = resolution, z_dim, width_mul
        self.remat_from, self.s2d_from = remat_from, s2d_from
        self.fade_in = fade_in and resolution > 4
        wm, cd = width_mul, compute_dtype
        self.dense_4 = Dense(z_dim, 16 * nf(4, wm), equalized=True, compute_dtype=cd)
        self.conv_4 = Conv(nf(4, wm), nf(4, wm), 3, equalized=True, compute_dtype=cd)
        res = 8
        while res <= resolution:
            block = _GenBlockS2D if self._s2d_at(res) else _GenBlock
            self.add_module(f"block_{res}", block(nf(res // 2, wm), nf(res, wm), cd))
            res *= 2
        self.add_module(f"torgb_{resolution}", Conv(
            nf(resolution, wm), 3, 1, equalized=True, gain=1.0, compute_dtype=cd))
        if self.fade_in:
            self.add_module(f"torgb_{resolution // 2}", Conv(
                nf(resolution // 2, wm), 3, 1, equalized=True, gain=1.0,
                compute_dtype=cd))

    def _s2d_at(self, res: int) -> bool:
        return bool(self.s2d_from) and res >= self.s2d_from

    def forward(self, z: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        c = nf(4, self.width_mul)
        h = self.dense_4(pixel_norm(z))  # normalized latents (Karras section 4.2)
        # the reference reshapes NHWC; permuting that to NCHW keeps its column
        # order and gives channels-last strides
        h = pixel_norm(_lrelu(h.view(-1, 4, 4, c).permute(0, 3, 1, 2)))
        h = pixel_norm(_lrelu(self.conv_4(h)))
        prev, res = h, 8
        local = on_s2d = False
        while res <= self.resolution:
            if on_s2d:  # the level below left the S2D grid
                h, on_s2d = s2d.depth_to_space(h), False
            shard = _sharded(res)
            if shard and not local:  # the rank's rows of the first sharded level's input
                h, local = split_height(h), True
            prev = h
            h = _level(getattr(self, f"block_{res}"), h, res, self.remat_from, shard)
            on_s2d = self._s2d_at(res)
            res *= 2
        torgb = getattr(self, f"torgb_{self.resolution}")
        if on_s2d:
            rgb = s2d.depth_to_space(_s2d_conv(torgb, h, s2d.s2d_conv_kernel)).float()
        else:
            rgb = torgb(h).float()
        if self.fade_in:
            rgb_prev = getattr(self, f"torgb_{self.resolution // 2}")(prev).float()
            rgb = fadein_blend(_channels_last(rgb),
                               _channels_last(upsample_nearest(rgb_prev)), alpha)
        return rgb.permute(0, 2, 3, 1)


class PGGANDiscriminator(nn.Module):
    """NHWC images (the rank's rows in a step whose 'sp' axis shards the top
    level) -> float32 logits ``[N, 1]``. ``fused_from``: the D blocks at
    resolutions >= this use the ``fused_scale`` form (0 = none);
    ``s2d_from``: the levels at resolutions >= this run on the
    space-to-depth grid, in the ``fused_scale`` order (0 = none)."""

    def __init__(self, resolution: int = 1024, fade_in: bool = False,
                 width_mul: float = 1.0, mbstd_group_size: int = 4,
                 fused_from: int = 0, remat_from: int = 0, s2d_from: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resolution, self.mbstd_group_size = resolution, mbstd_group_size
        self.remat_from, self.s2d_from = remat_from, s2d_from
        self.fade_in = fade_in and resolution > 4
        self.compute_dtype = compute_dtype
        wm, cd = width_mul, compute_dtype
        self.add_module(f"fromrgb_{resolution}", Conv(
            3, nf(resolution, wm), 1, equalized=True, compute_dtype=cd))
        res = resolution
        while res > 4:
            if self._s2d_at(res):
                block = _DiscBlockS2D(nf(res, wm), nf(res // 2, wm), cd)
            else:
                block = _DiscBlock(nf(res, wm), nf(res // 2, wm),
                                   bool(fused_from) and res >= fused_from, cd)
            self.add_module(f"block_{res}", block)
            res //= 2
        if self.fade_in:
            self.add_module(f"fromrgb_{resolution // 2}", Conv(
                3, nf(resolution // 2, wm), 1, equalized=True, compute_dtype=cd))
        self.conv_4 = Conv(nf(4, wm) + 1, nf(4, wm), 3, equalized=True, compute_dtype=cd)
        self.dense_4 = Dense(16 * nf(4, wm), nf(4, wm), equalized=True, compute_dtype=cd)
        self.dense_out = Dense(nf(4, wm), 1, equalized=True, gain=1.0,
                               compute_dtype=torch.float32)

    def _s2d_at(self, res: int) -> bool:
        return bool(self.s2d_from) and res >= self.s2d_from

    def forward(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        out_dtype = x.dtype if self.compute_dtype is None else self.compute_dtype
        fromrgb = getattr(self, f"fromrgb_{self.resolution}")
        on_s2d = self._s2d_at(self.resolution)
        if on_s2d:
            h = _lrelu(_s2d_conv(fromrgb, s2d.space_to_depth(x), s2d.s2d_conv_kernel))
        else:
            h = _lrelu(fromrgb(x))
        local = _sharded(self.resolution)  # x holds the rank's rows
        res = self.resolution
        while res > 4:
            if local and not _sharded(res):
                h, local = gather_height(h), False
            if self._s2d_at(res) and not on_s2d:
                h = s2d.space_to_depth(h)
            h = _level(getattr(self, f"block_{res}"), h, res, self.remat_from, local)
            on_s2d = False  # every block leaves the normal layout
            if res == self.resolution and self.fade_in:
                skip = getattr(self, f"fromrgb_{res // 2}")(downsample_avg(x))
                h = fadein_blend(_channels_last(h.float()),
                                 _channels_last(_lrelu(skip.float())), alpha)
                h = h.to(out_dtype)
            res //= 2
        if local:  # minibatch stddev and the trunk see the whole height
            h = gather_height(h)
        h = minibatch_stddev(h, self.mbstd_group_size)
        h = _lrelu(self.conv_4(h))
        # the reference flattens NHWC (pggan.py:305): flatten an NHWC view so
        # dense_4's input columns keep its order
        h = _lrelu(self.dense_4(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)))
        return self.dense_out(h)


def migrate_params(old: Mapping[str, torch.Tensor],
                   new: Mapping[str, torch.Tensor]) -> int:
    """Cross-level growth: copy, in place, every tensor of ``new`` whose name
    and shape ``old`` also has (the shared trunk and the previous toRGB /
    fromRGB); the rest keep their fresh init. Returns the count copied (the
    reference's ``migrate_params``, which returns the merged tree too)."""
    copied = 0
    with torch.no_grad():
        for name, v in old.items():
            t = new.get(name)
            if t is not None and t.shape == v.shape:
                t.copy_(v)
                copied += 1
    return copied


def sampling_state(state, resolution: int):
    """A copy of ``state`` (an ``EvalState`` of a ``resolution`` checkpoint)
    for a G built without the fade-in: its G and EMA parameters without the
    transition phase's second toRGB (``torgb_{resolution/2}.*``). The
    reference's sampler, eval and export build G with ``fade_in=False``, and
    flax ignores those parameters, so a transition checkpoint samples as G
    at alpha 1, whatever its alpha (reference ``cli/sample.py:65-67``,
    ``cli/evaluate.py:223``)."""
    drop = f"torgb_{resolution // 2}."
    keep = lambda params: (None if params is None else
                           {k: v for k, v in params.items() if not k.startswith(drop)})
    return dataclasses.replace(state, g=keep(state.g), ema_params=keep(state.ema_params))


def make_pggan_spec(g_model: PGGANGenerator, d_model: PGGANDiscriminator,
                    gp_weight: float = 10.0, drift_weight: float = 1e-3,
                    ema_decay: float = 0.999) -> GANSpec:
    """WGAN-GP + drift spec (reference ``make_pggan_spec``), n_critic 1.
    Real, fake and interpolates take three separate D forwards, as in the
    reference: one concatenated batch would mix the minibatch-stddev
    groups. Unconditional: the step's ``labels`` are None."""

    def prepare_fakes(z_stack: torch.Tensor, alpha: float, labels=None) -> torch.Tensor:
        n_micro, n = z_stack.shape[:2]
        with torch.no_grad():
            fake = g_model(z_stack.reshape(n_micro * n, -1), alpha)
        return fake.reshape(n_micro, n, *fake.shape[1:])

    def d_loss(real, fake, alpha: float, noise: Optional[torch.Generator],
               u_gp: Optional[torch.Tensor], labels=None, masks=None):
        real_logits = d_model(real, alpha)
        fake_logits = d_model(fake, alpha)
        if u_gp is None:  # drawn at the global batch; the rank keeps its rows
            u_gp = local_rows(torch.rand((global_batch(real.shape[0]),) + (1,) * (real.dim() - 1),
                                         device=real.device, generator=noise))
        gp = gradient_penalty(lambda x: d_model(x, alpha), real, fake, u_gp,
                              height_sharded=_sharded(d_model.resolution))
        wd = wgan_d_loss(real_logits, fake_logits)
        loss = wd + gp_weight * gp + drift_weight * drift_penalty(real_logits)
        return loss, {"d_loss": loss.detach(), "wdist": -wd.detach(),
                      "gp": gp.detach()}

    def g_loss(z: torch.Tensor, alpha: float, labels=None, noise=None, masks=None):
        return wgan_g_loss(d_model(g_model(z, alpha), alpha)), {}

    return GANSpec(prepare_fakes=prepare_fakes, d_loss=d_loss, g_loss=g_loss,
                   n_critic=1, ema_decay=ema_decay, z_dim=g_model.z_dim)


def make_sampler(g_model: PGGANGenerator):
    """``sample(state, z)``: G with the EMA parameters (G's own when the
    state has none) at the state's alpha (reference ``pggan.py:369-375``)."""

    @torch.no_grad()
    def sample(state, z: torch.Tensor) -> torch.Tensor:
        if state.ema_params is not None:
            return functional_call(g_model, state.ema_params, (z, state.alpha))
        return g_model(z, state.alpha)

    return sample
