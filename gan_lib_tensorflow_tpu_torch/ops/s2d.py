"""Space-to-depth rewrites of the PGGAN top levels' convolutions (port of
``gan_lib_tensorflow_tpu/ops/s2d.py``). Tensors are NCHW, kernels OIHW.

On the factor-2 space-to-depth grid an ``[N, C, H, W]`` tensor becomes
``[N, 4C, H/2, W/2]``, phase-major: channel ``(py*2 + px)*C + c`` holds pixel
``(2i + py, 2j + px)`` of channel c (``F.pixel_unshuffle`` is channel-major,
``c*4 + py*2 + px``, so it is not used). A stride-1 kxk SAME conv of the
pixel grid is a 3x3 (k 1: 1x1) SAME conv of the cell grid with a kernel
scattered from the original one: output phase (r, s), tap (dy, dx) reads
cell offset ``floor((r + dy) / 2)`` at input phase ``(r + dy) mod 2``.

The three transforms are linear in the original kernel, so equalized
scaling, checkpoints, ``migrate_params`` and gradients are those of the
composed path, and the S2D path is a layout of the same function:

* ``s2d_conv_kernel``       stride-1 conv, S2D in  -> S2D out
* ``s2d_upconv_kernel``     nearest-up2 + conv, normal in -> S2D out
* ``s2d_downconv_kernel``   conv + box-down2, S2D in -> normal out

The reference scatters each tap with its own ``.at[].add`` at trace time.
Here each transform is one ``einsum`` of the kernel with a constant 0/1
scatter tensor (``_scatter``, cached per kernel size, variant, dtype and
device), so a forward adds one op per transform, not 36; the einsum is
linear in the weight, and the penalty's double backward goes through it.

Under spatial partitioning (``parallel.sharding.height_shards``) a cell
conv of the 3x3 cell kernel takes one halo cell row (two pixel rows) from
each 'sp' neighbour; the 1x1 cell kernels and the layout changes are local.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import halo_pad


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W] -> [N, 4C, H/2, W/2]``, phase-major channels; the
    result has channels-last strides."""
    n, c, h, w = x.shape
    t = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return t.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (channels-last strides out)."""
    n, c4, h, w = x.shape
    c = c4 // 4
    t = x.permute(0, 2, 3, 1).reshape(n, h, w, 2, 2, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c)
    return t.permute(0, 3, 1, 2)


def _cell_kernel_size(k: int) -> int:
    """Cell-space kernel size covering taps r + d, r in {0, 1}, |d| <= k//2."""
    half = k // 2
    lo = -((half + 1) // 2)                 # floor((0 - half) / 2)
    hi = (1 + half) // 2                    # floor((1 + half) / 2)
    return hi - lo + 1


def _scatter_np(k: int) -> np.ndarray:
    """``T[cy, cx, py, px, r, s, ky, kx] = 1`` where output phase (r, s)
    reads tap (ky, kx) of the kxk kernel at cell (cy, cx), input phase
    (py, px) (the reference's ``_build`` loop)."""
    half, kc = k // 2, _cell_kernel_size(k)
    c0 = (kc - 1) // 2
    t = np.zeros((kc, kc, 2, 2, 2, 2, k, k), np.float32)
    for r in (0, 1):
        for s in (0, 1):
            for dy in range(-half, half + 1):
                for dx in range(-half, half + 1):
                    ty, tx = r + dy, s + dx
                    t[c0 + ty // 2, c0 + tx // 2, ty % 2, tx % 2, r, s,
                      half + dy, half + dx] += 1.0
    return t


@functools.lru_cache(maxsize=None)
def _scatter(k: int, variant: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The scatter tensor of one transform: ``conv`` keeps both phase
    pairs, ``up`` sums over the input phases (nearest-up2 input has none),
    ``down`` sums over the output phases with weight 1/4 (the box pool)."""
    t = _scatter_np(k)
    if variant == "up":
        t = t.sum(axis=(2, 3))
    elif variant == "down":
        t = t.sum(axis=(4, 5)) * 0.25
    return torch.from_numpy(np.ascontiguousarray(t)).to(device=device, dtype=dtype)


def _check(w: torch.Tensor) -> int:
    k = w.shape[-1]
    if k % 2 == 0 or w.shape[-2] != k:
        raise ValueError(f"space-to-depth transforms take odd square kernels, got "
                         f"{tuple(w.shape)}")
    return k


def s2d_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """``(O, I, k, k) -> (4O, 4I, kc, kc)``: ``conv_same(space_to_depth(x),
    out) == space_to_depth(conv_same(x, w))``."""
    k = _check(w)
    o, i, kc = w.shape[0], w.shape[1], _cell_kernel_size(k)
    t = _scatter(k, "conv", w.dtype, w.device)
    return torch.einsum("YXpqrsab,oiab->rsopqiYX", t, w).reshape(4 * o, 4 * i, kc, kc)


def s2d_upconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """``(O, I, k, k) -> (4O, I, kc, kc)``: ``conv_same(x, out) ==
    space_to_depth(conv_same(nearest_up2(x), w))``."""
    k = _check(w)
    o, i, kc = w.shape[0], w.shape[1], _cell_kernel_size(k)
    t = _scatter(k, "up", w.dtype, w.device)
    return torch.einsum("YXrsab,oiab->rsoiYX", t, w).reshape(4 * o, i, kc, kc)


def s2d_downconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """``(O, I, k, k) -> (O, 4I, kc, kc)``: ``conv_same(space_to_depth(x),
    out) == downsample_avg(conv_same(x, w))`` (the four output phases of a
    cell averaged into its pooled pixel)."""
    k = _check(w)
    o, i, kc = w.shape[0], w.shape[1], _cell_kernel_size(k)
    t = _scatter(k, "down", w.dtype, w.device)
    return torch.einsum("YXpqab,oiab->opqiYX", t, w).reshape(o, 4 * i, kc, kc)


def conv_same(x: torch.Tensor, kernel: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME conv of NCHW ``x`` with an odd OIHW ``kernel`` (the
    transformed kernels); in an 'sp' height shard the halo rows of the 'sp'
    neighbours take the place of the zero rows."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    p = kernel.shape[-1] // 2
    x, ph = halo_pad(x, p)
    return F.conv2d(x, kernel, padding=(ph, p))


def tile_bias(bias: torch.Tensor) -> torch.Tensor:
    """A per-channel bias in S2D layout: each phase group repeats it."""
    return bias.repeat(4)


def pixel_norm_s2d(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """PixelNorm of an S2D tensor: each original pixel is one (phase, C)
    group, normalized over its C channels only (``pixel_norm`` of the
    normal-layout tensor), statistics in float32, cast back."""
    n, c4, h, w = x.shape
    g = x.float().unflatten(1, (4, c4 // 4))
    g = g * torch.rsqrt(torch.mean(g * g, dim=2, keepdim=True) + epsilon)
    return g.flatten(1, 2).to(x.dtype)
