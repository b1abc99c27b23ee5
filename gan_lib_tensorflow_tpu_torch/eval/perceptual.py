"""PGGAN's eval metrics (port of ``gan_lib_tensorflow_tpu/eval/perceptual.py``):
the sliced Wasserstein distance (SWD) between Laplacian-pyramid patch
descriptors of real and generated images, per pyramid level, and MS-SSIM
between pairs of generated images (diversity: lower is more diverse), as
Karras et al. (2018) evaluate the progressive ladder.

Everything runs on the images' device, float32 with TF32 off (the
reference's blur and SSIM convolutions are float32 and its projection runs
at ``Precision.HIGHEST``). The random draws are arguments: the patch origins
of ``_patch_descriptors`` and the direction draws of ``sliced_wasserstein``,
and ``swd_pyramid`` takes them from an ``SWDDraws`` (a CPU
``torch.Generator`` seeded from ``seed`` by default), so a test can replay
the reference's JAX keys through the port.

Memory at Karras scale (16,384 images x 128 patches = 2,097,152 descriptors
of 7x7x3 per level and side): the descriptors are stored in float16 (616.6
MB per level per side), each level is normalized, scored and freed before
the next, the normalize and the projections run over row chunks (no float32
copy of a level), and the sorts run 128 directions at a time.

The SWD pass's stages run inside ``torch.profiler`` ranges (``swd.pyramid``,
``swd.descriptors``, ``swd.normalize``, ``swd.project``, ``swd.sort``), which
a profiler's trace reads as device spans; without a profiler they cost a few
microseconds of host time each.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .inception_v3 import _no_tf32

# rows per chunk of the descriptor normalize and projection passes
_ROW_CHUNK = 1 << 18


# ---------------------------------------------------------------- pyramids

_GAUSS5 = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float32) / 256.0


def _depthwise(x: torch.Tensor, kernel: np.ndarray, padding: int) -> torch.Tensor:
    """One 2-D ``kernel`` over each channel of NHWC ``x`` (``groups=C``)."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel, device=x.device).expand(c, 1, *kernel.shape).contiguous()
    with _no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 5x5 gaussian, SAME, NHWC."""
    return _depthwise(x, _GAUSS5, 2)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, ::2, ::2, :]


def _upsample(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    up = x.new_zeros((n, 2 * h, 2 * w, c))
    up[:, ::2, ::2, :] = x
    return _blur(up) * 4.0


def laplacian_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """The Laplacian pyramid of NHWC ``x``, finest level first; the last
    entry is the residual gaussian level."""
    levels = []
    for _ in range(n_levels - 1):
        down = _downsample(x)
        levels.append(x - _upsample(down))
        x = down
    levels.append(x)
    return levels


# ------------------------------------------------------------------- SWD

def _patch_descriptors(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                       patch: int, desc_dtype=torch.float16) -> torch.Tensor:
    """The ``patch x patch x C`` windows of NHWC ``imgs`` at origins
    ``(y0, x0)`` (``[B, P]`` each), one gather, as ``[B * P, patch * patch *
    C]`` rows in ``desc_dtype``."""
    b, _, _, c = imgs.shape
    n_patches = y0.shape[1]
    d = torch.arange(patch, device=imgs.device)
    yy = y0.to(imgs.device)[:, :, None, None] + d[None, None, :, None]
    xx = x0.to(imgs.device)[:, :, None, None] + d[None, None, None, :]
    bb = torch.arange(b, device=imgs.device)[:, None, None, None]
    return imgs[bb, yy, xx, :].reshape(b * n_patches, patch * patch * c).to(desc_dtype)


def _normalize_descriptors(d: torch.Tensor, patch: int, c: int) -> torch.Tensor:
    """Karras's normalize: the per-channel mean and std over the whole
    descriptor set removed, the statistics accumulated in float32 (one-pass
    ``E[x^2] - mu^2``, ``+1e-8`` on the std), the output in ``d``'s dtype.
    Row chunks: no float32 copy of the whole set."""
    n = d.shape[0]
    s1 = torch.zeros(c, dtype=torch.float32, device=d.device)
    s2 = torch.zeros_like(s1)
    for i in range(0, n, _ROW_CHUNK):
        x = d[i:i + _ROW_CHUNK].reshape(-1, c).float()
        s1 += x.sum(0)
        s2 += x.square().sum(0)
    count = n * patch * patch
    mu = s1 / count
    var = s2 / count - mu.square()
    sd = var.clamp_min(0.0).sqrt() + 1e-8
    out = torch.empty_like(d)
    for i in range(0, n, _ROW_CHUNK):
        x = d[i:i + _ROW_CHUNK].reshape(-1, patch * patch, c).float()
        out[i:i + _ROW_CHUNK] = ((x - mu) / sd).reshape(x.shape[0], -1).to(d.dtype)
    return out


def _project(a: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``a @ dirs`` in float32, ``a`` cast one row chunk at a time."""
    out = torch.empty(a.shape[0], dirs.shape[1], dtype=torch.float32, device=a.device)
    with _no_tf32():
        for i in range(0, a.shape[0], _ROW_CHUNK):
            torch.matmul(a[i:i + _ROW_CHUNK].float(), dirs, out=out[i:i + _ROW_CHUNK])
    return out


def _sorted_projection(a: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``a @ dirs`` sorted along the sample axis."""
    with record_function("swd.project"):
        p = _project(a, dirs)
    with record_function("swd.sort"):
        return torch.sort(p, dim=0).values


def sliced_wasserstein(a: torch.Tensor, b: torch.Tensor, normals: torch.Tensor,
                       proj_chunk: int = 128) -> torch.Tensor:
    """SWD between two equal-sized descriptor sets ``[N, dim]``: both
    projected onto the columns of ``normals`` (``[dim, n_proj]`` standard
    normal draws, each scaled to unit length here), sorted along the sample
    axis per direction, the mean absolute difference of the sorted
    projections; ``proj_chunk`` directions at a time, so the sort buffers are
    ``[N, proj_chunk]`` per side (reference ``perceptual.py:109-136``)."""
    dirs = normals.to(a.device, torch.float32)
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=0, keepdim=True) + 1e-12)
    n_proj = dirs.shape[1]
    proj_chunk = min(proj_chunk, n_proj)
    if n_proj % proj_chunk:
        raise ValueError(f"{n_proj} directions are not whole chunks of {proj_chunk}")
    per_chunk = []
    for j in range(0, n_proj, proj_chunk):
        d = dirs[:, j:j + proj_chunk].contiguous()
        pa = _sorted_projection(a, d)
        pb = _sorted_projection(b, d)
        per_chunk.append((pa - pb).abs_().mean())
        del pa, pb
    return torch.stack(per_chunk).mean()


class SWDDraws:
    """The random draws of ``swd_pyramid``, from one CPU ``torch.Generator``
    seeded with ``seed``: ``start_batch()`` before each batch of images,
    ``patch_origins`` for each (side, level) of that batch, then
    ``directions`` for each (level, repeat) of the scoring. A replay of
    another schedule (the reference's JAX keys) implements the same
    methods."""

    def __init__(self, seed: int = 0):
        self.gen = torch.Generator().manual_seed(seed)

    def start_batch(self) -> None:
        pass

    def patch_origins(self, side: str, level: int, b: int, h: int, w: int,
                      n_patches: int, patch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        y0 = torch.randint(0, h - patch + 1, (b, n_patches), generator=self.gen)
        x0 = torch.randint(0, w - patch + 1, (b, n_patches), generator=self.gen)
        return y0, x0

    def directions(self, dim: int, n: int) -> torch.Tensor:
        return torch.randn(dim, n, generator=self.gen)


def swd_pyramid(real_batches: Iterable[torch.Tensor], fake_batches: Iterable[torch.Tensor],
                resolution: int, min_res: int = 16, n_patches: int = 128, patch: int = 7,
                n_proj: int = 512, seed: int = 0, repeats: int = 4,
                desc_dtype=torch.float16,
                draws: Optional[SWDDraws] = None) -> Dict[str, object]:
    """SWD x 10^3 per pyramid level, ``swd_{res}`` finest first, their mean
    ``swd_avg``, and ``swd_desc_dtype`` (Karras Table 2's layout; reference
    ``perceptual.py:139-207``). Both iterables give NHWC batches in [-1, 1]
    of one shape, as many of each. Resolutions below ``min_res`` evaluate as
    one level at their own resolution, the patch clamped to the image."""
    draws = draws or SWDDraws(seed)
    n_levels = max(int(np.log2(max(resolution // min_res, 1))) + 1, 1)
    patch = min(patch, resolution)
    per_level: Dict[str, List] = {"real": [[] for _ in range(n_levels)],
                                  "fake": [[] for _ in range(n_levels)]}
    with torch.no_grad():
        for r_imgs, f_imgs in zip(real_batches, fake_batches):
            draws.start_batch()
            for side, imgs in (("real", r_imgs), ("fake", f_imgs)):
                with record_function("swd.pyramid"):
                    levels = laplacian_pyramid(imgs.float(), n_levels)
                with record_function("swd.descriptors"):
                    for lv, x in enumerate(levels):
                        y0, x0 = draws.patch_origins(side, lv, x.shape[0], x.shape[1],
                                                     x.shape[2], n_patches, patch)
                        per_level[side][lv].append(
                            _patch_descriptors(x, y0, x0, patch, desc_dtype))
                del levels
        c = 3
        out: Dict[str, object] = {}
        for lv in range(n_levels):
            # one level at a time, each list dropped as soon as it is joined
            with record_function("swd.normalize"):
                dr = _normalize_descriptors(_take(per_level["real"], lv), patch, c)
                df = _normalize_descriptors(_take(per_level["fake"], lv), patch, c)
            vals = [float(sliced_wasserstein(dr, df, draws.directions(dr.shape[1], n_proj)))
                    for _ in range(repeats)]
            del dr, df
            out[f"swd_{resolution // 2 ** lv}"] = float(np.mean(vals)) * 1e3
    out["swd_avg"] = float(np.mean(list(out.values())))
    out["swd_desc_dtype"] = str(desc_dtype).replace("torch.", "")
    return out


def _take(levels: List, lv: int) -> torch.Tensor:
    """The joined descriptors of level ``lv``, its list of batches dropped."""
    parts, levels[lv] = levels[lv], None
    return torch.cat(parts)


# ---------------------------------------------------------------- MS-SSIM

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _ssim_window(win: int = 11) -> np.ndarray:
    """The ``win x win`` gaussian window of SSIM (sigma 1.5), float32."""
    g = np.exp(-0.5 * ((np.arange(win) - (win - 1) / 2.0) / 1.5) ** 2)
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def _ssim_cs(a: torch.Tensor, b: torch.Tensor,
             win: int = 11) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image mean luminance (l) and contrast-structure (cs) terms of
    SSIM (Wang et al.) for NHWC images in [0, 1], ``win x win`` gaussian
    window, VALID."""
    k = _ssim_window(win)
    conv = lambda x: _depthwise(x, k, 0)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = conv(a), conv(b)
    var_a = conv(a * a) - mu_a ** 2
    var_b = conv(b * b) - mu_b ** 2
    cov = conv(a * b) - mu_a * mu_b
    l = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    return l.mean((1, 2, 3)), cs.mean((1, 2, 3))


def ms_ssim(a: torch.Tensor, b: torch.Tensor,
            weights: Sequence[float] = _MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM per pair (Wang 2003) of NHWC images in [-1, 1],
    ``[B]``: cs at every scale, luminance at the coarsest. Scales the
    resolution cannot hold (an 11 px window each) are dropped and the
    remaining exponents renormalized; an image below 11 px takes one scale
    with the window shrunk to the image (reference ``perceptual.py:
    242-264``)."""
    win = min(11, a.shape[1], a.shape[2])
    max_scales = max(int(np.log2(min(a.shape[1], a.shape[2]) / win)) + 1, 1)
    w_used = np.asarray(weights[:max_scales], np.float64)
    w_used = tuple(w_used / w_used.sum())
    a = (a.float() + 1.0) * 0.5
    b = (b.float() + 1.0) * 0.5
    vals = []
    for i, w in enumerate(w_used):
        l, cs = _ssim_cs(a, b, win=win)
        if i == len(w_used) - 1:
            vals.append((l * cs).clamp_min(0.0) ** float(w))
        else:
            vals.append(cs.clamp_min(0.0) ** float(w))
            a, b = _downsample(a), _downsample(b)
    return torch.stack(vals).prod(0)


def ms_ssim_diversity(sample_fn: Callable[[], torch.Tensor], n_pairs: int,
                      batch_size: int = 8) -> Tuple[float, float]:
    """Mean and std of MS-SSIM over generated pairs (Karras's diversity:
    lower is more diverse). ``sample_fn()`` gives ``[2 * batch_size, H, W,
    C]`` images (its draws are its own); the halves are paired, ``max(n_pairs
    // batch_size, 1)`` times."""
    scores = []
    with torch.no_grad():
        for _ in range(max(n_pairs // batch_size, 1)):
            imgs = sample_fn()
            scores.append(ms_ssim(imgs[:batch_size], imgs[batch_size:]).cpu())
    s = torch.cat(scores).numpy()
    return float(s.mean()), float(s.std())
