"""Algebraically fused resize-convolutions (port of
``gan_lib_tensorflow_tpu/ops/fused.py``). Tensors are NCHW, weights OIHW.

``conv_kxk(nearest_up2(x))`` is one stride-2 transposed conv with the derived
(k+1)x(k+1) kernel ``fuse_up2_kernel(w)``; ``downsample_avg(conv_kxk(x))`` is
one stride-2 conv with ``fuse_down2_kernel(w)``.

The reference calls ``lax.conv_transpose(x, K, (2, 2), "SAME")`` with the
default ``transpose_kernel=False``: a correlation of the 2x-dilated input with
K, unflipped, padded by (pad_a, pad_b) = (k_eff - 1 - p) on both sides for
the (k+1)-tap kernel (2 for 4x4, 1 for 2x2). ``conv_transpose2d`` correlates
with the spatially flipped kernel laid out ``[in, out, kh, kw]``, so the port
hands it ``K`` flipped and transposed, with ``padding = k - 1 - pad_a``: the
output is exactly ``2H x 2W``. ``conv_transpose_same`` holds that rule for
any kernel and stride; ``ConvTranspose`` (ACGAN) uses it too.

In an 'sp' height shard (``parallel.sharding.height_shards``) both fused
convs read one input row of each neighbour (``halo_pad``): the downscale
pads its height with them instead of zeros, and the upscale computes the
haloed input's ``2(h + 2)`` output rows and keeps the ``2h`` in the middle
(its zero halo rows at the image edge are the SAME padding of the whole
image, so edge and interior shards crop alike).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import halo_pad


def fuse_up2_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, k, k) -> (O, I, k+1, k+1): the transposed-conv kernel equal to
    nearest-up2-then-conv with ``w``. ``F.pad`` takes (left, right, top,
    bottom) of W then H."""
    return (F.pad(w, (1, 0, 1, 0)) + F.pad(w, (0, 1, 1, 0))
            + F.pad(w, (1, 0, 0, 1)) + F.pad(w, (0, 1, 0, 1)))


def transpose_same_pads(kernel: int, stride: int):
    """(pad_a, pad_b) that ``lax.conv_transpose(..., "SAME")`` puts around
    the ``stride``-dilated input (k 5, s 2: (3, 2); k 4, s 2: (2, 2))."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def conv_transpose_same(x: torch.Tensor, K: torch.Tensor, stride: int,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lax.conv_transpose(x, K, (s, s), "SAME")`` (no kernel flip) for
    NCHW ``x`` and an OIHW square ``K``: output ``[N, O, sH, sW]``.

    ``conv_transpose2d`` pads the dilated input by ``k - 1 - padding`` before
    and after, so ``padding = k - 1 - pad_a`` gives XLA's pad before; a
    smaller pad after is made up by cropping the extra rows and columns at
    the end (they lie past the last SAME position), a larger one (only when
    ``stride > k``, where ``pad_a = k - 1`` and so ``padding = 0``) by
    ``stride - k`` rows and columns of zeros at the end: no input pixel
    reaches them. That is ``output_padding``'s value, padded explicitly
    because torch's CPU kernel with ``output_padding`` on a channels-last
    input crashes intermittently in its backward."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        K = K.to(compute_dtype)
    k = K.shape[-1]
    pad_a, pad_b = transpose_same_pads(k, stride)
    y = F.conv_transpose2d(x, K.flip(2, 3).transpose(0, 1), stride=stride,
                           padding=k - 1 - pad_a)
    extra = max(pad_b - pad_a, 0)
    if extra:
        y = F.pad(y, (0, extra, 0, extra))
    h, w = stride * x.shape[-2], stride * x.shape[-1]
    return y if y.shape[-2:] == (h, w) else y[..., :h, :w]


def upsample2x_conv(x: torch.Tensor, w: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """conv(nearest_up2(x), w, SAME) without the upsampled activation.

    x: NCHW, w: OIHW (square, odd k). Output ``[N, O, 2H, 2W]``."""
    h = x.shape[2]
    x, pad = halo_pad(x, 1)
    y = conv_transpose_same(x, fuse_up2_kernel(w), 2, compute_dtype)
    return y if pad else y[:, :, 2:2 + 2 * h]


def fuse_down2_kernel(w: torch.Tensor) -> torch.Tensor:
    """The stride-2 kernel equal to conv-then-box-downsample (the mean of the
    four shifted paddings)."""
    return fuse_up2_kernel(w) * 0.25


def conv_downscale2x(x: torch.Tensor, w: torch.Tensor,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """downsample_avg(conv(x, w, SAME)) without the full-res conv output.

    x: NCHW with even H, W; w: OIHW (square, odd k). Zero-padding (k-1)/2 on
    each side reproduces the SAME edges (reference ``fused.py:73-78``)."""
    K = fuse_down2_kernel(w)
    p = (w.shape[-1] - 1) // 2
    x, ph = halo_pad(x, p)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        K = K.to(compute_dtype)
    return F.conv2d(x, K, stride=2, padding=(ph, p) if ph != p else p)
