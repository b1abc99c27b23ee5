"""The port's strided ``Conv``, ``ConvTranspose`` and ``dropout`` against the
JAX package's ``Conv``, ``ConvTranspose`` and flax ``nn.Dropout``.

Same numpy inputs through both, the port's weights the JAX init's carried
over by ``convert.to_torch_names``; float32 on the CPU, forward and
gradients at rtol 1e-4 / atol 1e-5 (summation order is the only
difference). Two padding traps are pinned: TF-SAME at stride 2 pads (0, 1)
for a 3x3 kernel on 32 (a symmetric pad of 1 is far off), and
``lax.conv_transpose`` SAME at k 5, s 2 pads the dilated input (3, 2)
(``conv_transpose2d``'s padding 2 with output_padding 1 pads (2, 3)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from gan_lib_tensorflow_tpu.ops import layers as jlayers
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.ops import fused as tfused
from gan_lib_tensorflow_tpu_torch.ops import layers as tlayers

RTOL, ATOL = 1e-4, 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _parity(jmod, tmod, x):
    """Forward of both, then the grads of sum(y * r) wrt input and params;
    returns the JAX output."""
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod.load_state_dict({k: torch.tensor(v) for k, v in
                          to_torch_names(variables["params"]).items()}, strict=True)
    y_j = jmod.apply(variables, jnp.asarray(x))
    r = _img(y_j.shape, seed=1)
    gp_j, gx_j = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * r),
                          argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    y_t = tmod(xt)
    _close(_nhwc(y_t), y_j)
    (y_t * _nchw(r)).sum().backward()
    _close(_nhwc(xt.grad), gx_j)
    ref = to_torch_names(gp_j)
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), ref[name])
    return np.asarray(y_j)


@pytest.mark.parametrize("size", [7, 32])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_parity(stride, k, size):
    """SAME at every stride, kernel and size parity (odd and even totals)."""
    y = _parity(jlayers.Conv(4, k, strides=stride), tlayers.Conv(3, 4, k, stride=stride),
                _img((2, size, size + 1, 3)))
    assert y.shape[1:3] == (-(-size // stride), -(-(size + 1) // stride))


@pytest.mark.parametrize("padding", ["VALID", ((1, 1), (1, 1)), ((0, 2), (1, 0))])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_valid_and_explicit_padding(padding, stride):
    """VALID and explicit pairs (pix2pix's pad-1 PatchGAN convs), k 4."""
    _parity(jlayers.Conv(5, 4, strides=stride, padding=padding),
            tlayers.Conv(3, 5, 4, stride=stride, padding=padding), _img((2, 9, 8, 3)))


def test_stride2_same_pads_zero_before_one_after():
    """The trap: XLA's SAME at stride 2, 3x3 on 32 is (0, 1), exactly the
    explicit pair; the port agrees, and the symmetric pad of 1 does not."""
    assert tlayers.same_pads(32, 3, 2) == (0, 1)
    x = _img((1, 32, 32, 3), seed=2)
    w = _img((3, 3, 3, 8), seed=3)
    dn = ("NHWC", "HWIO", "NHWC")
    same = jax.lax.conv_general_dilated(x, w, (2, 2), "SAME", dimension_numbers=dn)
    explicit = jax.lax.conv_general_dilated(x, w, (2, 2), ((0, 1), (0, 1)),
                                            dimension_numbers=dn)
    np.testing.assert_array_equal(np.asarray(same), np.asarray(explicit))
    conv = tlayers.Conv(3, 8, 3, stride=2)
    conv.load_state_dict({"weight": torch.tensor(w).permute(3, 2, 0, 1),
                          "bias": torch.zeros(8)})
    with torch.no_grad():
        y = _nhwc(conv(_nchw(x)))
        symmetric = _nhwc(F.conv2d(_nchw(x), conv.weight, stride=2, padding=1))
    _close(y, same)
    assert np.abs(symmetric - np.asarray(same)).max() > 1.0


@pytest.mark.parametrize("k,stride", [(4, 2), (5, 2), (3, 2), (2, 2), (1, 2), (3, 3)])
def test_conv_transpose_parity(k, stride):
    """SAME transposed conv, odd and even sizes: k 4-5 at s 2 (pix2pix,
    ACGAN) and the other branches of the padding rule (crop, output_padding)."""
    y = _parity(jlayers.ConvTranspose(4, k, strides=stride),
                tlayers.ConvTranspose(3, 4, k, stride), _img((2, 5, 4, 3)))
    assert y.shape[1:3] == (5 * stride, 4 * stride)


def test_conv_transpose_k5_s2_pads_three_before_two_after():
    """The trap: XLA pads the dilated input (3, 2) at k 5, s 2;
    ``conv_transpose2d(padding=2, output_padding=1)`` pads (2, 3) and is off,
    the port's padding 1 cropped to 2H x 2W is right."""
    assert tfused.transpose_same_pads(5, 2) == (3, 2)
    assert tfused.transpose_same_pads(4, 2) == (2, 2)
    x = _img((1, 8, 8, 6), seed=4)
    w = _img((5, 5, 6, 3), seed=5)  # HWIO
    ref = np.asarray(jax.lax.conv_transpose(x, w, (2, 2), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC")))
    w_oihw = torch.tensor(w).permute(3, 2, 0, 1)
    with torch.no_grad():
        y = _nhwc(tfused.conv_transpose_same(_nchw(x), w_oihw, 2))
        wrong = _nhwc(F.conv_transpose2d(_nchw(x), w_oihw.flip(2, 3).transpose(0, 1),
                                         stride=2, padding=2, output_padding=1))
    _close(y, ref)
    assert y.shape == wrong.shape and np.abs(wrong - ref).max() > 1.0


@pytest.mark.parametrize("k", [1, 3])
def test_fused_up_conv_unchanged(k):
    """The fused up-conv through the shared rule is bit-identical to its
    former own padding (``(k + 1) - 1 - pad_a`` with pad_a 2 for 4x4, 1 for
    2x2)."""
    x = torch.tensor(_img((2, 4, 6, 5), seed=6)).permute(0, 3, 1, 2)
    w = torch.tensor(_img((7, 5, k, k), seed=7))
    K = tfused.fuse_up2_kernel(w)
    kk = K.shape[-1]
    pad_a = -(-kk // 2) if 2 <= kk - 1 else kk - 1
    before = F.conv_transpose2d(x, K.flip(2, 3).transpose(0, 1), stride=2,
                                padding=kk - 1 - pad_a)
    assert torch.equal(tfused.upsample2x_conv(x, w), before)


def test_conv_transpose_weight_is_oihw_through_the_converter():
    """The reference's HWIO deconv kernel lands OIHW by the converter's one
    rule: weight[o, i, y, x] == kernel[y, x, i, o]."""
    jmod = jlayers.ConvTranspose(6, 5, strides=2)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, 4, 2)))
    kernel = np.asarray(variables["params"]["kernel"])
    assert kernel.shape == (5, 5, 2, 6)
    t = tlayers.ConvTranspose(2, 6, 5, 2)
    t.load_state_dict({k: torch.tensor(v) for k, v in
                       to_torch_names(variables["params"]).items()}, strict=True)
    assert tuple(t.weight.shape) == (6, 2, 5, 5)
    np.testing.assert_array_equal(t.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))


class _DropoutNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dropout(0.3, deterministic=False)(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_flax_given_its_mask(dtype):
    """flax's Dropout output, its keep mask read back as ``out != 0``, and
    the port's ``dropout`` with that mask: equal, in float32 and bf16 (both
    divide by keep = 0.7 in the activation's dtype)."""
    x = (np.abs(_img((4, 6, 6, 8), seed=8)) + 0.1).astype(np.float32)
    xj = jnp.asarray(x, dtype=dtype)
    out = _DropoutNet().apply({}, xj, rngs={"dropout": jax.random.PRNGKey(9)})
    mask = np.asarray(out != 0)
    assert 0.6 < mask.mean() < 0.8
    xt = torch.tensor(x).to(getattr(torch, dtype))
    y = tlayers.dropout(xt, 0.3, torch.tensor(mask))
    assert y.dtype == xt.dtype
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
