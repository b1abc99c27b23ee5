"""The port's space-to-depth rewrites (``ops/s2d.py``) and the PGGAN levels
built on them (``s2d_from``) against the JAX package's, case for case with
``tests/test_s2d.py``: the round trip and the phase-major layout, the three
kernel transforms (k 1, 3, 5 for the stride-1 one), conv gradients,
``pixel_norm_s2d``, and G and D with ``s2d_from`` against the port's
composed / ``fused_from`` networks and against the JAX package's, from the
JAX init's weights carried over by ``convert.py``, with the fade-in and
with gradients.

float32 on the CPU on both sides. The reference's own tolerances: layouts
bit for bit; the transforms' convolutions atol 2e-5 / rtol 1e-5 (the
scattered kernel sums its taps in another order); conv gradients atol 5e-4
/ rtol 1e-4; ``pixel_norm_s2d`` atol 1e-6; G atol 2e-5 / rtol 1e-5 and its
parameter gradients atol 5e-5 / rtol 5e-4; D atol 5e-5 / rtol 1e-4 and its
parameter gradients atol 1e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_lib_tensorflow_tpu.models import pggan as jpggan
from gan_lib_tensorflow_tpu.ops import downsample_avg as jdown
from gan_lib_tensorflow_tpu.ops import pixel_norm as jpixel_norm
from gan_lib_tensorflow_tpu.ops import s2d as js2d
from gan_lib_tensorflow_tpu.ops import upsample_nearest as jup
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.models import pggan as tpggan
from gan_lib_tensorflow_tpu_torch.ops import downsample_avg, pixel_norm, s2d, upsample_nearest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RES, WM, Z = 32, 1 / 32, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w):
    return torch.tensor(w).permute(3, 2, 0, 1)


def _jconv(x, w):
    return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _tconv(x, w):
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def test_s2d_roundtrip_and_phase_major_layout():
    x = _rand((2, 8, 6, 5), 0)
    y = s2d.space_to_depth(_nchw(x))
    assert tuple(y.shape) == (2, 20, 4, 3)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(s2d.depth_to_space(y)), x)
    # channel (py*2 + px)*C + c holds pixel (2i + py, 2j + px) of channel c;
    # pixel_unshuffle would put it at c*4 + py*2 + px
    assert y[0, 3 * 5 + 2, 1, 1] == x[0, 3, 3, 2]
    assert not torch.equal(y, F.pixel_unshuffle(_nchw(x), 2))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_s2d_conv_kernel_exact(k):
    x, w = _rand((2, 12, 8, 6), k), _rand((k, k, 6, 10), 10 + k)
    want = js2d.space_to_depth(_jconv(jnp.asarray(x), jnp.asarray(w)))
    kernel = s2d.s2d_conv_kernel(_oihw(w))
    got = s2d.conv_same(s2d.space_to_depth(_nchw(x)), kernel)
    _close(_nhwc(got), want, 2e-5, 1e-5)
    _close(kernel.permute(2, 3, 1, 0).numpy(), js2d.s2d_conv_kernel(jnp.asarray(w)), 1e-6, 0)
    # and against the port's own composed conv
    _close(_nhwc(got), _nhwc(s2d.space_to_depth(_tconv(_nchw(x), _oihw(w)))), 2e-5, 1e-5)


def test_s2d_upconv_kernel_exact():
    x, w = _rand((2, 6, 5, 4), 7), _rand((3, 3, 4, 9), 8)
    want = js2d.space_to_depth(_jconv(jup(jnp.asarray(x)), jnp.asarray(w)))
    kernel = s2d.s2d_upconv_kernel(_oihw(w))
    got = s2d.conv_same(_nchw(x), kernel)
    _close(_nhwc(got), want, 2e-5, 1e-5)
    _close(kernel.permute(2, 3, 1, 0).numpy(), js2d.s2d_upconv_kernel(jnp.asarray(w)),
           2e-6, 1e-6)
    composed = s2d.space_to_depth(_tconv(upsample_nearest(_nchw(x)), _oihw(w)))
    _close(_nhwc(got), _nhwc(composed), 2e-5, 1e-5)


def test_s2d_downconv_kernel_exact():
    x, w = _rand((2, 12, 10, 6), 11), _rand((3, 3, 6, 8), 12)
    want = jdown(_jconv(jnp.asarray(x), jnp.asarray(w)))
    kernel = s2d.s2d_downconv_kernel(_oihw(w))
    got = s2d.conv_same(s2d.space_to_depth(_nchw(x)), kernel)
    _close(_nhwc(got), want, 2e-5, 1e-5)
    _close(kernel.permute(2, 3, 1, 0).numpy(), js2d.s2d_downconv_kernel(jnp.asarray(w)),
           2e-6, 1e-6)
    _close(_nhwc(got), _nhwc(downsample_avg(_tconv(_nchw(x), _oihw(w)))), 2e-5, 1e-5)


def test_s2d_conv_gradients_exact():
    x, w = _rand((1, 8, 8, 4), 3), _rand((3, 3, 4, 4), 4)

    def f_ref(w):
        return (js2d.space_to_depth(_jconv(jnp.asarray(x), w)) ** 2).sum()

    want = jax.grad(f_ref)(jnp.asarray(w))
    wt = _oihw(w).clone().requires_grad_(True)
    (s2d.conv_same(s2d.space_to_depth(_nchw(x)), s2d.s2d_conv_kernel(wt)) ** 2).sum().backward()
    _close(wt.grad.permute(2, 3, 1, 0).numpy(), want, 5e-4, 1e-4)


def test_kernels_are_built_once_per_shape_and_stay_linear():
    """One cached scatter tensor per (k, variant, dtype, device); a kernel is
    linear in the weight, so a double backward goes through it."""
    s2d._scatter.cache_clear()
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    for _ in range(3):
        s2d.s2d_conv_kernel(w), s2d.s2d_upconv_kernel(w), s2d.s2d_downconv_kernel(w)
    assert s2d._scatter.cache_info().currsize == 3
    x = torch.randn(2, 12, 6, 6, requires_grad=True)
    y = s2d.conv_same(x, s2d.s2d_conv_kernel(w))
    (gx,) = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
    (gw,) = torch.autograd.grad((gx ** 2).sum(), w)
    assert gw.shape == w.shape and bool(torch.isfinite(gw).all()) and gw.abs().sum() > 0


def test_pixel_norm_s2d_matches():
    x = _rand((2, 8, 8, 6), 5)
    got = s2d.pixel_norm_s2d(s2d.space_to_depth(_nchw(x)))
    _close(_nhwc(got), js2d.space_to_depth(jpixel_norm(jnp.asarray(x))), 1e-6, 0)
    _close(_nhwc(got), _nhwc(s2d.space_to_depth(pixel_norm(_nchw(x)))), 1e-6, 0)


def _load(module, params):
    module.load_state_dict({k: torch.tensor(v) for k, v in to_torch_names(params).items()},
                           strict=True)


@pytest.mark.parametrize("fade", [False, True], ids=["stable", "fade_in"])
def test_pggan_generator_s2d_matches_composed_and_jax(fade):
    """G with ``s2d_from`` 16 (the 16 and 32 levels on the S2D grid, the
    fade-in's level below too) is the composed port's and both JAX G's
    function with the same parameters, forward and parameter gradients."""
    alpha = 0.5 if fade else 1.0
    jg0 = jpggan.PGGANGenerator(resolution=RES, width_mul=WM, z_dim=Z, fade_in=fade)
    jg1 = jpggan.PGGANGenerator(resolution=RES, width_mul=WM, z_dim=Z, fade_in=fade,
                                s2d_from=16)
    z = _rand((3, Z), 1)
    params = jg0.init(jax.random.PRNGKey(2), jnp.asarray(z), alpha)["params"]
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        jg1.init(jax.random.PRNGKey(2), jnp.asarray(z), alpha)["params"]))
    tg0 = tpggan.PGGANGenerator(resolution=RES, width_mul=WM, z_dim=Z, fade_in=fade)
    tg1 = tpggan.PGGANGenerator(resolution=RES, width_mul=WM, z_dim=Z, fade_in=fade,
                                s2d_from=16)
    _load(tg0, params)
    _load(tg1, params)  # the same names and shapes: strict load
    assert [type(m).__name__ for n, m in tg1.named_children() if n.startswith("block")] == [
        "_GenBlock", "_GenBlockS2D", "_GenBlockS2D"]
    y1 = tg1(torch.tensor(z), alpha)
    _close(y1.detach().numpy(), tg0(torch.tensor(z), alpha).detach().numpy(), 2e-5, 1e-5)
    _close(y1.detach().numpy(), jg1.apply({"params": params}, jnp.asarray(z), alpha), 2e-5, 1e-5)
    _close(y1.detach().numpy(), jg0.apply({"params": params}, jnp.asarray(z), alpha), 2e-5, 1e-5)

    want = to_torch_names(jax.grad(lambda p: (jg0.apply({"params": p}, jnp.asarray(z), alpha)
                                              ** 2).mean())(params))
    (tg1(torch.tensor(z), alpha) ** 2).mean().backward()
    assert set(want) == {n for n, _ in tg1.named_parameters()}
    for n, p in tg1.named_parameters():
        _close(p.grad.numpy(), want[n], 5e-5, 5e-4)


@pytest.mark.parametrize("fade", [False, True], ids=["stable", "fade_in"])
def test_pggan_discriminator_s2d_matches_fused_and_jax(fade):
    """D with ``s2d_from`` 16 implies the fused_scale order: it is the
    port's and JAX's ``fused_from`` 16 D, and JAX's ``s2d_from`` 16 D, with
    the same parameters, forward and parameter gradients."""
    alpha = 0.5 if fade else 1.0
    kw = dict(resolution=RES, width_mul=WM, mbstd_group_size=2, fade_in=fade)
    jd0 = jpggan.PGGANDiscriminator(fused_from=16, **kw)
    jd1 = jpggan.PGGANDiscriminator(s2d_from=16, **kw)
    x = np.tanh(_rand((4, RES, RES, 3), 4))
    params = jd0.init(jax.random.PRNGKey(5), jnp.asarray(x), alpha)["params"]
    td0 = tpggan.PGGANDiscriminator(fused_from=16, **kw)
    td1 = tpggan.PGGANDiscriminator(s2d_from=16, **kw)
    _load(td0, params)
    _load(td1, params)
    assert [type(m).__name__ for n, m in td1.named_children() if n.startswith("block")] == [
        "_DiscBlockS2D", "_DiscBlockS2D", "_DiscBlock"]
    l1 = td1(torch.tensor(x), alpha).detach().numpy()
    _close(l1, td0(torch.tensor(x), alpha).detach().numpy(), 5e-5, 1e-4)
    _close(l1, jd1.apply({"params": params}, jnp.asarray(x), alpha), 5e-5, 1e-4)
    _close(l1, jd0.apply({"params": params}, jnp.asarray(x), alpha), 5e-5, 1e-4)

    want = to_torch_names(jax.grad(lambda p: (jd0.apply({"params": p}, jnp.asarray(x), alpha)
                                              ** 2).mean())(params))
    (td1(torch.tensor(x), alpha) ** 2).mean().backward()
    for n, p in td1.named_parameters():
        _close(p.grad.numpy(), want[n], 1e-4, 1e-3)
