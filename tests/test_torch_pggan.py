"""PGGAN pieces of the port against the JAX package's, forward and gradient:
the equalized-LR layers, ``pixel_norm``, ``minibatch_stddev``, G and D with
and without the fade-in at alpha 0, 0.37 and 1 and with the fused_scale D
blocks on and off (mirroring tests/test_models.py:69-110), and
``migrate_params``. Small widths (``width_mul`` 1/32, ``z_dim`` 16,
resolutions 8 and 16), the JAX init's weights carried over by
``convert.py``.

float32 on the CPU on both sides (JAX at highest matmul precision, see
conftest). Tolerance rtol 1e-4 / atol 1e-5 for single ops (summation order
only) and rtol 1e-4 / atol 1e-4 for whole networks, whose outputs are sums
over a dozen stacked convs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.models import pggan as jpggan
from gan_lib_tensorflow_tpu.ops import initializers as jinit
from gan_lib_tensorflow_tpu.ops import layers as jlayers
from gan_lib_tensorflow_tpu.ops import norms as jnorms
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.models import pggan as tpggan
from gan_lib_tensorflow_tpu_torch.ops import initializers as tinit
from gan_lib_tensorflow_tpu_torch.ops import layers as tlayers
from gan_lib_tensorflow_tpu_torch.ops import norms as tnorms

WM, Z = 1 / 32, 16

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(module, params):
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            to_torch_names(params).items()}, strict=True)


# --- layers and norms ---------------------------------------------------------

_LAYERS = {
    "dense": (lambda: jlayers.Dense(7, equalized=True),
              lambda: tlayers.Dense(9, 7, equalized=True), (4, 9)),
    "dense_gain1": (lambda: jlayers.Dense(1, equalized=True, gain=1.0),
                    lambda: tlayers.Dense(9, 1, equalized=True, gain=1.0), (4, 9)),
    "conv3": (lambda: jlayers.Conv(6, 3, equalized=True),
              lambda: tlayers.Conv(5, 6, 3, equalized=True), (2, 8, 8, 5)),
    "torgb": (lambda: jlayers.Conv(3, 1, equalized=True, gain=1.0),
              lambda: tlayers.Conv(5, 3, 1, equalized=True, gain=1.0), (2, 8, 8, 5)),
    "upsample_conv": (lambda: jlayers.UpsampleConv(6, 3, equalized=True),
                      lambda: tlayers.UpsampleConv(5, 6, 3, equalized=True), (2, 4, 6, 5)),
    "downsample_conv": (lambda: jlayers.DownsampleConv(6, 3, equalized=True),
                        lambda: tlayers.DownsampleConv(5, 6, 3, equalized=True),
                        (2, 8, 6, 5)),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_equalized_layer_parity(name):
    """Forward and gradients (input and params) of sum(y * r)."""
    jmake, tmake, shape = _LAYERS[name]
    jmod, tmod = jmake(), tmake()
    nchw = len(shape) == 4
    x = _img(shape)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    _load(tmod, params)
    y_j = jmod.apply({"params": params}, jnp.asarray(x))
    r = _img(y_j.shape, 1)
    gp_j, gx_j = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * r),
                          argnums=(0, 1))(params, jnp.asarray(x))
    xt = (_nchw(x) if nchw else torch.tensor(x)).requires_grad_(True)
    y_t = tmod(xt)
    _close(_nhwc(y_t) if nchw else y_t.detach().numpy(), y_j)
    (y_t * (_nchw(r) if nchw else torch.tensor(r))).sum().backward()
    _close(_nhwc(xt.grad) if nchw else xt.grad.numpy(), gx_j)
    ref = to_torch_names(gp_j)
    for n, p in tmod.named_parameters():
        _close(p.grad.numpy(), ref[n])


@pytest.mark.parametrize("cls,args,fan_in", [
    (tlayers.Conv, (5, 6, 3), 45),
    (tlayers.UpsampleConv, (5, 6, 3), 45),   # the logical 3x3, not the fused 4x4
    (tlayers.DownsampleConv, (5, 6, 3), 45),
    (tlayers.Dense, (9, 7), 9),
])
def test_he_scale_uses_the_logical_fan_in(cls, args, fan_in):
    layer = cls(*args, equalized=True)
    assert layer.scale == tinit.he_scale(fan_in) == pytest.approx(np.sqrt(2 / fan_in))
    jshape = (3, 3, 5, 6) if len(args) == 3 else (9, 7)
    assert layer.scale == jinit.he_scale(jshape)


def test_equalized_init_is_unit_normal():
    layer = tlayers.Conv(64, 64, 3, equalized=True)
    tlayers.init_weights(layer, torch.Generator().manual_seed(0))
    w = layer.weight.detach()
    assert abs(float(w.std()) - 1.0) < 0.02 and abs(float(w.mean())) < 0.02
    assert float(layer.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel_norm_parity(dtype):
    x = _img((3, 5, 4, 7)) * 3
    ref = jnorms.pixel_norm(jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                                        else jnp.float32))
    got = tnorms.pixel_norm(_nchw(x).to(dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close(_nhwc(got.float()), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    # [N, F] latents normalize over F, as the reference's z[:, None, None, :]
    z = _img((4, 16), 2)
    _close(tnorms.pixel_norm(torch.tensor(z)).numpy(),
           np.asarray(jnorms.pixel_norm(jnp.asarray(z)[:, None, None, :]))[:, 0, 0])


@pytest.mark.parametrize("n,group", [(8, 4), (4, 4), (2, 4), (6, 3)])
def test_minibatch_stddev_parity(n, group):
    """Output (the extra channel last) and input gradient."""
    x = _img((n, 4, 4, 5)) * 2 + 1
    r = _img((n, 4, 4, 6), 1)
    y_j, gx_j = jax.value_and_grad(
        lambda xx: jnp.sum(jnorms.minibatch_stddev(xx, group) * r))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    y_t = tnorms.minibatch_stddev(xt, group)
    assert y_t.shape == (n, 6, 4, 4)
    _close(_nhwc(y_t), jnorms.minibatch_stddev(jnp.asarray(x), group))
    (y_t * _nchw(r)).sum().backward()
    _close(_nhwc(xt.grad), gx_j)


def test_minibatch_stddev_rejects_ragged_groups():
    with pytest.raises(ValueError):
        tnorms.minibatch_stddev(torch.zeros(6, 2, 4, 4), 4)


# --- networks -------------------------------------------------------------------

def _g_pair(res, fade):
    jg = jpggan.PGGANGenerator(resolution=res, fade_in=fade, z_dim=Z, width_mul=WM)
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((2, Z)), 1.0)["params"]
    tg = tpggan.PGGANGenerator(resolution=res, fade_in=fade, z_dim=Z, width_mul=WM)
    _load(tg, params)
    return jg, tg, params


def _d_pair(res, fade, fused_from):
    jd = jpggan.PGGANDiscriminator(resolution=res, fade_in=fade, width_mul=WM,
                                   fused_from=fused_from)
    params = jd.init(jax.random.PRNGKey(1), jnp.zeros((4, res, res, 3)), 1.0)["params"]
    td = tpggan.PGGANDiscriminator(resolution=res, fade_in=fade, width_mul=WM,
                                   fused_from=fused_from)
    _load(td, params)
    return jd, td, params


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("res,fade", [(8, False), (8, True), (16, True)])
def test_generator_parity(res, fade, alpha):
    jg, tg, params = _g_pair(res, fade)
    z = _img((4, Z), 3)
    y_j = jg.apply({"params": params}, jnp.asarray(z), alpha)
    y_t = tg(torch.tensor(z), alpha)
    assert y_t.shape == (4, res, res, 3) and y_t.dtype == torch.float32
    _close(y_t.detach().numpy(), y_j, atol=1e-4)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("res,fade,fused_from", [
    (8, False, 0), (8, True, 0), (16, True, 0), (16, True, 8), (16, False, 16)])
def test_discriminator_parity(res, fade, fused_from, alpha):
    jd, td, params = _d_pair(res, fade, fused_from)
    x = np.tanh(_img((4, res, res, 3), 4))
    l_j = jd.apply({"params": params}, jnp.asarray(x), alpha)
    l_t = td(torch.tensor(x), alpha)
    assert l_t.shape == (4, 1) and l_t.dtype == torch.float32
    _close(l_t.detach().numpy(), l_j, atol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_fade_in_gradients(net):
    """Parameter gradients through both fade-in paths at alpha 0.37 (16x16,
    fused D blocks), against jax.grad."""
    alpha = 0.37
    if net == "g":
        jm, tm, params = _g_pair(16, True)
        inp = _img((4, Z), 5)
    else:
        jm, tm, params = _d_pair(16, True, 8)
        inp = np.tanh(_img((4, 16, 16, 3), 5))
    out = jm.apply({"params": params}, jnp.asarray(inp), alpha)
    r = _img(out.shape, 6)
    g_j = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(inp), alpha)
                                     * r))(params)
    (tm(torch.tensor(inp), alpha) * torch.tensor(r)).sum().backward()
    ref = to_torch_names(g_j)
    assert set(ref) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), ref[n], atol=1e-4)


def test_module_names_are_the_flax_names():
    _, tg, gp = _g_pair(16, True)
    _, td, dp = _d_pair(16, True, 0)
    assert {n for n, _ in tg.named_parameters()} == set(to_torch_names(gp))
    assert {n for n, _ in td.named_parameters()} == set(to_torch_names(dp))
    assert "torgb_8.weight" in dict(tg.named_parameters())
    assert "fromrgb_8.weight" in dict(td.named_parameters())


@pytest.mark.parametrize("net", ["g", "d"])
def test_migrate_params_copies_what_jax_copies(net):
    """Stage 8 stabilize -> 16 transition: the same count as the reference's
    migrate_params, and the trunk carried bit-exact."""
    if net == "g":
        j_old, t_old, p_old = _g_pair(8, False)
        j_new, t_new, p_new = _g_pair(16, True)
    else:
        j_old, t_old, p_old = _d_pair(8, False, 0)
        j_new, t_new, p_new = _d_pair(16, True, 0)
    _, j_copied = jpggan.migrate_params(p_old, p_new)
    t_copied = tpggan.migrate_params(dict(t_old.named_parameters()),
                                     dict(t_new.named_parameters()))
    assert t_copied == j_copied >= 4
    new = dict(t_new.named_parameters())
    for n, p in t_old.named_parameters():
        if n in new and new[n].shape == p.shape:
            assert torch.equal(new[n], p), n


def test_sampler_uses_ema_and_alpha():
    from types import SimpleNamespace
    _, tg, _ = _g_pair(8, True)
    z = torch.tensor(_img((2, Z), 7))
    ema = {n: p.detach() * 0.5 for n, p in tg.named_parameters()}
    sample = tpggan.make_sampler(tg)
    got = sample(SimpleNamespace(ema_params=ema, alpha=0.25), z)
    from torch.func import functional_call
    torch.testing.assert_close(got, functional_call(tg, ema, (z, 0.25)))
    torch.testing.assert_close(sample(SimpleNamespace(ema_params=None, alpha=0.25), z),
                               tg(z, 0.25).detach())
