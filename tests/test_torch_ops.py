"""Parity of the port's ops with the JAX package's, forward and gradient.

Same numpy inputs go through both; the port's weights are the JAX init's,
carried over by ``convert.to_torch_names``. Everything is float32 on the CPU
(JAX at highest matmul precision, see conftest), so the tolerance is
rtol 1e-4 / atol 1e-5: summation order is the only difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu import losses as jlosses
from gan_lib_tensorflow_tpu.ops import fused as jfused
from gan_lib_tensorflow_tpu.ops import layers as jlayers
from gan_lib_tensorflow_tpu.ops import norms as jnorms
from gan_lib_tensorflow_tpu_torch import losses as tlosses
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.ops import fused as tfused
from gan_lib_tensorflow_tpu_torch.ops import initializers as tinit
from gan_lib_tensorflow_tpu_torch.ops import layers as tlayers
from gan_lib_tensorflow_tpu_torch.ops import norms as tnorms

RTOL, ATOL = 1e-4, 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(module: torch.nn.Module, variables) -> None:
    tensors = to_torch_names(variables["params"])
    for coll, tree in variables.items():
        if coll != "params":
            tensors.update(to_torch_names(tree))
    module.load_state_dict({k: torch.tensor(v) for k, v in tensors.items()},
                           strict=True)


def _layer_parity(jmod, tmod, x, nchw=True, update_sn=False):
    """Forward of both, then grads of sum(y * r) wrt input and params."""
    rng = np.random.default_rng(1)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _load(tmod, variables)
    kw = {"update_sn": True} if update_sn else {}
    mutable = ["sn"] if update_sn else False
    y_j = jmod.apply(variables, jnp.asarray(x), mutable=mutable, **kw)
    new_sn = None
    if update_sn:
        y_j, new_sn = y_j
    r = rng.standard_normal(y_j.shape).astype(np.float32)

    def loss_j(params, xx):
        out = jmod.apply({**variables, "params": params}, xx, mutable=mutable, **kw)
        out = out[0] if update_sn else out
        return jnp.sum(out * r)

    gp_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(variables["params"], jnp.asarray(x))

    xt = (_nchw(x) if nchw else torch.tensor(x)).requires_grad_(True)
    y_t = tmod(xt, update_sn=True) if update_sn else tmod(xt)
    y_np = _nhwc(y_t) if nchw else y_t.detach().numpy()
    _close(y_np, y_j)
    rt = _nchw(r) if nchw else torch.tensor(r)
    (y_t * rt).sum().backward()
    _close(_nhwc(xt.grad) if nchw else xt.grad.numpy(), gx_j)
    gp_ref = to_torch_names(gp_j)
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), gp_ref[name])
    if update_sn:
        _close(tmod.u.numpy(), new_sn["sn"]["u"])
    return variables


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("k", [3, 1])
def test_conv_parity(sn, k):
    _layer_parity(jlayers.Conv(6, k, spectral_norm=sn),
                  tlayers.Conv(5, 6, k, spectral_norm=sn),
                  _img((2, 8, 8, 5)), update_sn=sn)


@pytest.mark.parametrize("sn", [False, True])
def test_dense_parity(sn):
    _layer_parity(jlayers.Dense(7, spectral_norm=sn),
                  tlayers.Dense(9, 7, spectral_norm=sn),
                  _img((4, 9)), nchw=False, update_sn=sn)


def test_sn_u_does_not_advance_without_update():
    variables = jlayers.Conv(6, 3, spectral_norm=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 5)))
    t = tlayers.Conv(5, 6, 3, spectral_norm=True)
    _load(t, variables)
    u0 = t.u.clone()
    t(_nchw(_img((1, 4, 4, 5))))
    assert torch.equal(t.u, u0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("k", [3, 1])
def test_upsample_conv_parity(fused, k):
    _layer_parity(jlayers.UpsampleConv(6, k, fused=fused),
                  tlayers.UpsampleConv(5, 6, k, fused=fused), _img((2, 5, 7, 5)))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sn", [False, True])
def test_downsample_conv_parity(fused, sn):
    _layer_parity(jlayers.DownsampleConv(6, 3, spectral_norm=sn, fused=fused),
                  tlayers.DownsampleConv(5, 6, 3, spectral_norm=sn, fused=fused),
                  _img((2, 8, 6, 5)), update_sn=sn)


@pytest.mark.parametrize("k", [3, 1])
def test_upsample2x_conv_and_conv_downscale2x(k):
    """The free functions, forward and gradient, against the JAX ones."""
    x = _img((2, 6, 4, 3))
    w = _img((k, k, 3, 5), seed=2)  # HWIO
    w_t = torch.tensor(w).permute(3, 2, 0, 1).contiguous()
    for jfn, tfn in ((jfused.upsample2x_conv, tfused.upsample2x_conv),
                     (jfused.conv_downscale2x, tfused.conv_downscale2x)):
        y_j = jfn(jnp.asarray(x), jnp.asarray(w))
        r = _img(y_j.shape, seed=3)
        gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * r),
                              argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt = _nchw(x).requires_grad_(True)
        wt = w_t.clone().requires_grad_(True)
        y_t = tfn(xt, wt)
        _close(_nhwc(y_t), y_j)
        (y_t * _nchw(r)).sum().backward()
        _close(_nhwc(xt.grad), gx_j)
        _close(wt.grad.permute(2, 3, 1, 0).numpy(), gw_j)


def test_resize_helpers():
    x = _img((2, 6, 4, 3))
    _close(_nhwc(tlayers.upsample_nearest(_nchw(x))), jlayers.upsample_nearest(jnp.asarray(x)))
    _close(_nhwc(tlayers.downsample_avg(_nchw(x))), jlayers.downsample_avg(jnp.asarray(x)))
    _close(tlayers.global_sum_pool(_nchw(x)).numpy(), jlayers.global_sum_pool(jnp.asarray(x)))


@pytest.mark.parametrize("groups", [1, 2])
def test_batchnorm_parity(groups):
    """Training-mode output and gradients (per-microbatch statistics when
    groups > 1, like the reference's vmap), running stats, then eval."""
    x = _img((4, 5, 3, 6)) * 3 + 1
    jbn = jnorms.BatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                         use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(_img((6,), 4)),
                            "bias": jnp.asarray(_img((6,), 5))},
                 "batch_stats": variables["batch_stats"]}
    xs = x.reshape(groups, 4 // groups, *x.shape[1:])

    def fwd(params, xx):
        return jax.vmap(lambda xi: jbn.apply(
            {**variables, "params": params}, xi, use_running_average=False,
            mutable=["batch_stats"]))(xx)

    (y_j, new_stats) = fwd(variables["params"], jnp.asarray(xs))
    r = _img(y_j.shape, 6)
    gp_j, gx_j = jax.grad(lambda p, xx: jnp.sum(fwd(p, xx)[0] * r),
                          argnums=(0, 1))(variables["params"], jnp.asarray(xs))

    tbn = tnorms.BatchNorm(6)
    _load(tbn, variables)
    xt = _nchw(x).requires_grad_(True)
    y_t = tbn(xt, groups=groups, update_stats=groups == 1)
    _close(_nhwc(y_t), np.asarray(y_j).reshape(x.shape))
    (y_t * _nchw(np.asarray(r).reshape(x.shape))).sum().backward()
    _close(_nhwc(xt.grad), np.asarray(gx_j).reshape(x.shape))
    _close(tbn.weight.grad.numpy(), gp_j["scale"])
    _close(tbn.bias.grad.numpy(), gp_j["bias"])
    if groups == 1:
        _close(tbn.running_mean.numpy(), new_stats["batch_stats"]["mean"][0])
        _close(tbn.running_var.numpy(), new_stats["batch_stats"]["var"][0])
        y_ej = jbn.apply({**variables, **new_stats_unbatched(new_stats)},
                         jnp.asarray(x), use_running_average=True)
        _close(_nhwc(tbn(_nchw(x), use_running_average=True)), y_ej)
    else:
        assert torch.equal(tbn.running_mean, torch.zeros(6))


def new_stats_unbatched(new_stats):
    return {"batch_stats": jax.tree_util.tree_map(lambda a: a[0],
                                                  new_stats["batch_stats"])}


def test_batchnorm_casts_to_compute_dtype():
    bn = tnorms.BatchNorm(3, compute_dtype=torch.bfloat16)
    assert bn(_nchw(_img((2, 4, 4, 3)))).dtype == torch.bfloat16


def test_he_normal_distribution():
    """Truncated at 2 std of the untruncated draw, variance 2 / fan_in,
    like flax's variance_scaling(2, fan_in, truncated_normal)."""
    fan_in = 1152
    w_t = torch.empty(200_000)
    tinit.he_normal_(w_t, fan_in, torch.Generator().manual_seed(0))
    w_j = np.asarray(jax.nn.initializers.variance_scaling(
        2.0, "fan_in", "truncated_normal")(jax.random.PRNGKey(0), (fan_in, 200_000 // fan_in)))
    target = np.sqrt(2.0 / fan_in)
    for w in (w_t.numpy(), w_j):
        assert abs(w.std() / target - 1) < 0.01
    assert abs(np.abs(w_t.numpy()).max() - np.abs(w_j).max()) < 0.02 * target * 2


@pytest.mark.parametrize("name", ["hinge_d_loss", "wgan_d_loss", "bce_d_loss", "l1_loss"])
def test_two_arg_losses(name):
    a, b = _img((8, 1), 7) * 2, _img((8, 1), 8) * 2
    _close(getattr(tlosses, name)(torch.tensor(a), torch.tensor(b)),
           getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)), atol=1e-6)


@pytest.mark.parametrize("name", ["hinge_g_loss", "wgan_g_loss", "bce_g_loss"])
def test_one_arg_losses(name):
    a = _img((8, 1), 9) * 2
    _close(getattr(tlosses, name)(torch.tensor(a)),
           getattr(jlosses, name)(jnp.asarray(a)), atol=1e-6)


def test_acgan_aux_loss():
    logits = _img((6, 10), 10) * 3
    labels = np.random.default_rng(11).integers(0, 10, 6).astype(np.int32)
    _close(tlosses.acgan_aux_loss(torch.tensor(logits), torch.tensor(labels)),
           jlosses.acgan_aux_loss(jnp.asarray(logits), jnp.asarray(labels)), atol=1e-6)
