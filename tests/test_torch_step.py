"""One full fused SNGAN step of the port against the JAX package's, float32,
at small widths (G (32, 32, 32), D (32, 32, 32, 32), batch 4, n_critic 2,
EMA 0.9999), starting from the same converted state.

Torch cannot draw JAX's threefry numbers, so the test replays the step's key
schedule with ``jax.random`` (``train/step.py:81-106``, ``models/sngan.py:
168-172, 214-217``) and hands the port the same z.

Tolerances. Losses, u, BN stats and the Adam slots follow the gradients
smoothly: rtol 1e-3 / atol 1e-5 (float32, two critic updates of summation
order noise). With b1 = 0 Adam's first update is lr * g / (|g| + eps), about
lr * sign(g), so a gradient element near 0 can take the opposite sign in the
two packages and its parameter then differs by up to 2 * lr per update. The
parameter check therefore allows 2 * lr * (updates) on any element, and
1e-6 on all but a handful.

In G every conv bias inside a block feeds a BatchNorm, which removes it: its
gradient is 0 in exact arithmetic and rounding noise in both packages. Those
slots are held to atol 1e-4 of the net's largest slot entry, and their
parameters (which move by lr * sign(noise)) only to the 2 * lr bound.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import sngan as jsngan
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.models import sngan as tsngan
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR, N_CRITIC, B, Z = 2e-4, 2, 4, 128
G_CH, D_CH = (32, 32, 32), (32, 32, 32, 32)


def _jax_draws(rng):
    """The z of the critic fakes and of the G update for one step."""
    prep = jax.random.fold_in(rng, 1)
    z_c = [jax.random.normal(jax.random.split(r)[0], (B, Z))
           for r in jax.random.split(prep, N_CRITIC)]
    r = rng
    for _ in range(N_CRITIC):
        r, _ = jax.random.split(r)
    _, sub, _ = jax.random.split(r, 3)
    z_g = jax.random.normal(jax.random.split(sub)[0], (B, Z))
    return np.stack([np.asarray(z) for z in z_c]), np.asarray(z_g)


@pytest.fixture(scope="module")
def stepped():
    jg = jsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    jd = jsngan.ResNetDiscriminator(channels=D_CH)
    spec = jsngan.make_sngan_spec(jg, jd, n_critic=N_CRITIC, ema_decay=0.9999)
    g_opt = optax.adam(LR, b1=0.0, b2=0.9)
    d_opt = optax.adam(LR, b1=0.0, b2=0.9)
    state0 = jtrain.create_state(
        jax.random.PRNGKey(0),
        lambda r: jg.init(r, jnp.zeros((2, Z)), train=False),
        lambda r: jd.init(r, jnp.zeros((2, 32, 32, 3))),
        g_opt, d_opt, ema_decay=0.9999)
    images = np.tanh(np.random.default_rng(0).standard_normal(
        (N_CRITIC, B, 32, 32, 3))).astype(np.float32)
    z_c, z_g = _jax_draws(state0.rng)

    tg = tsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    td = tsngan.ResNetDiscriminator(channels=D_CH)
    tspec = tsngan.make_sngan_spec(tg, td, n_critic=N_CRITIC, ema_decay=0.9999)
    tstate = create_state(tg, td, lr=LR, ema_decay=0.9999, device="cpu")
    convert.load_jax_state(tstate, jax.tree_util.tree_map(np.asarray, state0))

    state1, jmetrics = jax.jit(jtrain.make_train_step(spec, g_opt, d_opt))(
        state0, {"image": jnp.asarray(images)})
    tmetrics = make_train_step(tspec)(
        tstate, {"image": torch.tensor(images)},
        z_critic=torch.tensor(z_c), z_g=torch.tensor(z_g))
    return jax.tree_util.tree_map(np.asarray, state1), jmetrics, tstate, tmetrics


_BN_CANCELLED = re.compile(r"block\d+\.conv(1|2|_skip)\.bias")


def _bn_cancelled(net, name):
    return net == "g" and _BN_CANCELLED.fullmatch(name) is not None


def _close(a, b, rtol=1e-3, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_metrics(stepped):
    _, jm, _, tm = stepped
    assert set(jm) == set(tm) == {"d_loss", "d_real", "d_fake", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), atol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_adam_slots(net, stepped):
    js, _, ts, _ = stepped
    count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    scale = max(np.abs(m).max() for m in mu.values())
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(count) == (N_CRITIC if net == "d" else 1)
        if _bn_cancelled(net, name):
            for a in (st["exp_avg"].numpy(), mu[name]):
                assert np.abs(a).max() <= 1e-4 * scale, name
            continue
        # slots relative to the net's largest entry: rtol 1e-3, atol 1e-5
        _close(st["exp_avg"].numpy() / scale, mu[name] / scale)
        _close(st["exp_avg_sq"].numpy() / scale**2, nu[name] / scale**2)


@pytest.mark.parametrize("net", ["g", "d"])
def test_params(net, stepped):
    js, _, ts, _ = stepped
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    updates = N_CRITIC if net == "d" else 1
    n_far, n_all = 0, 0
    for name, p in getattr(ts, net).named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * LR * updates + 1e-6, name
        if _bn_cancelled(net, name):
            continue
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= max(10, n_all // 1000), (n_far, n_all)


def test_sn_u_and_bn_stats(stepped):
    js, _, ts, _ = stepped
    for net, coll in (("d", js.d_state), ("g", js.g_state)):
        ref = convert.module_tensors({}, coll)
        buffers = dict(getattr(ts, net).named_buffers())
        assert set(ref) == set(buffers)
        for name, arr in ref.items():
            _close(buffers[name].numpy().reshape(arr.shape), arr)


def test_ema_and_step(stepped):
    js, _, ts, _ = stepped
    assert ts.step == int(js.step) == 1
    ref = convert.to_torch_names(js.ema_params)
    assert set(ref) == set(ts.ema_params)
    for name, t in ts.ema_params.items():
        _close(t.numpy(), ref[name], rtol=1e-5, atol=1e-7)
