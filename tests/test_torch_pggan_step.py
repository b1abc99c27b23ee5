"""One fused PGGAN step of the port against the JAX package's
``make_train_step``, float32, at small widths (``width_mul`` 1/32, ``z_dim``
16, 8x8, batch 4, fused_scale D blocks at 8x8), for a transition stage at
alpha 0.5 and a stabilize stage, starting from the same converted state.

Torch cannot draw JAX's threefry numbers, so the test replays the step's key
schedule with ``jax.random`` (``train/step.py:87-109``, ``models/pggan.py:
343-360``: the critic's key splits into the fake's z and the penalty's u,
the G update draws its z from its own key) and hands the port the same z and
u.

A second test runs four consecutive transition steps with alpha ramping
1/4 -> 1 (the ladder's schedule) and fresh data and draws each step: the
two packages' metric trajectories must stay together (rtol 1e-3 / atol
1e-4, as summation-order noise compounds over the steps).

Tolerances. Metrics rtol 1e-4 / atol 1e-5; the Adam slots relative to the
net's largest entry rtol 1e-3 / atol 1e-5 (the penalty's double backward
sums more terms in another order). With b1 = 0 Adam's first update is about
lr * sign(g), so a gradient element near 0 can take the other sign in the
two packages and its parameter then differs by up to 2 * lr
(tests/test_torch_step.py explains the bound): every parameter is held to
2 * lr + 1e-6, and all but a handful of elements to 1e-6. The EMA follows
the parameters at 1 - 0.999 of their weight: rtol 1e-5 / atol 1e-7 plus
that share of the 2 * lr bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import pggan as jpggan
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.models import pggan as tpggan
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR, B, Z, RES, WM, EMA = 1e-3, 4, 16, 8, 1 / 32, 0.999


def _jax_draws(rng):
    """z of the critic's fake, the penalty's u and the G update's z."""
    rng, sub = jax.random.split(rng)
    rng_z, rng_gp = jax.random.split(sub)
    z_c = jax.random.normal(rng_z, (B, Z))
    u = jax.random.uniform(rng_gp, (B, 1, 1, 1), dtype=jnp.float32)
    _, sub, _ = jax.random.split(rng, 3)
    z_g = jax.random.normal(sub, (B, Z))
    return np.asarray(z_c)[None], np.asarray(u)[None], np.asarray(z_g)


def _pair(fade, alpha):
    """JAX state, step and the port's state loaded from it."""
    jg = jpggan.PGGANGenerator(resolution=RES, fade_in=fade, z_dim=Z, width_mul=WM)
    jd = jpggan.PGGANDiscriminator(resolution=RES, fade_in=fade, width_mul=WM,
                                   fused_from=RES)
    g_opt = optax.adam(LR, b1=0.0, b2=0.99)
    d_opt = optax.adam(LR, b1=0.0, b2=0.99)
    state0 = jtrain.create_state(
        jax.random.PRNGKey(0),
        lambda r: jg.init(r, jnp.zeros((2, Z)), 1.0),
        lambda r: jd.init(r, jnp.zeros((B, RES, RES, 3)), 1.0),
        g_opt, d_opt, ema_decay=EMA).replace(alpha=jnp.float32(alpha))
    jstep = jax.jit(jtrain.make_train_step(
        jpggan.make_pggan_spec(jg, jd, ema_decay=EMA), g_opt, d_opt))

    tg = tpggan.PGGANGenerator(resolution=RES, fade_in=fade, z_dim=Z, width_mul=WM)
    td = tpggan.PGGANDiscriminator(resolution=RES, fade_in=fade, width_mul=WM,
                                   fused_from=RES)
    tstate = create_state(tg, td, lr=LR, beta1=0.0, beta2=0.99, ema_decay=EMA,
                          device="cpu")
    convert.load_jax_state(tstate, jax.tree_util.tree_map(np.asarray, state0))
    assert tstate.alpha == alpha
    return state0, jstep, tstate, make_train_step(tpggan.make_pggan_spec(tg, td, ema_decay=EMA))


def _step_both(jstate, jstep, tstate, tstep, images):
    z_c, u, z_g = _jax_draws(jstate.rng)
    jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(images)})
    tmetrics = tstep(tstate, {"image": torch.tensor(images)}, z_critic=torch.tensor(z_c),
                     z_g=torch.tensor(z_g), u_gp=torch.tensor(u))
    return jstate, jmetrics, tmetrics


def _images(rng):
    return np.tanh(rng.standard_normal((1, B, RES, RES, 3))).astype(np.float32)


@pytest.fixture(scope="module", params=[("transition", 0.5), ("stabilize", 1.0)],
                ids=["transition", "stabilize"])
def stepped(request):
    phase, alpha = request.param
    state0, jstep, tstate, tstep = _pair(phase == "transition", alpha)
    state1, jmetrics, tmetrics = _step_both(state0, jstep, tstate, tstep,
                                            _images(np.random.default_rng(0)))
    return jax.tree_util.tree_map(np.asarray, state1), jmetrics, tstate, tmetrics


def _close(a, b, rtol=1e-3, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_metrics(stepped):
    _, jm, _, tm = stepped
    assert set(jm) == set(tm) == {"d_loss", "wdist", "gp", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("net", ["g", "d"])
def test_adam_slots(net, stepped):
    js, _, ts, _ = stepped
    count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    scale = max(np.abs(m).max() for m in mu.values())
    assert set(mu) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(count) == 1
        _close(st["exp_avg"].numpy() / scale, mu[name] / scale)
        _close(st["exp_avg_sq"].numpy() / scale**2, nu[name] / scale**2)


@pytest.mark.parametrize("net", ["g", "d"])
def test_params(net, stepped):
    js, _, ts, _ = stepped
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    n_far, n_all = 0, 0
    for name, p in getattr(ts, net).named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * LR + 1e-6, name
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= max(10, n_all // 1000), (n_far, n_all)


def test_ema_alpha_and_step(stepped):
    js, _, ts, _ = stepped
    assert ts.step == int(js.step) == 1
    assert ts.alpha == float(js.alpha)
    ref = convert.to_torch_names(js.ema_params)
    assert set(ref) == set(ts.ema_params)
    for name, t in ts.ema_params.items():
        _close(t.numpy(), ref[name], rtol=1e-5, atol=1e-7 + (1 - EMA) * 2 * LR)


def test_consecutive_steps_track_the_reference():
    jstate, jstep, tstate, tstep = _pair(True, 0.25)
    rng = np.random.default_rng(1)
    for i in range(4):
        alpha = (i + 1) / 4
        jstate, tstate.alpha = jstate.replace(alpha=jnp.float32(alpha)), alpha
        jstate, jm, tm = _step_both(jstate, jstep, tstate, tstep, _images(rng))
        for k in jm:
            _close(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-4)
    assert tstate.step == int(jstate.step) == 4
