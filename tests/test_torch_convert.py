"""The JAX -> port state converter on a JAX ``create_state`` built as
``bench.py:47-67`` builds it (SNGAN CIFAR, Adam(2e-4, 0, 0.9), EMA 0.9999),
at small widths: every leaf's name, layout, shape and count."""

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
from gan_lib_tensorflow_tpu_torch.train import create_state

G_CH, D_CH = (32, 32, 32), (32, 32, 32, 32)


def _jax_state(schedule=False):
    g = jsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    d = jsngan.ResNetDiscriminator(channels=D_CH)
    lr = optax.linear_schedule(2e-4, 0.0, 10) if schedule else 2e-4
    g_opt = optax.adam(lr, b1=0.0, b2=0.9)
    d_opt = optax.adam(lr, b1=0.0, b2=0.9)
    return jtrain.create_state(
        jax.random.PRNGKey(0),
        lambda r: g.init(r, jnp.zeros((2, g.z_dim)), train=False),
        lambda r: d.init(r, jnp.zeros((2, 32, 32, 3))),
        g_opt, d_opt, ema_decay=0.9999)


def _port_state(lr_lambda=None):
    g = tsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    d = tsngan.ResNetDiscriminator(channels=D_CH)
    return create_state(g, d, ema_decay=0.9999, lr_lambda=lr_lambda, device="cpu")


@pytest.fixture(scope="module")
def converted():
    js = jax.tree_util.tree_map(np.asarray, _jax_state())
    ts = _port_state()
    convert.load_jax_state(ts, js)
    return js, ts


def test_every_leaf_lands_with_its_name_and_layout(converted):
    js, ts = converted
    for net, params, coll in ((ts.g, js.g_params, js.g_state),
                              (ts.d, js.d_params, js.d_state)):
        n_jax = len(jax.tree_util.tree_leaves((params, coll)))
        sd = net.state_dict()
        assert len(sd) == n_jax
        for path, leaf in jax.tree_util.tree_flatten_with_path((params, coll))[0]:
            keys = [k.key for k in path[1:] if hasattr(k, "key")]
            if keys[0] in ("sn", "batch_stats"):
                keys = keys[1:]
            *mods, name = keys
            port = sd[".".join(mods + [convert._LEAF_NAMES[name]])]
            if name == "kernel" and leaf.ndim == 4:
                want = leaf.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            elif name == "kernel":
                want = leaf.T                       # [in, out] -> [out, in]
            else:
                want = leaf
            assert tuple(port.shape) == want.shape
            np.testing.assert_array_equal(port.numpy(), want)


def test_cifar_d_has_11_sn_vectors_and_g_has_bn_stats(converted):
    js, ts = converted
    assert len(jax.tree_util.tree_leaves(js.d_state["sn"])) == 11
    us = [k for k in ts.d.state_dict() if k.endswith(".u")]
    assert len(us) == 11 == len(ts.d.sn_layers)
    assert [m.u.shape[1] for m in ts.d.sn_layers] == [32] * 10 + [1]
    n_bn = len(jax.tree_util.tree_leaves(js.g_state["batch_stats"]))
    assert n_bn == len(list(ts.g.buffers())) == 2 * (2 * len(G_CH) + 1)


def test_adam_slots_ema_and_step(converted):
    js, ts = converted
    for net, opt in ((ts.g, ts.g_opt), (ts.d, ts.d_opt)):
        assert len(opt.state) == len(list(net.parameters()))
        for p in net.parameters():
            st = opt.state[p]
            assert float(st["step"]) == 0.0
            assert st["exp_avg"].shape == p.shape == st["exp_avg_sq"].shape
    assert ts.step == 0
    assert list(ts.ema_params) == [n for n, _ in ts.g.named_parameters()]
    for n, p in ts.g.named_parameters():
        assert torch.equal(ts.ema_params[n], p.detach())


def test_adam_count_and_schedule_position():
    """A state some updates in: count -> step, and the linear schedule's lr
    moved to the same position."""
    js = _jax_state(schedule=True)
    bump = lambda s: s._replace(count=s.count + 3) if hasattr(s, "count") else s
    js = js.replace(g_opt=tuple(bump(s) for s in js.g_opt))
    ts = _port_state(lr_lambda=lambda c: 1.0 - min(c, 10) / 10)
    convert.load_jax_state(ts, jax.tree_util.tree_map(np.asarray, js))
    p = next(ts.g.parameters())
    assert float(ts.g_opt.state[p]["step"]) == 3.0
    np.testing.assert_allclose(ts.g_opt.param_groups[0]["lr"], 2e-4 * 0.7)
    np.testing.assert_allclose(ts.d_opt.param_groups[0]["lr"], 2e-4)


def test_unknown_leaf_raises():
    with pytest.raises(ValueError, match="no port counterpart"):
        convert.to_torch_names({"conv": {"weird": np.zeros(3)}})
