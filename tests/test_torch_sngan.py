"""SNGAN CIFAR G and D of the port against the JAX package's, at small widths
(G (32, 32, 32), D (32, 32, 32, 32), batch 4) with the JAX init's weights.

float32 on the CPU on both sides; tolerance rtol 1e-4 / atol 1e-4: a dozen
stacked convs and BNs accumulate summation-order differences of ~1e-5
relative, and logits are sums over the feature map. D's parameter
gradients hold to rtol 1e-4 / atol 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.models import sngan as jsngan
from gan_lib_tensorflow_tpu.train.state import EvalState
from gan_lib_tensorflow_tpu_torch.convert import module_tensors, to_torch_names
from gan_lib_tensorflow_tpu_torch.models import sngan as tsngan

RTOL, ATOL = 1e-4, 1e-4
G_CH, D_CH = (32, 32, 32), (32, 32, 32, 32)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _load(module, variables):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            module_tensors(params, rest).items()}, strict=True)


def _g_pair():
    jg = jsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    variables = jg.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)), train=False)
    tg = tsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    _load(tg, variables)
    return jg, tg, variables


def _d_pair(fused):
    jd = jsngan.ResNetDiscriminator(channels=D_CH, fused=fused)
    variables = jd.init(jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)))
    td = tsngan.ResNetDiscriminator(channels=D_CH, fused=fused)
    _load(td, variables)
    return jd, td, variables


def _z(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 128)).astype(np.float32)


def _images(n=4, seed=1):
    return np.tanh(np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3))).astype(np.float32)


def test_generator_train_forward_and_running_stats():
    jg, tg, variables = _g_pair()
    z = _z()
    y_j, new_state = jg.apply(variables, jnp.asarray(z), train=True,
                              mutable=["batch_stats"])
    y_t = tg(torch.tensor(z), train=True)
    assert tuple(y_t.shape) == (4, 32, 32, 3)
    _close(y_t.detach(), y_j)
    ref = to_torch_names(new_state["batch_stats"])
    buffers = dict(tg.named_buffers())
    assert set(ref) == set(buffers)
    for name, arr in ref.items():
        _close(buffers[name], arr)


def test_generator_grouped_bn_matches_per_microbatch():
    """groups=2 over [2*B] z equals two separate train-mode forwards (the
    reference's vmap over microbatches) and leaves running stats alone."""
    _, tg, _ = _g_pair()
    z = torch.tensor(_z(8))
    before = {k: v.clone() for k, v in tg.named_buffers()}
    with torch.no_grad():
        y = tg(z, train=True, groups=2, update_stats=False)
        parts = [tg(z[:4], train=True, update_stats=False),
                 tg(z[4:], train=True, update_stats=False)]
    _close(y, torch.cat(parts))
    for k, v in tg.named_buffers():
        assert torch.equal(v, before[k])


@pytest.mark.parametrize("fused", [True, False])
def test_discriminator_forward_and_u_advance(fused):
    jd, td, variables = _d_pair(fused)
    x = _images()
    logits_j, new_sn = jd.apply(variables, jnp.asarray(x), update_sn=True,
                                mutable=["sn"])
    assert len(td.sn_layers) == 11
    u_before = {k: v.clone() for k, v in td.named_buffers()}
    logits_t = td(torch.tensor(x), update_sn=False)
    _close(logits_t.detach(), logits_j)
    for k, v in td.named_buffers():  # no advance without update_sn
        assert torch.equal(v, u_before[k])
    logits_t = td(torch.tensor(x), update_sn=True)
    _close(logits_t.detach(), logits_j)  # sigma from the old u either way
    ref = to_torch_names(new_sn["sn"])
    buffers = dict(td.named_buffers())
    assert set(ref) == set(buffers) and len(ref) == 11
    for name, arr in ref.items():
        _close(buffers[name].reshape(arr.shape), arr)


@pytest.mark.parametrize("fused", [True, False])
def test_discriminator_gradients(fused):
    jd, td, variables = _d_pair(fused)
    x = _images(seed=2)
    gp_j = jax.grad(lambda p: jnp.sum(jd.apply({**variables, "params": p},
                                               jnp.asarray(x))))(variables["params"])
    td(torch.tensor(x)).sum().backward()
    ref = to_torch_names(gp_j)
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-4, atol=1e-5)


def test_sampler_uses_ema_params_and_training_bn_stats():
    jg, tg, variables = _g_pair()
    # move the running stats off their init so the pairing matters
    _, trained = jg.apply(variables, jnp.asarray(_z(seed=3)), train=True,
                          mutable=["batch_stats"])
    ema = jax.tree_util.tree_map(lambda p: p * 0.9, variables["params"])
    jstate = EvalState(step=jnp.int32(0), g_params=variables["params"],
                       g_state=dict(trained), ema_params=ema,
                       alpha=jnp.float32(1.0))
    rng = jax.random.PRNGKey(5)
    y_j = jsngan.make_sampler(jg)(jstate, rng, 4)
    z = np.asarray(jax.random.normal(rng, (4, 128)))

    _load(tg, {"params": variables["params"], **trained})
    tstate = types.SimpleNamespace(ema_params={
        k: torch.tensor(v) for k, v in to_torch_names(ema).items()})
    y_t = tsngan.make_sampler(tg)(tstate, torch.tensor(z))
    _close(y_t, y_j)
    assert not np.allclose(y_t.numpy(), tg(torch.tensor(z), train=False).detach().numpy())
