"""The port's WGAN-GP gradient penalty and drift term against the JAX
package's, with the same interpolation weights u (drawn with JAX's
``uniform(rng, (N, 1, 1, 1))`` as its ``gradient_penalty`` draws them):
the penalty's value and its gradient with respect to the critic's
parameters (the double backward), for a linear critic with a closed form and
for the PGGAN D of the port (16x16, fade-in at alpha 0.37, fused_scale
blocks, width_mul 1/32) with the JAX init's weights.

float32 on the CPU. Tolerance rtol 1e-4 / atol 1e-6 for the values; the
double-backward gradients rtol 1e-3 / atol 1e-5 (second derivatives through
a dozen convs sum more terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gan_lib_tensorflow_tpu import losses as jlosses
from gan_lib_tensorflow_tpu.models import pggan as jpggan
from gan_lib_tensorflow_tpu_torch import losses as tlosses
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.models import pggan as tpggan

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RES, ALPHA, N = 16, 0.37, 4


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _u(key, shape):
    """What the reference's gradient_penalty draws from ``key``."""
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))


def test_linear_critic_has_the_closed_form():
    """critic(x) = <w, x>: the gradient is w everywhere, GP = (|w| - 1)^2."""
    w = torch.tensor([3.0, 4.0])
    gp = tlosses.gradient_penalty(lambda x: x @ w, torch.ones(8, 2), -torch.ones(8, 2),
                                  torch.rand(8, 1))
    _close(float(gp), 16.0, rtol=1e-5)
    _close(float(gp), float(jlosses.gradient_penalty(
        lambda x: x @ jnp.asarray([3.0, 4.0]), jnp.ones((8, 2)), -jnp.ones((8, 2)),
        jax.random.PRNGKey(0))), rtol=1e-5)


def test_drift_penalty():
    logits = np.array([[1.0], [-3.0], [0.5]], np.float32)
    _close(float(tlosses.drift_penalty(torch.tensor(logits))),
           float(jlosses.drift_penalty(jnp.asarray(logits))))


def test_pggan_critic_value_and_double_backward():
    jd = jpggan.PGGANDiscriminator(resolution=RES, fade_in=True, width_mul=1 / 32,
                                   fused_from=8)
    params = jd.init(jax.random.PRNGKey(1), jnp.zeros((N, RES, RES, 3)), 1.0)["params"]
    td = tpggan.PGGANDiscriminator(resolution=RES, fade_in=True, width_mul=1 / 32,
                                   fused_from=8)
    td.load_state_dict({k: torch.tensor(v) for k, v in to_torch_names(params).items()})
    rng = np.random.default_rng(0)
    real = np.tanh(rng.standard_normal((N, RES, RES, 3))).astype(np.float32)
    fake = np.tanh(rng.standard_normal((N, RES, RES, 3))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u = _u(key, (N, 1, 1, 1))

    def gp_j(p):
        return jlosses.gradient_penalty(lambda x: jd.apply({"params": p}, x, ALPHA),
                                        jnp.asarray(real), jnp.asarray(fake), key)

    val_j, grads_j = jax.value_and_grad(gp_j)(params)
    gp_t = tlosses.gradient_penalty(lambda x: td(x, ALPHA), torch.tensor(real),
                                    torch.tensor(fake), torch.tensor(u))
    _close(float(gp_t.detach()), float(val_j))
    names, ps = zip(*td.named_parameters())
    # the gradient with respect to x does not depend on the last bias
    grads_t = torch.autograd.grad(gp_t, ps, allow_unused=True)
    ref = to_torch_names(grads_j)
    scale = max(np.abs(g).max() for g in ref.values())
    for n, p, g in zip(names, ps, grads_t):
        g = torch.zeros_like(p) if g is None else g
        _close(g.numpy() / scale, ref[n] / scale, rtol=1e-3, atol=1e-5)
    assert grads_t[names.index("dense_out.bias")] is None
    assert np.abs(ref["dense_out.bias"]).max() == 0.0
