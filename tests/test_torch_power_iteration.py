"""The port's batched power iteration (plain version, which the CUDA kernel is
held against on the card) against the JAX Pallas kernel run in interpret
mode (as tests/test_pallas.py runs it) and against ``ops/sn.py``'s
``power_iteration``, with the gradient d(sigma)/dW against ``jax.grad``.

Tolerance rtol 1e-4 (atol 1e-5 for vector entries near 0): float32 on both
sides, only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.ops.pallas_kernels import (batched_power_iteration
                                                       as jax_batched,
                                                       pack_weights)
from gan_lib_tensorflow_tpu.ops.sn import power_iteration as jax_power_iteration
from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# [fan_in, out] shapes of tests/test_pallas.py and of the 11 CIFAR-D weights
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]
CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128)]
                  + [(1152, 128), (1152, 128), (128, 128)]
                  + [(1152, 128)] * 4 + [(128, 1)])


def _inputs(shapes, seed=0):
    """numpy W [fan_in, out] and u [1, out], and the port's tensors: W^T as
    [out, fan_in] (what an OIHW weight reshapes to) and u."""
    rng = np.random.default_rng(seed)
    mats = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    us = [rng.standard_normal((1, s[1])).astype(np.float32) for s in shapes]
    w_t = [torch.tensor(m.T.copy()) for m in mats]
    u_t = [torch.tensor(u) for u in us]
    return mats, us, w_t, u_t


@pytest.mark.parametrize("shapes", [PALLAS_SHAPES, CIFAR_D_SHAPES],
                         ids=["pallas_shapes", "cifar_d_shapes"])
def test_plain_matches_pallas_and_sn(shapes):
    mats, us, w_t, u_t = _inputs(shapes)
    sigma, u_new, v = pi.plain_power_iteration(w_t, u_t)
    w_stack, u_stack = pack_weights(mats, us)
    sig_p, u_p = jax_batched(w_stack, u_stack)  # interpret mode off-TPU
    for i, (m, u) in enumerate(zip(mats, us)):
        k = m.shape[1]
        np.testing.assert_allclose(float(sigma[i]), float(sig_p[i]), rtol=1e-4)
        np.testing.assert_allclose(u_new[i].numpy(), np.asarray(u_p[i, 0, :k]),
                                   rtol=1e-4, atol=1e-5)
        s_ref, u_ref = jax_power_iteration(jnp.asarray(m), jnp.asarray(u), 1)
        np.testing.assert_allclose(float(sigma[i]), float(s_ref), rtol=1e-4)
        np.testing.assert_allclose(u_new[i].numpy(), np.asarray(u_ref[0]),
                                   rtol=1e-4, atol=1e-5)
        # v is the reference's l2n(u W^T)
        v_ref = u @ m.T
        v_ref = v_ref / np.sqrt((v_ref ** 2).sum() + 1e-12)
        np.testing.assert_allclose(v[i].numpy(), v_ref[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shapes", [PALLAS_SHAPES, CIFAR_D_SHAPES],
                         ids=["pallas_shapes", "cifar_d_shapes"])
def test_gradient_matches_jax(shapes):
    """d(sum_i c_i sigma_i)/dW_i through the wrapper (plain path on CPU
    tensors) equals jax.grad of sn.power_iteration's sigma: c_i v_i^T u'_i."""
    mats, us, w_t, u_t = _inputs(shapes, seed=1)
    c = np.random.default_rng(2).standard_normal(len(shapes)).astype(np.float32)
    ws = [w.clone().requires_grad_(True) for w in w_t]
    sigma = pi.batched_power_iteration(ws, u_t)
    (sigma * torch.tensor(c)).sum().backward()
    for i, (m, u) in enumerate(zip(mats, us)):
        g = jax.grad(lambda w: c[i] * jax_power_iteration(w, jnp.asarray(u), 1)[0])(
            jnp.asarray(m))
        np.testing.assert_allclose(ws[i].grad.numpy().T, np.asarray(g),
                                   rtol=1e-4, atol=1e-6)


def test_update_flag_advances_u_in_place():
    mats, us, w_t, u_t = _inputs(PALLAS_SHAPES, seed=3)
    before = [u.clone() for u in u_t]
    pi.batched_power_iteration(w_t, u_t, update=False)
    assert all(torch.equal(a, b) for a, b in zip(u_t, before))
    _, u_new, _ = pi.plain_power_iteration(w_t, u_t)
    pi.batched_power_iteration(w_t, u_t, update=True)
    for u, un in zip(u_t, u_new):
        assert torch.equal(u.reshape(-1), un)


def test_plain_path_does_not_count_launches():
    _, _, w_t, u_t = _inputs(PALLAS_SHAPES)
    before = pi.launches
    pi.batched_power_iteration(w_t, u_t, update=True)
    assert pi.launches == before


def test_kernel_launch_rejects_cpu_and_bad_inputs():
    _, _, w_t, u_t = _inputs(PALLAS_SHAPES)
    with pytest.raises(ValueError, match="CUDA"):
        pi.launch(w_t, u_t)
    with pytest.raises(ValueError, match="float32"):
        pi.launch([w_t[0].double()], [u_t[0]])
    with pytest.raises(ValueError, match="needs a u"):
        pi.launch([w_t[0]], [u_t[1]])
    with pytest.raises(ValueError, match="contiguous"):
        pi.launch([w_t[0].T], [torch.zeros(1, w_t[0].shape[1])])


def test_table_rows_are_ragged_offsets():
    """The kernel's table: one row per weight, (ptr, ptr, M, K, v_off, u_off),
    no padding; built once while pointers and shapes stay the same."""
    _, _, w_t, u_t = _inputs(CIFAR_D_SHAPES)
    t = pi.PowerIterationTable().get(w_t, u_t)
    rows = t.table.tolist()
    assert [r[2] for r in rows] == [s[0] for s in CIFAR_D_SHAPES]
    assert [r[3] for r in rows] == [s[1] for s in CIFAR_D_SHAPES]
    assert rows[0][4] == 0 and rows[-1][4] == sum(s[0] for s in CIFAR_D_SHAPES[:-1])
    assert rows[-1][5] == sum(s[1] for s in CIFAR_D_SHAPES[:-1])
    assert sum(s[0] * s[1] for s in CIFAR_D_SHAPES) == 1_052_544
    table = t.table
    assert t.get(w_t, u_t).table is table  # unchanged pointers: no rebuild

