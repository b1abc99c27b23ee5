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
    """The kernel's table: one row per CTA, (ptr, ptr, M, K, v_off, u_off,
    col0, width, kind, weight, stream), offsets ragged with no padding, idle
    CTAs all zero; built once while pointers and shapes stay the same."""
    _, _, w_t, u_t = _inputs(CIFAR_D_SHAPES)
    t = pi.PowerIterationTable().get(w_t, u_t)
    rows = t.table.tolist()
    assert len(rows) == len(t.plan.ctas) and len(rows) % pi.CLUSTER == 0
    v_offs = np.cumsum([0] + [s[0] for s in CIFAR_D_SHAPES])
    u_offs = np.cumsum([0] + [s[1] for s in CIFAR_D_SHAPES])
    for row, cta in zip(rows, t.plan.ctas):
        if cta.kind == pi.IDLE:
            assert row == [0] * pi.TABLE_COLS
            continue
        i = cta.weight
        assert row[0] == w_t[i].data_ptr() and row[1] == u_t[i].data_ptr()
        assert row[2:6] == [CIFAR_D_SHAPES[i][0], CIFAR_D_SHAPES[i][1], v_offs[i], u_offs[i]]
        assert row[6:] == [cta.col0, cta.width, cta.kind, i, int(cta.stream)]
    assert sorted({r[9] for r in rows if r[8]}) == list(range(len(CIFAR_D_SHAPES)))
    assert t.out_sizes == [len(CIFAR_D_SHAPES), u_offs[-1], v_offs[-1]]
    assert sum(s[0] * s[1] for s in CIFAR_D_SHAPES) == 1_052_544
    table = t.table
    assert t.get(w_t, u_t).table is table  # unchanged pointers: no rebuild
    w_new = [w.clone() for w in w_t]
    assert t.get(w_new, u_t).table is not table  # a moved weight: rebuilt


# the SNGAN-projection ImageNet-128 D's widest 3x3 convs, [fan_in, out]
IMAGENET_WIDE_SHAPES = [(4608, 1024), (9216, 1024)]
# ragged splits: M not a multiple of 4, a last rank narrower than the others,
# K larger than a CTA's threads
RAGGED_SHAPES = [(1153, 130), (64, 3000), (2000, 40)]
SHAPE_SETS = {"cifar_d_shapes": CIFAR_D_SHAPES, "pallas_shapes": PALLAS_SHAPES,
              "imagenet_wide_shapes": IMAGENET_WIDE_SHAPES, "ragged_shapes": RAGGED_SHAPES}


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_plan_owns_every_column_once(name):
    """Every column of every weight belongs to exactly one CTA; a split
    weight fills one whole cluster, rank c at position c of it."""
    shapes = SHAPE_SETS[name]
    plan = pi.plan_power_iteration(shapes)
    cluster = pi.CLUSTER
    assert len(plan.ctas) % cluster == 0
    owned = [np.zeros(m, int) for m, _ in shapes]
    for pos, c in enumerate(plan.ctas):
        if c.kind == pi.IDLE:
            continue
        owned[c.weight][c.col0:c.col0 + c.width] += 1
        if c.kind == pi.SPLIT:
            first = plan.ctas[pos - pos % cluster]
            assert first.weight == c.weight and first.col0 == 0
            assert c.col0 == (pos % cluster) * first.width
    assert all((o == 1).all() for o in owned)
    for start in range(0, len(plan.ctas), cluster):  # one kind per cluster
        kinds = {c.kind for c in plan.ctas[start:start + cluster]}
        assert kinds <= {pi.SPLIT} or pi.SPLIT not in kinds


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_plan_fits_shared_memory_or_streams(name):
    """No CTA needs more shared memory than the limit the plan claims; a
    weight whose slab does not fit is marked to stream, and only then."""
    shapes = SHAPE_SETS[name]
    plan = pi.plan_power_iteration(shapes)
    limit = pi.SMEM_LIMIT
    assert limit == 232_448  # 227 KB, what one CTA may use on sm_90
    assert plan.smem_bytes == max(c.smem_bytes for c in plan.ctas) <= limit
    for c in plan.ctas:
        if c.kind == pi.IDLE:
            continue
        m, k = shapes[c.weight]
        nranks = pi.CLUSTER if c.kind == pi.SPLIT else 1
        assert c.smem_bytes == pi.smem_bytes(k, c.width, nranks, c.stream)
        widest = max(x.width for x in plan.ctas if x.weight == c.weight)
        assert c.stream == (pi.smem_bytes(k, widest, nranks, False) > limit)
    streamed = {shapes[c.weight] for c in plan.ctas if c.kind and c.stream}
    assert streamed == (set(IMAGENET_WIDE_SHAPES) if name == "imagenet_wide_shapes" else set())


def test_plan_layout_of_the_cifar_discriminator():
    """The 7 [1152, 128] weights take a cluster of 8 each (144 columns, a
    72 KB slab per CTA); the 4 small ones one CTA each in a shared cluster."""
    plan = pi.plan_power_iteration(CIFAR_D_SHAPES)
    split = [c for c in plan.ctas if c.kind == pi.SPLIT]
    solo = [c for c in plan.ctas if c.kind == pi.SOLO]
    assert len(split) == 7 * 8 and {c.width for c in split} == {144}
    assert sorted(CIFAR_D_SHAPES[c.weight] for c in solo) == sorted(
        [(27, 128), (3, 128), (128, 128), (128, 1)])
    assert len(plan.ctas) == 64 and not any(c.stream for c in plan.ctas)
    assert 4 * 128 * 144 < plan.smem_bytes < 100_000


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        pi.plan_power_iteration([(9, 100_000)])  # u alone overflows a CTA


def _emulate(plan, mats, us):
    """The kernel's arithmetic over a plan, in float64 numpy: each CTA's v
    slice and partial sums of W^T v over its columns, added over the
    cluster, normalised after the sums as the kernel does."""
    out = {}
    by_weight = {}
    for c in plan.ctas:
        if c.kind != pi.IDLE:
            by_weight.setdefault(c.weight, []).append(c)
    for i, ctas in by_weight.items():
        w_t = mats[i].T.astype(np.float64)  # [K, M]
        u = us[i][0].astype(np.float64)
        v_raw = [u @ w_t[:, c.col0:c.col0 + c.width] for c in ctas]
        ssv = sum(float(x @ x) for x in v_raw)
        y = sum(w_t[:, c.col0:c.col0 + c.width] @ x for c, x in zip(ctas, v_raw))
        y = y / np.sqrt(ssv + 1e-12)
        s = float(y @ y)
        out[i] = (s / np.sqrt(s + 1e-12), y / np.sqrt(s + 1e-12),
                  np.concatenate(v_raw) / np.sqrt(ssv + 1e-12))
    return out


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_planned_split_reproduces_the_reference(name):
    """The split the plan makes, summed as the kernel sums it, gives the JAX
    reference's sigma, u' and v (rtol 1e-4)."""
    shapes = SHAPE_SETS[name]
    mats, us, _, _ = _inputs(shapes, seed=4)
    got = _emulate(pi.plan_power_iteration(shapes), mats, us)
    assert sorted(got) == list(range(len(shapes)))
    for i, (m, u) in enumerate(zip(mats, us)):
        s_ref, u_ref = jax_power_iteration(jnp.asarray(m), jnp.asarray(u), 1)
        sigma, u_new, v = got[i]
        np.testing.assert_allclose(sigma, float(s_ref), rtol=1e-4)
        np.testing.assert_allclose(u_new, np.asarray(u_ref[0]), rtol=1e-4, atol=1e-5)
        v_ref = u @ m.T
        v_ref = v_ref / np.sqrt((v_ref ** 2).sum() + 1e-12)
        np.testing.assert_allclose(v, v_ref[0], rtol=1e-4, atol=1e-5)
