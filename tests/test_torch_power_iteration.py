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
    col0, width, kind, weight), offsets ragged with no padding, idle CTAs
    all zero; built once while pointers and shapes stay the same."""
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
        assert row[6:] == [cta.col0, cta.width, cta.kind, i]
    assert sorted({r[9] for r in rows if r[8]}) == list(range(len(CIFAR_D_SHAPES)))
    assert t.out_sizes == [len(CIFAR_D_SHAPES), u_offs[-1], v_offs[-1]]
    assert not t.plan.items and t.counters.tolist() == [0] * len(CIFAR_D_SHAPES)
    assert sum(s[0] * s[1] for s in CIFAR_D_SHAPES) == 1_052_544
    table = t.table
    assert t.get(w_t, u_t).table is table  # unchanged pointers: no rebuild
    w_new = [w.clone() for w in w_t]
    assert t.get(w_new, u_t).table is not table  # a moved weight: rebuilt


# the SNGAN-projection ImageNet-128 D's widest 3x3 convs, [fan_in, out]
IMAGENET_WIDE_SHAPES = [(4608, 1024), (9216, 1024)]
# the ImageNet-128 D's 19 SN weights in registration order, [fan_in, out]
IMAGENET_D_SHAPES = [(27, 64), (576, 64), (3, 64), (576, 128), (1152, 128), (64, 128),
                     (1152, 256), (2304, 256), (128, 256), (2304, 512), (4608, 512),
                     (256, 512), (4608, 1024), (9216, 1024), (512, 1024), (9216, 1024),
                     (9216, 1024), (1024, 1), (1000, 1024)]
# ragged splits: M not a multiple of 4, a last rank narrower than the others,
# K larger than a CTA's threads
RAGGED_SHAPES = [(1153, 130), (64, 3000), (2000, 40)]
# ragged streamed weights: M not a multiple of 4 or of a tile, K not a
# multiple of the threads, tiles of 16, 32 and 64 columns
RAGGED_STREAMED = [(9001, 1000), (4099, 700), (3001, 333), (13, 4096)]
SHAPE_SETS = {"cifar_d_shapes": CIFAR_D_SHAPES, "pallas_shapes": PALLAS_SHAPES,
              "imagenet_wide_shapes": IMAGENET_WIDE_SHAPES, "ragged_shapes": RAGGED_SHAPES,
              "imagenet_d_shapes": IMAGENET_D_SHAPES, "ragged_streamed": RAGGED_STREAMED}
# the sets with a weight whose slab does not fit: all their weights stream
STREAMED = {"imagenet_wide_shapes", "imagenet_d_shapes", "ragged_streamed"}


def _stream_ctas(plan):
    return [c for c in plan.ctas if c.kind == pi.STREAM]


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_plan_owns_every_column_once(name):
    """Every column of every weight belongs to exactly one slab CTA or one
    item; a split weight fills one whole cluster, rank c at position c of
    it; a streaming CTA's items are consecutive, each a run of whole tiles
    of one weight (the last one ragged), and a weight's parts are numbered
    in column order."""
    shapes = SHAPE_SETS[name]
    plan = pi.plan_power_iteration(shapes)
    cluster = pi.CLUSTER
    assert len(plan.ctas) % cluster == 0 or plan.items
    owned = [np.zeros(m, int) for m, _ in shapes]
    for pos, c in enumerate(plan.ctas):
        if c.kind in (pi.IDLE, pi.STREAM):
            continue
        owned[c.weight][c.col0:c.col0 + c.width] += 1
        if c.kind == pi.SPLIT:
            first = plan.ctas[pos - pos % cluster]
            assert first.weight == c.weight and first.col0 == 0
            assert c.col0 == (pos % cluster) * first.width
    dealt = []
    for c in _stream_ctas(plan):
        assert c.width >= 1
        dealt += list(range(c.col0, c.col0 + c.width))
    assert dealt == list(range(len(plan.items)))
    for it in plan.items:
        m, k = shapes[it.weight]
        tc = pi.tile_cols(k)
        assert it.col0 % tc == 0 and (it.width % tc == 0 or it.col0 + it.width == m)
        owned[it.weight][it.col0:it.col0 + it.width] += 1
    assert all((o == 1).all() for o in owned)
    for i in {it.weight for it in plan.items}:
        mine = [it for it in plan.items if it.weight == i]
        assert [it.part for it in mine] == list(range(len(mine)))
        assert {it.parts for it in mine} == {len(mine)}
        assert [it.col0 for it in mine] == sorted(it.col0 for it in mine)
    if plan.items:  # a streamed launch: streaming CTAs only, no clusters
        assert {c.kind for c in plan.ctas} <= {pi.STREAM, pi.IDLE}
    for start in range(0, len(plan.ctas), cluster):  # split clusters hold nothing else
        kinds = {c.kind for c in plan.ctas[start:start + cluster]}
        assert kinds <= {pi.SPLIT} or pi.SPLIT not in kinds


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_plan_fits_shared_memory_or_streams(name):
    """No CTA needs more shared memory than the limit the plan claims; when
    a weight's slab does not fit in one CTA of its cluster (or alone), and
    only then, every weight of the launch streams; a streamed tile takes
    fewer chunk slots than a streaming CTA has, so that the next tile loads
    while it is computed."""
    shapes = SHAPE_SETS[name]
    plan = pi.plan_power_iteration(shapes)
    limit = pi.SMEM_LIMIT
    assert limit == 232_448  # 227 KB, what one CTA may use on sm_90
    assert plan.smem_bytes == max(c.smem_bytes for c in plan.ctas) <= limit
    for c in plan.ctas:
        if c.kind in (pi.SOLO, pi.SPLIT):
            m, k = shapes[c.weight]
            nranks = pi.CLUSTER if c.kind == pi.SPLIT else 1
            assert c.smem_bytes == pi.smem_bytes(k, c.width, nranks)
            widest = max(x.width for x in plan.ctas if x.weight == c.weight)
            assert pi.smem_bytes(k, widest, nranks) <= limit
    streamed = {shapes[it.weight] for it in plan.items}
    assert streamed == (set(shapes) if name in STREAMED else set())
    assert (not all(pi.slab_fits(m, k) for m, k in shapes)) == (name in STREAMED)
    if streamed:
        kmax = max(k for _, k in streamed)
        assert plan.slots == pi.stream_slots(kmax) <= pi.MAX_SLOTS
        assert {c.smem_bytes for c in _stream_ctas(plan)} == {pi.stream_smem_bytes(kmax)}
        for m, k in streamed:
            assert pi.tile_chunks(k) < plan.slots
    else:
        assert plan.slots == 0
    assert pi.tile_cols(1024) == 32 and pi.tile_chunks(1024) == 8  # 128-byte row pieces


def test_streamed_bytes_are_balanced_at_the_imagenet_dims():
    """The ImageNet-128 D on a card of 132 SMs: 9 of its weights do not fit
    in shared memory, so all 19 stream, dealt to 132 CTAs without clusters,
    each within 10% of an equal share of the cost (bytes, 8 KB a tile and
    64 KB a weight; a tile of 128 KB is about a tenth of a share). Each of the three 37.75 MB convs
    spreads over 32 or 33 CTAs, where PR 3's plan gave it one cluster of 8."""
    plan = pi.plan_power_iteration(IMAGENET_D_SHAPES, max_ctas=132)
    assert len(plan.ctas) == 132 and len(_stream_ctas(plan)) == 132
    cost = [sum(4 * IMAGENET_D_SHAPES[it.weight][1] * it.width
                + pi.TILE_COST_BYTES * pi._cdiv(it.width, pi.tile_cols(IMAGENET_D_SHAPES[it.weight][1]))
                + (pi.ITEM_COST_BYTES if it.col0 == 0 else 0)
                for it in plan.items[c.col0:c.col0 + c.width]) for c in _stream_ctas(plan)]
    w_bytes = sum(4 * it.width * IMAGENET_D_SHAPES[it.weight][1] for it in plan.items)
    assert w_bytes == 4 * sum(m * k for m, k in IMAGENET_D_SHAPES) == 157_740_544
    share = sum(cost) / 132
    assert max(cost) <= 1.1 * share and min(cost) >= 0.9 * share
    for i in (13, 15, 16):
        assert 32 <= plan.items[[it.weight for it in plan.items].index(i)].parts <= 33
    # a card with fewer SMs: fewer streaming CTAs, the same rule
    assert len(pi.plan_power_iteration(IMAGENET_D_SHAPES, max_ctas=114).ctas) == 114


def test_plan_layout_of_the_cifar_discriminator():
    """The 7 [1152, 128] weights take a cluster of 8 each (144 columns, a
    72 KB slab per CTA); the 4 small ones one CTA each in a shared cluster;
    nothing streams."""
    plan = pi.plan_power_iteration(CIFAR_D_SHAPES)
    split = [c for c in plan.ctas if c.kind == pi.SPLIT]
    solo = [c for c in plan.ctas if c.kind == pi.SOLO]
    assert len(split) == 7 * 8 and {c.width for c in split} == {144}
    assert sorted(CIFAR_D_SHAPES[c.weight] for c in solo) == sorted(
        [(27, 128), (3, 128), (128, 128), (128, 1)])
    assert len(plan.ctas) == 64 and not plan.items and not _stream_ctas(plan)
    assert 4 * 128 * 144 < plan.smem_bytes < 100_000


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        pi.plan_power_iteration([(9, 100_000)])  # u alone overflows a CTA


def _emulate(plan, mats, us):
    """The kernel's arithmetic over a plan, in float32 numpy. A slab
    weight: each CTA's v slice and partial sums of W^T v over its columns,
    added over the cluster in rank order. A streamed weight: tile by tile,
    the tile's v (its rows added in the kernel's row groups), its |v|^2 and
    its W^T v added into the item's partials, the items' partials then added
    in part order; 1/|v| applied once, after the sums."""
    out = {}
    slab, parts = {}, {}
    for c in plan.ctas:
        if c.kind in (pi.SOLO, pi.SPLIT):
            slab.setdefault(c.weight, []).append(c)
    for it in plan.items:
        parts.setdefault(it.weight, []).append(it)
    for i in sorted(set(slab) | set(parts)):
        w_t = mats[i].T.astype(np.float32)  # [K, M]
        u = us[i][0].astype(np.float32)
        k, m = w_t.shape
        v_raw = np.zeros(m, np.float32)
        ys, sss = [], []
        if i in slab:
            for c in slab[i]:
                sl = slice(c.col0, c.col0 + c.width)
                v_raw[sl] = u @ w_t[:, sl]
                sss.append(np.float32(v_raw[sl] @ v_raw[sl]))
                ys.append(w_t[:, sl] @ v_raw[sl])
        tc = pi.tile_cols(k) if i in parts else 0
        rp = pi.WARPS * 32 // (tc // 4) if tc else 0  # rows per step of the v pass
        for it in parts.get(i, []):
            y, ss = np.zeros(k, np.float32), np.float32(0)
            for c0 in range(it.col0, it.col0 + it.width, tc):
                sl = slice(c0, min(c0 + tc, it.col0 + it.width))
                v = np.sum([u[g::rp] @ w_t[g::rp, sl] for g in range(rp)], axis=0,
                           dtype=np.float32)
                v_raw[sl] = v
                ss = np.float32(ss + v @ v)
                y = y + w_t[:, sl] @ v
            ys.append(y)
            sss.append(ss)
        ssv = np.float32(0)
        ysum = np.zeros(k, np.float32)
        for y, ss in zip(ys, sss):  # rank or part order
            ysum, ssv = ysum + y, np.float32(ssv + ss)
        inv_v = np.float32(1) / np.sqrt(ssv + np.float32(1e-12))
        y = ysum * inv_v
        s = np.float32(y @ y)
        inv_u = np.float32(1) / np.sqrt(s + np.float32(1e-12))
        out[i] = (s * inv_u, y * inv_u, v_raw * inv_v)
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
