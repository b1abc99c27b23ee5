"""pix2pix of the port against the JAX package's.

Forwards at full width (U-Net ngf 64 and PatchGAN ndf 64 at 256^2, batch 1)
with the JAX init's weights converted; one fused step at narrow width (ngf =
ndf = 8) and full depth (256^2: 8 encoder levels, the 30x30 patch map) from
the same converted state, in float32 and bf16; the translator at
``train=False``; ``load_jax_state`` of the stepped reference state.

Torch cannot draw JAX's numbers, so G's dropout keep masks are replayed:
``nn.intercept_methods`` reads them back from each ``nn.Dropout`` call as
``out != 0`` under the key the reference uses (the step's per-substep key
for the D step, its G key for the G step, ``train/step.py:89, 106``).

Tolerances, float32 on the CPU: forwards rtol 1e-4 / atol 1e-4 (16 conv
layers of summation-order noise through BN); the step's losses rtol 1e-3 /
atol 1e-4, BN running stats and Adam slots rtol 1e-3 / atol 1e-5 of each
tensor's largest entry, parameters within 2 * lr (Adam's first update is
about lr * sign(g), so a gradient element near 0 can take either sign) and
1e-6 on all but 1 in 1000.

bf16: the losses rtol 4e-3 (about one bf16 rounding step), running stats
atol 2e-2 of each tensor's largest entry, the translator's output atol 5e-2
(about 12 bf16 steps at 1.0), parameters within 2 * lr and 1e-6 on 9 in 10.
Gradients in bf16 are noisy in both packages: at the 2x2 and 1x1 levels BN
normalizes four values per channel, and its backward cancels most of each
rounded upstream gradient. The reference's own bf16 Adam slots lie up to
about 25% (relative L2, ``dec_bn0``) from its float32 ones. So each bf16
slot tensor of the port must lie no farther from the reference's bf16 slot
than twice that distance of the reference's bf16 slot from its float32 one
(independent rounding noise of equal size would give sqrt(2)).

The conv biases that feed a BatchNorm (in G and in D) are removed by it:
their gradients are rounding noise, the port's slots are held to 1e-4
(float32) or 2^-7 (bf16) of the net's largest slot entry, and their
parameters only to 2 * lr.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import pix2pix as jpix
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.models import pix2pix as tpix
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

S = 256


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def _load(module, variables):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            convert.module_tensors(params, rest).items()}, strict=True)


def _images(seed, n=1):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, S, S, 3))).astype(np.float32)


def _recording(fn):
    """``fn`` run under an interceptor that also returns the keep mask
    (``out != 0``) of every ``nn.Dropout`` call, in call order."""
    def wrapped(*args):
        masks = []

        def record(next_fun, a, kw, context):
            out = next_fun(*a, **kw)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                masks.append(out != 0)
            return out

        with nn.intercept_methods(record):
            out = fn(*args)
        return out, masks
    return wrapped


def _init_both(jg, jd, seed):
    def init(r):
        rg, rd = jax.random.split(r)
        x = jnp.zeros((1, S, S, 3))
        return (jg.init({"params": rg, "dropout": jax.random.PRNGKey(7)}, x, train=False),
                jd.init(rd, x, x, train=False))
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(jax.random.PRNGKey(seed)))


def _masks(jg, g_vars, x, keys):
    """G's three keep masks (NHWC bool) under each key of ``keys``, read back
    in one jitted call; they depend on the key and the shapes only."""
    def apply(v, xx, ks):
        return [jg.apply(v, xx, train=True, mutable=["batch_stats"], rngs={"dropout": k})[0]
                for k in ks]

    _, masks = jax.jit(_recording(apply))(g_vars, jnp.asarray(x), list(keys))
    assert len(masks) == 3 * len(keys)
    return [[torch.tensor(np.asarray(m)) for m in masks[3 * i:3 * i + 3]]
            for i in range(len(keys))]


# ---- forwards at full width


@pytest.fixture(scope="module")
def full_width():
    jg, jd = jpix.UNetGenerator(), jpix.PatchGANDiscriminator()
    gv, dv = _init_both(jg, jd, 0)
    tg, td = tpix.UNetGenerator(), tpix.PatchGANDiscriminator()
    _load(tg, gv)
    _load(td, dv)
    return jg, jd, gv, dv, tg, td


def test_full_width_shapes_and_parameter_counts(full_width):
    _, _, gv, dv, tg, td = full_width
    count = lambda tree: sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(tree))
    n_g, n_d = sum(p.numel() for p in tg.parameters()), sum(p.numel() for p in td.parameters())
    assert n_g == count(gv["params"]) and n_d == count(dv["params"])
    assert 54_300_000 < n_g < 54_500_000 and 2_760_000 < n_d < 2_780_000
    assert tg.enc_chs == (64, 128, 256, 512, 512, 512, 512, 512)
    assert not hasattr(tg, "enc_bn0") and not hasattr(tg, "enc_bn7")
    assert tuple(tg.dec1.weight.shape) == (512, 1024, 4, 4)  # [h, skip] in
    assert tg.mask_shapes(1) == [(1, 2, 2, 512), (1, 4, 4, 512), (1, 8, 8, 512)]


def test_unet_forward_full_width_with_reference_masks(full_width):
    """Training mode (batch statistics, running stats advanced once) and
    test mode (running averages), dropout on in both, the same masks."""
    jg, _, gv, _, tg, _ = full_width
    x = _images(1)
    key = jax.random.PRNGKey(3)

    def both(v, xx):
        y, new = jg.apply(v, xx, train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return y, new, jg.apply(v, xx, train=False, rngs={"dropout": key})

    (y_train, new, y_test), masks = jax.jit(_recording(both))(gv, jnp.asarray(x))
    masks = [torch.tensor(np.asarray(m)) for m in masks[:3]]
    assert [tuple(m.shape) for m in masks] == tg.mask_shapes(1)
    assert 0.4 < float(torch.cat([m.reshape(-1) for m in masks]).float().mean()) < 0.6
    before = {k: v.clone() for k, v in tg.named_buffers()}
    with torch.no_grad():
        y_t = tg(torch.tensor(x), masks, train=False)
        assert all(torch.equal(v, before[k]) for k, v in tg.named_buffers())
        _close(y_t, y_test)
        y_t = tg(torch.tensor(x), masks, train=True)
    assert tuple(y_t.shape) == (1, S, S, 3) and y_t.dtype == torch.float32
    _close(y_t, y_train)
    ref = convert.to_torch_names(new["batch_stats"])
    buffers = dict(tg.named_buffers())
    assert set(ref) == set(buffers)
    for name, arr in ref.items():
        _close(buffers[name], arr, atol=1e-5)
    tg.load_state_dict({**tg.state_dict(), **before})


def test_patchgan_forward_full_width_30x30(full_width):
    _, jd, _, dv, _, td = full_width
    inp, tgt = _images(4), _images(5)
    j_train, new = jd.apply(dv, jnp.asarray(inp), jnp.asarray(tgt), train=True,
                            mutable=["batch_stats"])
    j_test = jd.apply(dv, jnp.asarray(inp), jnp.asarray(tgt), train=False)
    with torch.no_grad():
        t_test = td(torch.tensor(inp), torch.tensor(tgt), train=False)
        t_train = td(torch.tensor(inp), torch.tensor(tgt), train=True, update_stats=False)
    assert tuple(t_train.shape) == (1, 30, 30, 1) and t_train.dtype == torch.float32
    _close(t_train, j_train)
    _close(t_test, j_test)
    assert all(torch.equal(v, torch.zeros_like(v) if "mean" in k else torch.ones_like(v))
               for k, v in td.named_buffers())  # update_stats=False left them


def test_patchgan_bf16_logits_are_float32():
    td = tpix.PatchGANDiscriminator(base_ch=4, compute_dtype=torch.bfloat16)
    x = torch.zeros(1, 32, 32, 3)
    assert td(x, x).dtype == torch.float32 and td.conv3.compute_dtype == torch.bfloat16


# ---- one fused step at narrow width, full depth


C, LR = 8, 2e-4


@pytest.fixture(scope="module")
def step_start():
    """The narrow networks' variables, one paired batch and G's masks of the
    step's D and G forwards: shared by both dtypes."""
    jg, jd = jpix.UNetGenerator(base_ch=C), jpix.PatchGANDiscriminator(base_ch=C)
    gv, dv = _init_both(jg, jd, 0)
    rng = jax.random.PRNGKey(1)
    step_rng = jax.random.split(rng, 3)[2]  # the state's rng (train/state.py:71)
    d_key = jax.random.split(step_rng)[1]                              # step.py:89
    g_key = jax.random.split(jax.random.split(step_rng)[0], 3)[1]      # step.py:106
    inp, tgt = _images(8), _images(9)
    m_d, m_g = _masks(jg, gv, inp, [d_key, g_key])
    return gv, dv, rng, inp, tgt, m_d, m_g


def _port_state(dtype, jax_state):
    tg = tpix.UNetGenerator(S, C, compute_dtype=dtype)
    td = tpix.PatchGANDiscriminator(C, compute_dtype=dtype)
    st = create_state(tg, td, lr=LR, beta1=0.5, beta2=0.999, device="cpu")
    convert.load_jax_state(st, jax.tree_util.tree_map(np.asarray, jax_state))
    return st


DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def references(step_start):
    """The reference's state after one jitted step, and its metrics, in
    each compute dtype."""
    gv, dv, rng, inp, tgt, _, _ = step_start
    out = {}
    for name, (jdtype, _) in DTYPES.items():
        spec = jpix.make_pix2pix_spec(jpix.UNetGenerator(base_ch=C, compute_dtype=jdtype),
                                      jpix.PatchGANDiscriminator(base_ch=C, compute_dtype=jdtype))
        g_opt, d_opt = optax.adam(LR, b1=0.5), optax.adam(LR, b1=0.5)
        state0 = jtrain.create_state(rng, lambda r: gv, lambda r: dv, g_opt, d_opt)
        state1, jm = jax.jit(jtrain.make_train_step(spec, g_opt, d_opt))(
            state0, {"input": jnp.asarray(inp[None]), "target": jnp.asarray(tgt[None])})
        out[name] = (jax.tree_util.tree_map(np.asarray, state0),
                     jax.tree_util.tree_map(np.asarray, state1), jm)
    return out


@pytest.fixture(scope="module", params=list(DTYPES))
def stepped(request, step_start, references):
    """(reference state after the step, its metrics, the port's state after
    the same step from the same start, its metrics, the dtype's name)."""
    _, _, _, inp, tgt, m_d, m_g = step_start
    state0, state1, jm = references[request.param]
    tstate = _port_state(DTYPES[request.param][1], state0)
    tspec = tpix.make_pix2pix_spec(tstate.g, tstate.d)
    assert tspec.paired and tspec.n_critic == 1 and tstate.ema_params is None
    tm = make_train_step(tspec)(
        tstate, {"input": torch.tensor(inp[None]), "target": torch.tensor(tgt[None])},
        masks_critic=[m_d], masks_g=m_g)
    return state1, jm, tstate, tm, request.param


def test_step_metrics(stepped):
    _, jm, _, tm, dtype = stepped
    assert set(jm) == set(tm) == {"d_loss", "g_gan", "g_l1", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), rtol={"fp32": 1e-3, "bf16": 4e-3}[dtype],
               atol=1e-4)
    # g_loss = 1 * bce + 100 * L1
    _close(float(tm["g_loss"]), float(tm["g_gan"]) + 100 * float(tm["g_l1"]), rtol=1e-5)


def _bn_cancelled(net, name):
    """The conv biases that feed a BatchNorm: G's encoder levels but the
    first and the last, G's decoder levels but ``dec_out``, D's ``conv1-3``."""
    if net == "d":
        return name in ("conv1.bias", "conv2.bias", "conv3.bias")
    m = re.fullmatch(r"(enc|dec)(\d+)\.bias", name)
    return m is not None and not (m[1] == "enc" and m[2] in ("0", "7"))


def _slots(opt_state):
    _, mu, nu = convert._adam_fields(opt_state)
    return convert.to_torch_names(mu), convert.to_torch_names(nu)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_adam_slots_and_params(net, stepped, references):
    js, _, ts, _, dtype = stepped
    mu, nu = _slots(getattr(js, f"{net}_opt"))
    mu32, nu32 = _slots(getattr(references["fp32"][1], f"{net}_opt"))
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    scale = max(np.abs(m).max() for m in mu.values())
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    n_far, n_all = 0, 0
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(convert._adam_fields(getattr(js, f"{net}_opt"))[0]) == 1
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * LR + 1e-6, name
        if _bn_cancelled(net, name):
            noise = {"fp32": 1e-4, "bf16": 2.0 ** -7}[dtype]
            assert np.abs(st["exp_avg"].numpy()).max() <= noise * scale, name
            continue
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
        for got, want, want32 in ((st["exp_avg"].numpy(), mu[name], mu32[name]),
                                  (st["exp_avg_sq"].numpy(), nu[name], nu32[name])):
            if dtype == "fp32":
                t_scale = np.abs(want).max()
                _close(got / t_scale, want / t_scale, rtol=1e-3, atol=1e-5)
            else:
                dist = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
                assert dist(got, want) <= 2 * dist(want, want32), name
    assert n_far <= max(10, n_all // {"fp32": 1000, "bf16": 10}[dtype]), (n_far, n_all)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_bn_running_stats(net, stepped):
    """D's running stats advanced through the real tower, then the fake one
    (twice in all); G's once, by the G step (the D step's G forward leaves
    them)."""
    js, _, ts, _, dtype = stepped
    ref = convert.module_tensors({}, getattr(js, f"{net}_state"))
    buffers = dict(getattr(ts, net).named_buffers())
    assert set(ref) == set(buffers) and ref
    for name, arr in ref.items():
        scale = max(np.abs(arr).max(), 1e-30)
        _close(buffers[name].numpy() / scale, arr / scale, rtol=1e-3,
               atol={"fp32": 1e-5, "bf16": 2e-2}[dtype])
    assert ts.step == int(js.step) == 1


def test_translator_matches_the_reference(stepped):
    """``train=False`` (the step's running averages) with dropout on, the
    reference's masks of one key; outputs at atol 1e-4 (float32) or 5e-2
    (bf16, about 12 bf16 steps at 1.0)."""
    js, _, ts, _, dtype = stepped
    jg = jpix.UNetGenerator(base_ch=C, compute_dtype=DTYPES[dtype][0])
    gvars = {"params": js.g_params, **js.g_state}
    tg = tpix.UNetGenerator(S, C, compute_dtype=ts.g.dec0.compute_dtype)
    _load(tg, gvars)
    x = _images(11)
    key = jax.random.PRNGKey(5)
    # make_translator's own function, unjitted: its jit would hide the masks
    y_j, masks = jax.jit(_recording(
        lambda v, xx: jg.apply(v, xx, train=False, rngs={"dropout": key})))(gvars, jnp.asarray(x))
    masks = [torch.tensor(np.asarray(m)) for m in masks]
    with torch.no_grad():
        y_t = tg(torch.tensor(x), masks, train=False)
    _close(y_t, y_j, atol={"fp32": 1e-4, "bf16": 5e-2}[dtype])
    gen = torch.Generator().manual_seed(0)
    y_a = tpix.make_translator(ts.g)(torch.tensor(x), gen)
    y_b = ts.g(torch.tensor(x), ts.g.draw_masks(1, torch.Generator().manual_seed(0)),
               train=False)
    assert torch.equal(y_a, y_b.detach())


def test_load_jax_state_after_one_step(stepped):
    """Every leaf of the stepped reference state lands in a fresh port state
    as it is: G/D parameters, both BN ``batch_stats``, both Adam states."""
    js, _, _, _, _ = stepped
    st = _port_state(None, js)
    assert st.step == 1 and st.ema_params is None
    for net in ("g", "d"):
        module, opt = getattr(st, net), getattr(st, f"{net}_opt")
        want = convert.module_tensors(getattr(js, f"{net}_params"), getattr(js, f"{net}_state"))
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
        count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
        mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
        for name, p in module.named_parameters():
            assert int(opt.state[p]["step"]) == int(count) == 1
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu[name])
            np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), nu[name])


def test_draw_masks_keep_rate_and_seed():
    tg = tpix.UNetGenerator(32, 4)
    a = tg.draw_masks(64, torch.Generator().manual_seed(0))
    b = tg.draw_masks(64, torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in a] == tg.mask_shapes(64) == [
        (64, 2, 2, 32), (64, 4, 4, 16), (64, 8, 8, 8)]
    assert all(m.dtype == torch.bool and torch.equal(m, n) for m, n in zip(a, b))
    assert abs(float(torch.cat([m.reshape(-1) for m in a]).float().mean()) - 0.5) < 0.01
    assert tpix.UNetGenerator(8, 4).mask_shapes(1) == [(1, 2, 2, 8), (1, 4, 4, 4)]
    with pytest.raises(ValueError, match="power-of-two"):
        tpix.UNetGenerator(48)
