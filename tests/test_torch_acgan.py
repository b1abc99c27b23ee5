"""ACGAN CIFAR-10 of the port against the JAX package's.

Forwards at full width (G base 384, z 110; D base 64, dropout 0.3), batch 2,
with the JAX init's weights converted; one fused step at small width (G base
32, z 16; D base 8; batch 4) from the same converted state, in both
adversarial modes; then the CLIs on the CPU: a faulted ``train_acgan`` run
resumed bit-equal to an uninterrupted one, ``sample --model acgan`` and
``evaluate --model acgan``.

Torch cannot draw JAX's numbers, so the step's draws are replayed from its
key schedule (``train/step.py:89-106``, ``models/acgan.py:96-128``) and handed
in: z and the fakes' classes, and D's dropout keep masks, which
``nn.intercept_methods`` reads back from each ``nn.Dropout`` call under the
step's own ``rng_do`` / ``rng_do2`` as ``out != 0``.

Tolerances, float32 on the CPU: forwards rtol 1e-4 / atol 1e-4, gradients
rtol 1e-4 / atol 1e-5 of each tensor's largest entry (a head's gradient is
a feature, summed over the batch, and carries the features' absolute
rounding); the fused step at ``tests/test_torch_step.py``'s (its
docstring gives the reasons): rtol 1e-3 / atol 1e-5 on slots and BN stats,
parameters within 2 * lr per update and 1e-6 on all but a handful. G's
``deconv0``/``deconv1`` biases feed a BatchNorm, which removes them: their
gradients are rounding noise in both packages and are held as the SNGAN
test holds G's block biases.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from PIL import Image

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import acgan as jacgan
from gan_lib_tensorflow_tpu.train.state import EvalState
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_acgan
from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
from gan_lib_tensorflow_tpu_torch.models import acgan as tacgan
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step, to_checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC = 10


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(module, variables):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            convert.module_tensors(params, rest).items()}, strict=True)


def _images(n, seed=0):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, 32, 32, 3))).astype(np.float32)


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


def _dropout_masks(jd, params, x, rngs):
    """D's six keep masks (NHWC bool) under each key of ``rngs``, read back
    from flax's Dropout calls in one jitted call; the masks depend on the
    key and the shapes only."""
    def apply(p, xx, keys):
        return [jd.apply({"params": p}, xx, train=True, rngs={"dropout": k})
                for k in keys]

    _, masks = jax.jit(_recording(apply))(params, jnp.asarray(x), list(rngs))
    assert len(masks) == 6 * len(rngs)
    return [[np.asarray(m) for m in masks[6 * i:6 * i + 6]] for i in range(len(rngs))]


def _init_both(jg, jd, z_dim, seed):
    """G's and D's variables from one jitted init."""
    def init(r):
        rg, rd = jax.random.split(r)
        return (jg.init(rg, jnp.zeros((2, z_dim)), jnp.zeros((2,), jnp.int32), train=False),
                jd.init(rd, jnp.zeros((2, 32, 32, 3)), train=False))
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(jax.random.PRNGKey(seed)))


# ---- forwards at full width


@pytest.fixture(scope="module")
def full_width():
    jg, jd = jacgan.ACGANGenerator(), jacgan.ACGANDiscriminator()
    return (jg, jd) + _init_both(jg, jd, 110, 0)


@pytest.fixture(scope="module")
def g_pair(full_width):
    jg, _, variables, _ = full_width
    tg = tacgan.ACGANGenerator()
    _load(tg, variables)
    return jg, tg, variables


@pytest.fixture(scope="module")
def d_pair(full_width):
    _, jd, _, variables = full_width
    td = tacgan.ACGANDiscriminator()
    _load(td, variables)
    return jd, td, variables


def test_full_width_shapes_and_parameter_counts(g_pair, d_pair):
    _, tg, gv = g_pair
    _, td, dv = d_pair
    count = lambda tree: sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in tg.parameters()) == count(gv["params"])
    assert sum(p.numel() for p in td.parameters()) == count(dv["params"])
    assert tuple(tg.deconv0.weight.shape) == (192, 384, 5, 5)
    assert tuple(td.head_cls.weight.shape) == (NC, 4096)
    assert td.mask_shapes(3) == [(3, 16, 16, 64), (3, 16, 16, 64), (3, 8, 8, 128),
                                 (3, 8, 8, 128), (3, 4, 4, 256), (3, 4, 4, 256)]


def test_generator_forward_train_and_eval(g_pair):
    jg, tg, variables = g_pair
    tg = copy.deepcopy(tg)  # the fixture's running stats stay where the JAX ones are
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 110)).astype(np.float32)
    lab = np.array([3, 9], np.int32)
    y_j, new = jg.apply(variables, jnp.asarray(z), jnp.asarray(lab), train=True,
                        mutable=["batch_stats"])
    y_t = tg(torch.tensor(z), torch.tensor(lab), train=True)
    assert tuple(y_t.shape) == (2, 32, 32, 3)
    _close(y_t.detach(), y_j)
    ref = convert.to_torch_names(new["batch_stats"])
    buffers = dict(tg.named_buffers())
    assert set(ref) == set(buffers) == {f"bn{i}.{s}" for i in range(2)
                                        for s in ("running_mean", "running_var")}
    for name, arr in ref.items():
        _close(buffers[name], arr, atol=1e-5)
    y_j = jg.apply({**variables, **jax.tree_util.tree_map(np.asarray, new)},
                   jnp.asarray(z), jnp.asarray(lab), train=False)
    with torch.no_grad():
        y_t = tg(torch.tensor(z), torch.tensor(lab), train=False)
    _close(y_t, y_j)


def test_discriminator_forward_and_gradients_with_reference_masks(d_pair):
    jd, td, variables = d_pair
    x = _images(2, seed=3)
    r = np.random.default_rng(5).standard_normal((2, NC)).astype(np.float32)

    def loss_j(params):
        a, c = jd.apply({"params": params}, jnp.asarray(x), train=True,
                        rngs={"dropout": jax.random.PRNGKey(4)})
        return jnp.sum(a) + jnp.sum(c * r), (a, c)

    ((_, (adv_j, cls_j)), grads), masks = jax.jit(_recording(
        jax.value_and_grad(loss_j, has_aux=True)))(variables["params"])
    assert len(masks) == 6 and 0.65 < np.mean([np.mean(m) for m in masks]) < 0.75
    td.zero_grad()
    adv_t, cls_t = td(torch.tensor(x), [torch.tensor(np.asarray(m)) for m in masks])
    _close(adv_t.detach(), adv_j)
    _close(cls_t.detach(), cls_j)
    with torch.no_grad():  # without masks: the reference's train=False
        adv_e, _ = td(torch.tensor(x))
    _close(adv_e, jd.apply(variables, jnp.asarray(x), train=False)[0])

    grads = convert.to_torch_names(grads)
    (adv_t.sum() + (cls_t * torch.tensor(r)).sum()).backward()
    for name, p in td.named_parameters():
        scale = np.abs(grads[name]).max()
        _close(p.grad.numpy() / scale, grads[name] / scale, rtol=1e-4, atol=1e-5)


def test_draw_masks_keep_rate_and_seed():
    td = tacgan.ACGANDiscriminator(base_ch=8)
    a = td.draw_masks(16, torch.Generator().manual_seed(0))
    b = td.draw_masks(16, torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in a] == td.mask_shapes(16)
    assert all(m.dtype == torch.bool and torch.equal(m, n) for m, n in zip(a, b))
    keep = torch.cat([m.reshape(-1) for m in a]).float().mean()
    assert abs(float(keep) - 0.7) < 0.01


def test_sampler_cycles_classes_with_own_parameters(g_pair):
    jg, tg, variables = g_pair
    jstate = EvalState(step=jnp.int32(0), g_params=variables["params"],
                                    g_state={"batch_stats": variables["batch_stats"]},
                                    ema_params=None, alpha=jnp.float32(1.0))
    rng = jax.random.PRNGKey(6)
    y_j = jacgan.make_sampler(jg)(jstate, rng, 12)
    z = np.asarray(jax.random.normal(rng, (12, 110)))
    state = type("S", (), {"ema_params": None})()
    _close(tacgan.make_sampler(tg)(state, torch.tensor(z)), y_j)


# ---- one fused step at small width


B, ZS, LR = 4, 16, 2e-4


def _draws(jd, d_params, rng, images):
    """z, classes and dropout masks of the critic substep and of the G
    update for one step of the reference's schedule."""
    rng, sub = jax.random.split(rng)
    rz, rl, rdo, rdo2 = jax.random.split(sub, 4)
    l_c = np.asarray(jax.random.randint(rl, (B,), 0, NC))
    z_c = np.asarray(jax.random.normal(rz, (B, ZS)))
    _, sub, _ = jax.random.split(rng, 3)
    rz_g, rl_g, rdo_g = jax.random.split(sub, 3)
    l_g = np.asarray(jax.random.randint(rl_g, (B,), 0, NC))
    z_g = np.asarray(jax.random.normal(rz_g, (B, ZS)))
    m_real, m_fake, m_g = _dropout_masks(jd, d_params, images, [rdo, rdo2, rdo_g])
    masks_c = [torch.tensor(np.concatenate([a, b])) for a, b in zip(m_real, m_fake)]
    return (z_c[None], l_c[None], [masks_c], z_g, l_g,
            [torch.tensor(m) for m in m_g])


@pytest.fixture(scope="module")
def step_start():
    """The small networks' variables, one batch and the step's draws:
    shared by both adversarial modes."""
    jg = jacgan.ACGANGenerator(z_dim=ZS, base_ch=32)
    jd = jacgan.ACGANDiscriminator(base_ch=8)
    gv, dv = _init_both(jg, jd, ZS, 0)
    rng = jax.random.PRNGKey(1)
    step_rng = jax.random.split(rng, 3)[2]  # the state's rng (train/state.py:71)
    images = _images(B, seed=8)
    labels = np.random.default_rng(7).integers(0, NC, (1, B)).astype(np.int32)
    return jg, jd, gv, dv, rng, images, labels, _draws(jd, dv["params"], step_rng, images)


@pytest.fixture(scope="module", params=["bce", "hinge"])
def stepped(request, step_start):
    mode = request.param
    jg, jd, gv, dv, rng, images, labels, draws = step_start
    z_c, l_c, m_c, z_g, l_g, m_g = draws
    spec = jacgan.make_acgan_spec(jg, jd, adversarial=mode, aux_weight=0.7)
    g_opt = optax.adam(LR, b1=0.5, b2=0.999)
    d_opt = optax.adam(LR, b1=0.5, b2=0.999)
    state0 = jtrain.create_state(rng, lambda r: gv, lambda r: dv, g_opt, d_opt)

    tg = tacgan.ACGANGenerator(z_dim=ZS, base_ch=32)
    td = tacgan.ACGANDiscriminator(base_ch=8)
    tspec = tacgan.make_acgan_spec(tg, td, adversarial=mode, aux_weight=0.7)
    tstate = create_state(tg, td, lr=LR, beta1=0.5, beta2=0.999, device="cpu")
    convert.load_jax_state(tstate, jax.tree_util.tree_map(np.asarray, state0))
    assert tstate.ema_params is None

    state1, jm = jax.jit(jtrain.make_train_step(spec, g_opt, d_opt))(
        state0, {"image": jnp.asarray(images[None]), "label": jnp.asarray(labels)})
    tm = make_train_step(tspec)(
        tstate, {"image": torch.tensor(images[None]), "label": torch.tensor(labels)},
        z_critic=torch.tensor(z_c), z_g=torch.tensor(z_g),
        labels_critic=torch.tensor(l_c), labels_g=torch.tensor(l_g),
        masks_critic=m_c, masks_g=m_g)
    return jax.tree_util.tree_map(np.asarray, state1), jm, tstate, tm


def test_step_metrics(stepped):
    _, jm, _, tm = stepped
    assert set(jm) == set(tm) == {"d_loss", "d_adv", "d_aux", "cls_acc", "g_adv",
                                  "g_aux", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-4)


def _bn_cancelled(net, name):
    return net == "g" and name in ("deconv0.bias", "deconv1.bias")


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_adam_slots_and_params(net, stepped):
    js, _, ts, _ = stepped
    count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    scale = max(np.abs(m).max() for m in mu.values())
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    n_far, n_all = 0, 0
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(count) == 1
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * LR + 1e-6, name
        if _bn_cancelled(net, name):
            for a in (st["exp_avg"].numpy(), mu[name]):
                assert np.abs(a).max() <= 1e-4 * scale, name
            continue
        _close(st["exp_avg"].numpy() / scale, mu[name] / scale, rtol=1e-3, atol=1e-5)
        _close(st["exp_avg_sq"].numpy() / scale**2, nu[name] / scale**2,
               rtol=1e-3, atol=1e-5)
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= max(10, n_all // 1000), (n_far, n_all)


def test_step_g_running_stats_advance_once(stepped):
    """The G loss advances G's BN running stats once; the D loss's fakes
    leave them (the reference discards that forward's batch_stats)."""
    js, _, ts, _ = stepped
    ref = convert.module_tensors({}, js.g_state)
    buffers = dict(ts.g.named_buffers())
    assert set(ref) == set(buffers)
    for name, arr in ref.items():
        _close(buffers[name].numpy(), arr, rtol=1e-3, atol=1e-5)
    assert ts.step == int(js.step) == 1 and dict(ts.d.named_buffers()) == {}


# ---- the CLIs on the CPU


CPU_ARGS = ["--device", "cpu", "--data", "device-fake", "--batch-size", "4",
            "--compute-dtype", "fp32", "--log-every", "1", "--sample-every", "1000"]


def _flat(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat(v, path + (i,))
    else:
        yield path, obj


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A faulted 4-step run resumed from its step-2 checkpoint, and an
    uninterrupted one, full width at batch 4."""
    tmp = tmp_path_factory.mktemp("acgan")
    run, straight = str(tmp / "run"), str(tmp / "straight")
    args = CPU_ARGS + ["--steps", "4", "--ckpt-every", "2"]
    with pytest.raises(RuntimeError, match="fault injected at step 3"):
        train_acgan.main(args + ["--out-dir", run, "--fault-inject-step", "3"])
    resumed = train_acgan.main(args + ["--out-dir", run])
    whole = train_acgan.main(args + ["--out-dir", straight])
    return run, resumed, whole


def test_fault_then_resume_is_bit_equal(runs):
    """Every leaf: G (BN stats), D, both Adams, both noise generators (the
    dropout masks' source), step."""
    _, resumed, whole = runs
    assert resumed.step == whole.step == 4
    got, want = dict(_flat(to_checkpoint(resumed))), dict(_flat(to_checkpoint(whole)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_train_log_and_grid(runs):
    run, _, _ = runs
    with open(os.path.join(run, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2, 3, 4]  # 1-3 before the fault
    assert set(log[-1]) == {"step", "d_loss", "d_adv", "d_aux", "cls_acc", "g_adv",
                            "g_aux", "g_loss", "sec_per_step"}
    assert all(np.isfinite(v) for r in log for v in r.values())
    with Image.open(os.path.join(run, "samples", "sample_000004.png")) as im:
        assert im.size == (10 * 32, 10 * 32)  # 100 samples, 10 rows


def test_sample_and_evaluate_clis(runs, tmp_path, monkeypatch, capsys):
    run, _, _ = runs
    png = tmp_path / "acgan.png"
    sample.main(["--model", "acgan", "--ckpt-dir", os.path.join(run, "ckpt"), "--n", "20",
                 "--out", str(png), "--device", "cpu"])
    with Image.open(png) as im:
        assert im.size == (4 * 32, 5 * 32)  # 5 rows of 4
    monkeypatch.setattr(evaluate, "InceptionV3Features", lambda params_npz=None, device="cpu":
                        FixedFeatureNet(image_size=32, feature_dim=16, device=device))
    out = evaluate.main(["--model", "acgan", "--ckpt-dir", os.path.join(run, "ckpt"),
                         "--n-samples", "40", "--batch-size", "20", "--n-real", "40",
                         "--data", "fake", "--device", "cpu"])
    assert out["step"] == 4 and out["samples_evaluated"] == 40
    assert np.isfinite(out["fid"]) and out["inception_score"] >= 1.0


def test_train_acgan_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks the CUDA-less policy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_acgan.main(["--data", "fake", "--steps", "1"])
