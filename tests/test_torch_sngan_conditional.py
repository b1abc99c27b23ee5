"""The conditional CIFAR SNGAN (``train_sngan --num-classes 10``) of the port
against the JAX package's: conditional BN in G, the projection D with 12
spectral-norm weights (CIFAR's 11 and ``proj_embed``, stored ``[128, 10]``).

Full-width G and D forwards at batch 2 with the JAX init's weights
converted, D's ``u`` advance over all 12 weights; one fused conditional step
at small widths (G (32, 32, 32), D (32,) * 4, batch 4, n_critic 2) from the
same converted state, the draws (z and classes) replayed from the
reference's key schedule as ``tests/test_torch_sngan_imagenet.py`` does; the
CLIs with ``--num-classes 10`` on the CPU.

float32 on the CPU. Forwards rtol 1e-4 / atol 1e-4; the fused step at
``tests/test_torch_step.py``'s tolerances (its docstring gives the
reasons).
"""

import copy
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import sngan as jsngan
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_sngan
from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
from gan_lib_tensorflow_tpu_torch.models import sngan as tsngan
from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC, Z = 10, 128


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(module, variables):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            convert.module_tensors(params, rest).items()}, strict=True)


def _init_both(jg, jd, seed):
    def init(r):
        rg, rd = jax.random.split(r)
        return (jg.init(rg, jnp.zeros((2, Z)), jnp.zeros((2,), jnp.int32), train=False),
                jd.init(rd, jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32)))
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(jax.random.PRNGKey(seed)))


def test_conditional_cifar_d_has_12_sn_weights():
    """CIFAR's 11 in registration order, then ``proj_embed`` as ``[128, 10]``
    (out 128, fan_in 10): 1,053,824 values. Its rows are 10 floats (40
    bytes), so the kernel copies that slab 4 bytes at a time; it takes one
    CTA in the small weights' shared cluster."""
    with torch.device("meta"):
        d = tsngan.cifar_discriminator(num_classes=NC)
        d11 = tsngan.cifar_discriminator()
    dims = [(m.weight[0].numel(), m.weight.shape[0]) for m in d.sn_layers]
    assert len(dims) == 12 and d.sn_layers[-1] is d.proj_embed
    assert dims[:11] == [(m.weight[0].numel(), m.weight.shape[0]) for m in d11.sn_layers]
    assert dims[-1] == (10, 128) and tuple(d.proj_embed.weight.shape) == (128, 10)
    assert sum(m * k for m, k in dims) == 1_053_824
    plan = pi.plan_power_iteration(dims)
    solo = [c for c in plan.ctas if c.kind == pi.SOLO]
    emb = [c for c in plan.ctas if c.weight == 11]
    assert len(plan.ctas) == 64 and len(solo) == 5 and not any(c.stream for c in plan.ctas)
    assert emb == [c for c in solo if c.weight == 11] and emb[0].width == 10
    assert (4 * emb[0].width) % 16 != 0  # not 16-byte rows: the 4-byte copy path


@pytest.fixture(scope="module")
def full_width():
    jg = jsngan.cifar_generator(num_classes=NC)
    jd = jsngan.cifar_discriminator(num_classes=NC)
    gv, dv = _init_both(jg, jd, 0)
    tg = tsngan.cifar_generator(num_classes=NC)
    td = tsngan.cifar_discriminator(num_classes=NC)
    _load(tg, gv)
    _load(td, dv)
    return jg, jd, gv, dv, tg, td


def test_full_width_generator_forward(full_width):
    jg, _, gv, _, tg, _ = full_width
    tg = copy.deepcopy(tg)  # the fixture's running stats stay where the JAX ones are
    z = np.random.default_rng(1).standard_normal((2, Z)).astype(np.float32)
    lab = np.array([0, 7], np.int32)
    y_j, new = jax.jit(lambda v, z_, l_: jg.apply(v, z_, l_, train=True,
                                                   mutable=["batch_stats"]))(gv, z, lab)
    y_t = tg(torch.tensor(z), torch.tensor(lab), train=True)
    assert tuple(y_t.shape) == (2, 32, 32, 3)
    _close(y_t.detach(), y_j)
    for name, arr in convert.to_torch_names(new["batch_stats"]).items():
        _close(dict(tg.named_buffers())[name], arr)


def test_full_width_discriminator_forward_and_u_advance(full_width):
    _, jd, _, dv, _, td = full_width
    td = copy.deepcopy(td)  # the fixture's u stays where the JAX one is
    x = np.tanh(np.random.default_rng(2).standard_normal((2, 32, 32, 3))).astype(np.float32)
    lab = np.array([4, 9], np.int32)
    logits_j, new_sn = jax.jit(lambda v, x_, l_: jd.apply(v, x_, l_, update_sn=True,
                                                           mutable=["sn"]))(dv, x, lab)
    logits_t = td(torch.tensor(x), torch.tensor(lab), update_sn=True)
    _close(logits_t.detach(), logits_j)
    ref = convert.to_torch_names(new_sn["sn"])
    assert len(ref) == 12 and "proj_embed.u" in ref
    buffers = dict(td.named_buffers())
    for name, arr in ref.items():
        _close(buffers[name].reshape(arr.shape), arr)


# ---- one fused conditional step at small widths


G_CH, D_CH, LR, N_CRITIC, B = (32, 32, 32), (32,) * 4, 2e-4, 2, 4


def _jax_draws(rng):
    """The critic fakes' z and classes and the G update's, for one step
    (``train/step.py:81-106``, ``models/sngan.py:164-171, 214-217``)."""
    prep = jax.random.fold_in(rng, 1)
    z_c, l_c = [], []
    for r in jax.random.split(prep, N_CRITIC):
        rz, rl = jax.random.split(r)
        l_c.append(np.asarray(jax.random.randint(rl, (B,), 0, NC)))
        z_c.append(np.asarray(jax.random.normal(rz, (B, Z))))
    r = rng
    for _ in range(N_CRITIC):
        r, _ = jax.random.split(r)
    _, sub, _ = jax.random.split(r, 3)
    rz, rl = jax.random.split(sub)
    return (np.stack(z_c), np.stack(l_c), np.asarray(jax.random.normal(rz, (B, Z))),
            np.asarray(jax.random.randint(rl, (B,), 0, NC)))


@pytest.fixture(scope="module")
def stepped():
    jg = jsngan.ResNetGenerator(channels=G_CH, bottom_ch=32, num_classes=NC)
    jd = jsngan.ResNetDiscriminator(channels=D_CH, num_classes=NC)
    spec = jsngan.make_sngan_spec(jg, jd, n_critic=N_CRITIC, ema_decay=0.9999)
    g_opt = optax.adam(LR, b1=0.0, b2=0.9)
    d_opt = optax.adam(LR, b1=0.0, b2=0.9)
    gv, dv = _init_both(jg, jd, 0)
    state0 = jtrain.create_state(jax.random.PRNGKey(0), lambda r: gv, lambda r: dv,
                                 g_opt, d_opt, ema_decay=0.9999)
    rng = np.random.default_rng(0)
    images = np.tanh(rng.standard_normal((N_CRITIC, B, 32, 32, 3))).astype(np.float32)
    labels = rng.integers(0, NC, (N_CRITIC, B)).astype(np.int32)
    z_c, l_c, z_g, l_g = _jax_draws(state0.rng)

    tg = tsngan.ResNetGenerator(channels=G_CH, bottom_ch=32, num_classes=NC)
    td = tsngan.ResNetDiscriminator(channels=D_CH, num_classes=NC)
    tspec = tsngan.make_sngan_spec(tg, td, n_critic=N_CRITIC, ema_decay=0.9999)
    tstate = create_state(tg, td, lr=LR, ema_decay=0.9999, device="cpu")
    convert.load_jax_state(tstate, jax.tree_util.tree_map(np.asarray, state0))

    state1, jm = jax.jit(jtrain.make_train_step(spec, g_opt, d_opt))(
        state0, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    tm = make_train_step(tspec)(
        tstate, {"image": torch.tensor(images), "label": torch.tensor(labels)},
        z_critic=torch.tensor(z_c), z_g=torch.tensor(z_g),
        labels_critic=torch.tensor(l_c), labels_g=torch.tensor(l_g))
    return jax.tree_util.tree_map(np.asarray, state1), jm, tstate, tm


_BN_CANCELLED = re.compile(r"block\d+\.conv(1|2|_skip)\.bias")


def test_step_metrics_u_and_bn_stats(stepped):
    js, jm, ts, tm = stepped
    assert set(jm) == set(tm) == {"d_loss", "d_real", "d_fake", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-4)
    for net, coll in (("d", js.d_state), ("g", js.g_state)):
        ref = convert.module_tensors({}, coll)
        buffers = dict(getattr(ts, net).named_buffers())
        assert set(ref) == set(buffers)
        for name, arr in ref.items():
            _close(buffers[name].numpy().reshape(arr.shape), arr, rtol=1e-3, atol=1e-5)
    assert sum(name.endswith(".u") for name in dict(ts.d.named_buffers())) == 12


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_adam_slots_and_params(net, stepped):
    js, _, ts, _ = stepped
    count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    updates = N_CRITIC if net == "d" else 1
    scale = max(np.abs(m).max() for m in mu.values())
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    n_far, n_all = 0, 0
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(count) == updates
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * LR * updates + 1e-6, name
        if net == "g" and _BN_CANCELLED.fullmatch(name):
            for a in (st["exp_avg"].numpy(), mu[name]):
                assert np.abs(a).max() <= 1e-4 * scale, name
            continue
        _close(st["exp_avg"].numpy() / scale, mu[name] / scale, rtol=1e-3, atol=1e-5)
        _close(st["exp_avg_sq"].numpy() / scale**2, nu[name] / scale**2,
               rtol=1e-3, atol=1e-5)
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= max(10, n_all // 1000), (n_far, n_all)


def test_step_ema(stepped):
    js, _, ts, _ = stepped
    ref = convert.to_torch_names(js.ema_params)
    assert set(ref) == set(ts.ema_params)
    for name, t in ts.ema_params.items():
        _close(t.numpy(), ref[name], rtol=1e-5, atol=1e-7)


# ---- the CLIs with --num-classes 10 on the CPU, full width


def test_train_sample_evaluate_num_classes_10(tmp_path, monkeypatch):
    out = tmp_path / "run"
    state = train_sngan.main(["--device", "cpu", "--data", "device-fake", "--steps", "1",
                              "--n-critic", "1", "--batch-size", "4", "--num-classes", "10",
                              "--sample-every", "1000", "--out-dir", str(out)])
    assert state.step == 1 and len(state.d.sn_layers) == 12
    assert state.g.num_classes == state.d.num_classes == NC
    with open(out / "log.jsonl") as f:
        (metrics,) = [json.loads(line) for line in f]
    assert all(np.isfinite(v) for v in metrics.values())
    ckpt = str(out / "ckpt")
    png = tmp_path / "cond.png"
    sample.main(["--model", "sngan", "--num-classes", "10", "--ckpt-dir", ckpt,
                 "--n", "10", "--out", str(png), "--device", "cpu"])
    with Image.open(png) as im:
        assert im.size == (3 * 32, 4 * 32)
    monkeypatch.setattr(evaluate, "InceptionV3Features", lambda params_npz=None, device="cpu":
                        FixedFeatureNet(image_size=32, feature_dim=16, device=device))
    res = evaluate.main(["--model", "sngan", "--num-classes", "10", "--ckpt-dir", ckpt,
                         "--n-samples", "20", "--batch-size", "10", "--n-real", "20",
                         "--data", "fake", "--device", "cpu"])
    assert res["step"] == 1 and res["samples_evaluated"] == 20 and np.isfinite(res["fid"])
    # an unconditional G cannot load the conditional checkpoint
    with pytest.raises(RuntimeError, match="Unexpected key"):
        sample.main(["--model", "sngan", "--ckpt-dir", ckpt, "--out", str(png),
                     "--device", "cpu"])
