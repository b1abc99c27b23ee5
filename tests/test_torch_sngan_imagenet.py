"""SNGAN-projection ImageNet-128 of the port against the JAX package's, at
``width_mul`` 1/64 (G channels (16, 8, 8, 8, 8), D (8, 8, 8, 8, 16, 16): the
reference's ``_scale_channels`` clamps to 8), 5 classes, 128x128 images.

float32 on the CPU on both sides. Forwards rtol 1e-4 / atol 1e-4 and D
gradients rtol 1e-4 / atol 1e-5, as ``tests/test_torch_sngan.py`` holds the
CIFAR nets; the fused step at ``tests/test_torch_step.py``'s tolerances (its
docstring gives the reasons), with JAX's draws (z and class labels) replayed
from its key schedule and handed to the port.
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

from gan_lib_tensorflow_tpu import train as jtrain
from gan_lib_tensorflow_tpu.models import sngan as jsngan
from gan_lib_tensorflow_tpu.ops import layers as jlayers
from gan_lib_tensorflow_tpu.ops import norms as jnorms
from gan_lib_tensorflow_tpu.train.state import EvalState
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
from gan_lib_tensorflow_tpu_torch.data.packed import finalize_store, write_store
from gan_lib_tensorflow_tpu_torch.models import sngan as tsngan
from gan_lib_tensorflow_tpu_torch.ops import ConditionalBatchNorm, Embedding
from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W, NC, Z = 1 / 64, 5, 128
G_LR, D_LR, N_CRITIC, B = 1e-4, 4e-4, 2, 2


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(module, variables):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            convert.module_tensors(params, rest).items()}, strict=True)


def _labels(n, seed=0):
    return np.random.default_rng(seed).integers(0, NC, n).astype(np.int32)


def _z(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, Z)).astype(np.float32)


@pytest.fixture(scope="module")
def g_pair():
    jg = jsngan.imagenet128_generator(num_classes=NC, width_mul=W)
    variables = jax.jit(lambda r: jg.init(r, jnp.zeros((2, Z)), jnp.zeros((2,), jnp.int32),
                                          train=False))(jax.random.PRNGKey(0))
    tg = tsngan.imagenet128_generator(num_classes=NC, width_mul=W)
    _load(tg, variables)
    return jg, tg, variables


@pytest.fixture(scope="module")
def d_pair():
    jd = jsngan.imagenet128_discriminator(num_classes=NC, width_mul=W)
    variables = jax.jit(lambda r: jd.init(r, jnp.zeros((2, 128, 128, 3)),
                                          jnp.zeros((2,), jnp.int32)))(jax.random.PRNGKey(1))
    td = tsngan.imagenet128_discriminator(num_classes=NC, width_mul=W)
    _load(td, variables)
    return jd, td, variables


@pytest.mark.parametrize("groups", [1, 2])
def test_conditional_batch_norm(groups):
    """Train mode (per-microbatch statistics with ``groups``, the reference's
    vmap over microbatches; running stats advance only with one group) and
    then eval mode on the running stats, with per-class gamma and beta."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 6, 6, 12)).astype(np.float32)
    lab = _labels(8, seed=4)
    jbn = jnorms.ConditionalBatchNorm(NC)
    variables = jbn.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(lab),
                         use_running_average=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = {k: {"embedding": rng.standard_normal((NC, 12)).astype(np.float32)}
              for k in ("gamma", "beta")}
    variables = {**variables, "params": params}
    tbn = ConditionalBatchNorm(NC, 12)
    _load(tbn, variables)

    parts = []
    for xs, ls in zip(np.split(x, groups), np.split(lab, groups)):
        y, new = jbn.apply(variables, jnp.asarray(xs), jnp.asarray(ls),
                           use_running_average=False, mutable=["batch_stats"])
        parts.append(np.asarray(y))
    y_t = tbn(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(lab),
              groups=groups, update_stats=groups == 1)
    _close(y_t.detach().permute(0, 2, 3, 1), np.concatenate(parts), atol=1e-5)
    if groups == 1:
        ref = convert.to_torch_names(new["batch_stats"])
        for name, t in tbn.named_buffers():
            _close(t, ref[name], atol=1e-6)
        y_j = jbn.apply({**variables, **new}, jnp.asarray(x), jnp.asarray(lab),
                        use_running_average=True)
        y_t = tbn(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(lab),
                  use_running_average=True)
        _close(y_t.detach().permute(0, 2, 3, 1), y_j, atol=1e-5)


def test_sn_embedding_sigma_and_u():
    """The SN table (stored ``[features, classes]``) looks up the rows the
    reference does, divided by the same sigma, and advances ``u`` the same
    way (plain path on the CPU)."""
    jemb = jlayers.Embedding(NC * 3, 24, spectral_norm=True)
    lab = _labels(6, seed=5) * 3
    variables = jemb.init(jax.random.PRNGKey(4), jnp.asarray(lab))
    out_j, new = jemb.apply(variables, jnp.asarray(lab), update_sn=True, mutable=["sn"])
    temb = Embedding(NC * 3, 24, spectral_norm=True)
    _load(temb, jax.tree_util.tree_map(np.asarray, variables))
    assert tuple(temb.weight.shape) == (24, NC * 3) and tuple(temb.u.shape) == (1, 24)
    out_t = temb(torch.tensor(lab), update_sn=True)
    _close(out_t.detach(), out_j, rtol=1e-5, atol=1e-6)
    _close(temb.u, new["sn"]["u"], rtol=1e-5, atol=1e-6)


def test_generator_forward_and_running_stats(g_pair):
    jg, tg, variables = g_pair
    z, lab = _z(), _labels(4)
    y_j, new_state = jg.apply(variables, jnp.asarray(z), jnp.asarray(lab), train=True,
                              mutable=["batch_stats"])
    y_t = tg(torch.tensor(z), torch.tensor(lab), train=True)
    assert tuple(y_t.shape) == (4, 128, 128, 3)
    _close(y_t.detach(), y_j)
    ref = convert.to_torch_names(new_state["batch_stats"])
    buffers = dict(tg.named_buffers())
    assert set(ref) == set(buffers)
    for name, arr in ref.items():
        _close(buffers[name], arr)


def test_discriminator_forward_and_u_advance(d_pair):
    jd, td, variables = d_pair
    x = np.tanh(np.random.default_rng(1).standard_normal((4, 128, 128, 3))).astype(np.float32)
    lab = _labels(4, seed=1)
    logits_j, new_sn = jd.apply(variables, jnp.asarray(x), jnp.asarray(lab),
                                update_sn=True, mutable=["sn"])
    td = copy.deepcopy(td)  # the fixture's u stays where the JAX one is
    logits_t = td(torch.tensor(x), torch.tensor(lab), update_sn=True)
    _close(logits_t.detach(), logits_j)
    ref = convert.to_torch_names(new_sn["sn"])
    buffers = dict(td.named_buffers())
    assert set(ref) == set(buffers) and len(ref) == 19
    for name, arr in ref.items():
        _close(buffers[name].reshape(arr.shape), arr)


def test_discriminator_gradients(d_pair):
    jd, td, variables = d_pair
    x = np.tanh(np.random.default_rng(2).standard_normal((4, 128, 128, 3))).astype(np.float32)
    lab = _labels(4, seed=2)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jd.apply(
        {**variables, "params": p}, jnp.asarray(x), jnp.asarray(lab)))))(variables["params"])
    td.zero_grad()
    td(torch.tensor(x), torch.tensor(lab)).sum().backward()
    ref = convert.to_torch_names(grads)
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-4, atol=1e-5)


def test_full_width_discriminator_has_19_sn_weights():
    """19 SN weights at the reference widths: block0 3, blocks 1-4 3 each,
    block5 (no downsample, so no skip) 2, dense_out and proj_embed; in
    registration order, the embedding last as ``[1024, 1000]`` (out = 1024)."""
    with torch.device("meta"):
        d = tsngan.imagenet128_discriminator()
    dims = [(m.weight[0].numel(), m.weight.shape[0]) for m in d.sn_layers]
    assert len(dims) == 19
    assert sum(m * k for m, k in dims) == 39_435_136
    assert dims[:3] == [(27, 64), (576, 64), (3, 64)]
    assert dims[-2:] == [(1024, 1), (1000, 1024)]
    assert dims[-4:-2] == [(9216, 1024)] * 2


def test_sampler_cycles_classes(g_pair):
    jg, tg, variables = g_pair
    _, trained = jg.apply(variables, jnp.asarray(_z(seed=3)), jnp.asarray(_labels(4, 3)),
                          train=True, mutable=["batch_stats"])
    ema = jax.tree_util.tree_map(lambda p: p * 0.9, variables["params"])
    jstate = EvalState(step=jnp.int32(0), g_params=variables["params"],
                       g_state=dict(trained), ema_params=ema, alpha=jnp.float32(1.0))
    rng = jax.random.PRNGKey(5)
    y_j = jsngan.make_sampler(jg)(jstate, rng, 7)
    z = np.asarray(jax.random.normal(rng, (7, Z)))
    _load(tg, {"params": variables["params"], **trained})
    state = type("S", (), {"ema_params": {k: torch.tensor(v) for k, v in
                                          convert.to_torch_names(ema).items()}})()
    y_t = tsngan.make_sampler(tg)(state, torch.tensor(z))
    _close(y_t, y_j)


# ---- one fused conditional step


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
    jg = jsngan.imagenet128_generator(num_classes=NC, width_mul=W)
    jd = jsngan.imagenet128_discriminator(num_classes=NC, width_mul=W)
    spec = jsngan.make_sngan_spec(jg, jd, n_critic=N_CRITIC, ema_decay=0.9999)
    g_opt = optax.adam(G_LR, b1=0.0, b2=0.9)
    d_opt = optax.adam(D_LR, b1=0.0, b2=0.9)
    state0 = jtrain.create_state(
        jax.random.PRNGKey(0),
        jax.jit(lambda r: jg.init(r, jnp.zeros((2, Z)), jnp.zeros((2,), jnp.int32),
                                  train=False)),
        jax.jit(lambda r: jd.init(r, jnp.zeros((2, 128, 128, 3)),
                                  jnp.zeros((2,), jnp.int32))),
        g_opt, d_opt, ema_decay=0.9999)
    rng = np.random.default_rng(0)
    images = np.tanh(rng.standard_normal((N_CRITIC, B, 128, 128, 3))).astype(np.float32)
    labels = rng.integers(0, NC, (N_CRITIC, B)).astype(np.int32)
    z_c, l_c, z_g, l_g = _jax_draws(state0.rng)

    tg = tsngan.imagenet128_generator(num_classes=NC, width_mul=W)
    td = tsngan.imagenet128_discriminator(num_classes=NC, width_mul=W)
    tspec = tsngan.make_sngan_spec(tg, td, n_critic=N_CRITIC, ema_decay=0.9999)
    tstate = create_state(tg, td, lr=G_LR, d_lr=D_LR, ema_decay=0.9999, device="cpu")
    convert.load_jax_state(tstate, jax.tree_util.tree_map(np.asarray, state0))

    state1, jmetrics = jax.jit(jtrain.make_train_step(spec, g_opt, d_opt))(
        state0, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    tmetrics = make_train_step(tspec)(
        tstate, {"image": torch.tensor(images), "label": torch.tensor(labels)},
        z_critic=torch.tensor(z_c), z_g=torch.tensor(z_g),
        labels_critic=torch.tensor(l_c), labels_g=torch.tensor(l_g))
    return jax.tree_util.tree_map(np.asarray, state1), jmetrics, tstate, tmetrics


_BN_CANCELLED = re.compile(r"block\d+\.conv(1|2|_skip)\.bias")


def _bn_cancelled(net, name):
    return net == "g" and _BN_CANCELLED.fullmatch(name) is not None


def test_step_metrics(stepped):
    _, jm, _, tm = stepped
    assert set(jm) == set(tm) == {"d_loss", "d_real", "d_fake", "g_loss"}
    for k in jm:
        _close(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_adam_slots_and_params(net, stepped):
    js, _, ts, _ = stepped
    count, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    module, opt = getattr(ts, net), getattr(ts, f"{net}_opt")
    updates = N_CRITIC if net == "d" else 1
    lr = D_LR if net == "d" else G_LR
    assert opt.param_groups[0]["lr"] == lr  # the TTUR rates, no schedule here
    scale = max(np.abs(m).max() for m in mu.values())
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    n_far, n_all = 0, 0
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == int(count) == updates
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * lr * updates + 1e-6, name
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


def test_step_sn_u_bn_stats_and_ema(stepped):
    js, _, ts, _ = stepped
    for net, coll in (("d", js.d_state), ("g", js.g_state)):
        ref = convert.module_tensors({}, coll)
        buffers = dict(getattr(ts, net).named_buffers())
        assert set(ref) == set(buffers)
        for name, arr in ref.items():
            _close(buffers[name].numpy().reshape(arr.shape), arr, rtol=1e-3, atol=1e-5)
    assert ts.step == int(js.step) == 1
    ref = convert.to_torch_names(js.ema_params)
    assert set(ref) == set(ts.ema_params)
    for name, t in ts.ema_params.items():
        _close(t.numpy(), ref[name], rtol=1e-5, atol=1e-7)


# ---- the CLI


def _store(tmp_path, n=12):
    out = str(tmp_path / "store")
    images, labels = write_store(out, n, 128, 128, 3, classes=[str(c) for c in range(NC)])
    rng = np.random.default_rng(6)
    images[:] = rng.integers(0, 256, images.shape, np.uint8)
    labels[:] = rng.integers(0, NC, n)
    finalize_store(out, images, labels)
    return out


@pytest.mark.parametrize("data", ["fake", "store"])
def test_cli_one_tiny_step_on_cpu(tmp_path, data):
    src = _store(tmp_path) if data == "store" else "fake"
    out = tmp_path / "run"
    state = train_sngan_imagenet.main([
        "--device", "cpu", "--data", src, "--steps", "1", "--n-critic", "2",
        "--batch-size", "2", "--num-classes", str(NC), "--width-mul", str(W),
        "--out-dir", str(out), "--sample-every", "1"])
    assert state.step == 1 and len(state.d.sn_layers) == 19
    assert [g["lr"] for g in state.d_opt.param_groups] == [0.0]  # decayed over 1 step
    with open(out / "log.jsonl") as f:
        (metrics,) = [json.loads(line) for line in f]
    assert all(np.isfinite(v) for v in metrics.values())
    assert (out / "samples" / "sample_000001.png").exists()


def test_cli_sample_and_evaluate_sngan_imagenet(tmp_path, monkeypatch, capsys):
    """Train one step from a packed store, then ``cli.sample`` (a 2x2 grid of
    128^2 tiles) and ``cli.evaluate --model sngan_imagenet`` with the real
    moments from the same store; ``FixedFeatureNet`` stands in for
    InceptionV3 to keep it CPU-cheap."""
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample
    from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
    from PIL import Image

    monkeypatch.setattr(evaluate, "InceptionV3Features", lambda params_npz=None, device="cpu":
                        FixedFeatureNet(image_size=128, feature_dim=8, device=device))
    store, out = _store(tmp_path, n=16), tmp_path / "run"
    width = ["--num-classes", str(NC), "--width-mul", str(W), "--device", "cpu"]
    train_sngan_imagenet.main(["--data", store, "--steps", "1", "--n-critic", "1",
                               "--batch-size", "4", "--out-dir", str(out)] + width)
    png = tmp_path / "grid.png"
    sample.main(["--model", "sngan_imagenet", "--ckpt-dir", str(out / "ckpt"),
                 "--out", str(png), "--n", "4"] + width)
    with Image.open(png) as im:
        assert im.size == (2 * 128, 2 * 128)
    res = evaluate.main(["--model", "sngan_imagenet", "--ckpt-dir", str(out / "ckpt"),
                         "--n-samples", "12", "--batch-size", "4", "--n-real", "8",
                         "--data", store] + width)
    assert res["step"] == 1 and res["samples_evaluated"] == 12
    assert res["real_source"] == store and np.isfinite(res["fid"])
    with pytest.raises(ValueError, match="32\\^2"):
        evaluate.main(["--model", "imagenet", "--ckpt-dir", str(out / "ckpt"),
                       "--data", "cifar10"] + width)
