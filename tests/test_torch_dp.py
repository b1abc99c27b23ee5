"""Multi-rank SNGAN steps of the port against the JAX package's sharded
steps, and the global-batch statistics they rest on.

The ranks are CPU processes in a gloo group (``dryrun.launch``: a
``FileStore`` in ``tmp_path``, one thread each, a time limit per spawn);
they import torch only (this module imports JAX inside the tests, never at
the top) and write ``.npz`` files that the test compares. The JAX reference
runs on the conftest's 8 virtual CPU devices.

- DP 2: one fused SNGAN step (G (32, 32, 32), D (32, 32, 32, 32), global
  batch 4, n_critic 2, Adam, EMA 0.9999) against JAX's ``jit_train_step`` on
  a ``('data',)`` mesh of 2. Adam is not linear in the gradient, so the
  tolerances are ``tests/test_torch_step.py``'s (it explains them): metrics
  atol 1e-4, slots rtol 1e-3 of the net's largest entry, parameters within
  2 * lr per update and all but a handful of elements within 1e-6.
- DP x TP 2 x 2: the same step with SGD (linear in the gradient, as
  ``tests/test_tensor_parallel.py:27-31`` chooses it) against JAX's mesh
  (2, 2) with ``train_state_shardings`` at ``min_features`` 32, so the wide
  leaves do shard: metrics rtol 1e-4 / atol 1e-5, parameters rtol 1e-4 /
  atol 1e-6.
- Batch norm at one image per rank and PGGAN's minibatch stddev against the
  one-rank port (itself held to JAX elsewhere): forward and gradients rtol
  1e-5 / atol 1e-6 (only the order of the sums differs).
"""

import os
import re

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.dryrun import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
LR, N_CRITIC, B, Z = 2e-4, 2, 4, 128
G_CH, D_CH = (32, 32, 32), (32, 32, 32, 32)
SGD_LR = 0.01


def _run(target, world, workdir, **kwargs):
    launch(f"test_torch_dp:{target}", world, str(workdir),
           {"workdir": str(workdir), **kwargs}, timeout=120, pythonpath=TESTS)


def _port_models():
    from gan_lib_tensorflow_tpu_torch.models import sngan
    g = sngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    d = sngan.ResNetDiscriminator(channels=D_CH)
    return g, d


# ---------------------------------------------------------------- rank code


def _sngan_rank(workdir, tp, optim, ema):
    """One fused step on this rank's rows; rank 0 writes the gathered state."""
    import torch.distributed as dist

    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh, shard_batch
    from gan_lib_tensorflow_tpu_torch.train import (create_state, load_checkpoint,
                                                    make_train_step, to_checkpoint)

    world = dist.get_world_size()
    mesh = (create_mesh((world // tp, tp), ("data", "model"), device="cpu") if tp > 1
            else create_mesh(device="cpu"))
    g, d = _port_models()
    spec = sngan.make_sngan_spec(g, d, n_critic=N_CRITIC, ema_decay=ema)
    state = create_state(g, d, lr=LR, ema_decay=ema, device="cpu", mesh=mesh,
                         min_features=32)
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    if optim == "sgd":
        for net in ("g", "d"):
            getattr(state, net).load_state_dict(init[net])
            shards = getattr(state, f"{net}_shards")
            if shards is not None:
                shards.load_full()
            held = shards.opt_params() if shards else list(getattr(state, net).parameters())
            setattr(state, f"{net}_opt", torch.optim.SGD(held, lr=SGD_LR))
    else:
        load_checkpoint(state, init)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    batch = shard_batch({"image": torch.from_numpy(inp["images"])}, mesh, 1)
    metrics = make_train_step(spec)(state, batch, z_critic=torch.from_numpy(inp["z_c"]),
                                    z_g=torch.from_numpy(inp["z_g"]))
    full = to_checkpoint(state)
    held = {f"held/{k}": v.detach().numpy() for k, v in
            (state.d_shards.masters.items() if state.d_shards else [])}
    np.savez(os.path.join(workdir, f"held{mesh.rank}.npz"), **held)
    if mesh.rank == 0:
        out = {f"m/{k}": float(v) for k, v in metrics.items()}
        for net in ("g", "d"):
            out.update({f"{net}/{k}": v.numpy() for k, v in full[net].items()})
            if optim == "adam":
                names = [n for n, _ in getattr(state, net).named_parameters()]
                for idx, st in full[f"{net}_opt"]["state"].items():
                    out[f"{net}_mu/{names[idx]}"] = st["exp_avg"].numpy()
                    out[f"{net}_nu/{names[idx]}"] = st["exp_avg_sq"].numpy()
        if full["ema_params"] is not None:
            out.update({f"ema/{k}": v.numpy() for k, v in full["ema_params"].items()})
        np.savez(os.path.join(workdir, "out.npz"), **out)


def _bn_rank(workdir):
    """Global BN (and conditional BN) at one image per rank: output, grads
    of x and of the affine parameters, running stats."""
    import torch.distributed as dist

    from gan_lib_tensorflow_tpu_torch.ops import BatchNorm, ConditionalBatchNorm
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh, sharded_step

    mesh = create_mesh(device="cpu")
    r = mesh.rank
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    x = torch.from_numpy(inp["x"][r:r + 1]).requires_grad_(True)
    labels = torch.from_numpy(inp["labels"][r:r + 1])
    bn = BatchNorm(8)
    cbn = ConditionalBatchNorm(5, 8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        cbn.gamma.weight.copy_(torch.from_numpy(inp["gamma"]))
    with sharded_step(mesh):
        y = bn(x)
        yc = cbn(x, labels)
        loss = (y * torch.from_numpy(inp["dy"][r:r + 1])).sum() + (yc ** 2).sum()
        gx, gw, gg = torch.autograd.grad(loss, (x, bn.weight, cbn.gamma.weight))
    for t in (gw, gg):  # parameter gradients: the sum over ranks
        dist.all_reduce(t)
    np.savez(os.path.join(workdir, f"bn{r}.npz"), y=y.detach().numpy(),
             yc=yc.detach().numpy(), gx=gx.numpy(), gw=gw.numpy(), gg=gg.numpy(),
             rm=bn.running_mean.numpy(), rv=bn.running_var.numpy(),
             crm=cbn.bn.running_mean.numpy())


def _mbstd_rank(workdir):
    """Minibatch stddev of the global batch from this rank's rows, with the
    gradient of a penalty through it (a double backward)."""
    import torch.distributed as dist

    from gan_lib_tensorflow_tpu_torch.ops import minibatch_stddev
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh, shard_batch, sharded_step

    mesh = create_mesh(device="cpu")
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    x = shard_batch(torch.from_numpy(inp["x"]), mesh).clone().requires_grad_(True)
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    with sharded_step(mesh):
        y, gx, gw = _mbstd_penalty(minibatch_stddev, x, w)
    dist.all_reduce(gw)
    np.savez(os.path.join(workdir, f"mb{mesh.rank}.npz"), y=y.detach().numpy(),
             gx=gx.numpy(), gw=gw.numpy())


def _mbstd_penalty(fn, x, w):
    """y = fn(x * w); a penalty on d(sum y^2)/dx; its gradients in x and w."""
    y = fn(x * w)
    g, = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
    gx, gw = torch.autograd.grad((g ** 2).sum() + y.sum(), (x, w))
    return y, gx, gw


# ---------------------------------------------------------------- JAX side


def _jax_sngan(optim, ema):
    import jax
    import jax.numpy as jnp
    import optax

    from gan_lib_tensorflow_tpu import train as jtrain
    from gan_lib_tensorflow_tpu.models import sngan as jsngan

    jg = jsngan.ResNetGenerator(channels=G_CH, bottom_ch=32)
    jd = jsngan.ResNetDiscriminator(channels=D_CH)
    spec = jsngan.make_sngan_spec(jg, jd, n_critic=N_CRITIC, ema_decay=ema)
    opt = optax.adam(LR, b1=0.0, b2=0.9) if optim == "adam" else optax.sgd(SGD_LR)
    state0 = jtrain.create_state(
        jax.random.PRNGKey(0), lambda r: jg.init(r, jnp.zeros((2, Z)), train=False),
        lambda r: jd.init(r, jnp.zeros((2, 32, 32, 3))), opt, opt, ema_decay=ema)
    return spec, opt, state0


def _jax_draws(rng):
    """The z of the critic fakes and of the G update for one step
    (``tests/test_torch_step.py``'s replay of the key schedule)."""
    import jax
    prep = jax.random.fold_in(rng, 1)
    z_c = [jax.random.normal(jax.random.split(r)[0], (B, Z))
           for r in jax.random.split(prep, N_CRITIC)]
    r = rng
    for _ in range(N_CRITIC):
        r, _ = jax.random.split(r)
    _, sub, _ = jax.random.split(r, 3)
    z_g = jax.random.normal(jax.random.split(sub)[0], (B, Z))
    return np.stack([np.asarray(z) for z in z_c]), np.asarray(z_g)


def _stepped(tmp, mesh_shape, optim, ema):
    """Run JAX's sharded step and the port's on the same ranks' layout."""
    import jax

    from gan_lib_tensorflow_tpu import train as jtrain
    from gan_lib_tensorflow_tpu.parallel import (create_mesh, shard_batch,
                                                 train_state_shardings)
    from gan_lib_tensorflow_tpu_torch import convert
    from gan_lib_tensorflow_tpu_torch.train import create_state, to_checkpoint

    spec, opt, state0 = _jax_sngan(optim, ema)
    host0 = jax.tree_util.tree_map(np.asarray, state0)
    images = np.tanh(np.random.default_rng(0).standard_normal(
        (N_CRITIC, B, 32, 32, 3))).astype(np.float32)
    z_c, z_g = _jax_draws(state0.rng)
    np.savez(tmp / "inputs.npz", images=images, z_c=z_c, z_g=z_g)
    if optim == "adam":
        g, d = _port_models()
        tstate = create_state(g, d, lr=LR, ema_decay=ema, device="cpu")
        convert.load_jax_state(tstate, host0)
        torch.save(to_checkpoint(tstate), tmp / "init.pt")
    else:
        torch.save({net: {k: torch.as_tensor(v) for k, v in convert.module_tensors(
            getattr(host0, f"{net}_params"), getattr(host0, f"{net}_state")).items()}
            for net in ("g", "d")}, tmp / "init.pt")

    names = ("data",) if len(mesh_shape) == 1 else ("data", "model")
    mesh = create_mesh(mesh_shape, names, devices=jax.devices()[:int(np.prod(mesh_shape))])
    layout = (train_state_shardings(state0, mesh, min_features=32) if len(mesh_shape) > 1
              else None)
    step = jtrain.jit_train_step(spec, opt, opt, mesh=mesh, state_shardings=layout)
    state1, jm = step(state0, shard_batch({"image": images}, mesh, leading_stack_dims=1))
    _run("_sngan_rank", int(np.prod(mesh_shape)), tmp, tp=mesh_shape[-1] if layout else 1,
         optim=optim, ema=ema)
    return (jax.tree_util.tree_map(np.asarray, state1), {k: float(v) for k, v in jm.items()},
            dict(np.load(tmp / "out.npz")), mesh_shape, layout)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _stepped(tmp_path_factory.mktemp("dp2"), (2,), "adam", 0.9999)


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dptp")
    return (*_stepped(tmp, (2, 2), "sgd", 0.0), tmp)


_BN_CANCELLED = re.compile(r"block\d+\.conv(1|2|_skip)\.bias")


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_dp2_metrics(dp2):
    _, jm, out, _, _ = dp2
    assert {k[2:] for k in out if k.startswith("m/")} == set(jm)
    for k, v in jm.items():
        _close(out[f"m/{k}"], v, 1e-3, 1e-4, k)


@pytest.mark.parametrize("net", ["g", "d"])
def test_dp2_params(net, dp2):
    from gan_lib_tensorflow_tpu_torch import convert
    js, _, out, _, _ = dp2
    ref = convert.to_torch_names(getattr(js, f"{net}_params"))
    updates = N_CRITIC if net == "d" else 1
    n_far = n_all = 0
    for name, arr in ref.items():
        diff = np.abs(out[f"{net}/{name}"] - arr)
        assert diff.max() <= 2 * LR * updates + 1e-6, name
        if net == "g" and _BN_CANCELLED.fullmatch(name):
            continue
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= max(10, n_all // 1000), (n_far, n_all)


@pytest.mark.parametrize("net", ["g", "d"])
def test_dp2_adam_slots(net, dp2):
    from gan_lib_tensorflow_tpu_torch import convert
    js, _, out, _, _ = dp2
    _, mu, nu = convert._adam_fields(getattr(js, f"{net}_opt"))
    mu, nu = convert.to_torch_names(mu), convert.to_torch_names(nu)
    scale = max(np.abs(m).max() for m in mu.values())
    for name in mu:
        if net == "g" and _BN_CANCELLED.fullmatch(name):
            assert np.abs(out[f"{net}_mu/{name}"]).max() <= 1e-4 * scale, name
            continue
        _close(out[f"{net}_mu/{name}"] / scale, mu[name] / scale, 1e-3, 1e-5, name)
        _close(out[f"{net}_nu/{name}"] / scale**2, nu[name] / scale**2, 1e-3, 1e-5, name)


def test_dp2_buffers_and_ema(dp2):
    """SN u and the BN running stats (global statistics, equal on every
    rank), and the EMA."""
    from gan_lib_tensorflow_tpu_torch import convert
    js, _, out, _, _ = dp2
    for net, coll in (("d", js.d_state), ("g", js.g_state)):
        for name, arr in convert.module_tensors({}, coll).items():
            _close(out[f"{net}/{name}"].reshape(arr.shape), arr, 1e-3, 1e-5, name)
    for name, arr in convert.to_torch_names(js.ema_params).items():
        _close(out[f"ema/{name}"], arr, 1e-5, 1e-7 + 2 * LR * (1 - 0.9999), name)


def test_dp_tp_metrics(dp_tp):
    _, jm, out, _, _, _ = dp_tp
    for k, v in jm.items():
        _close(out[f"m/{k}"], v, 1e-4, 1e-5, k)


@pytest.mark.parametrize("net", ["g", "d"])
def test_dp_tp_params(net, dp_tp):
    from gan_lib_tensorflow_tpu_torch import convert
    js, _, out, _, _, _ = dp_tp
    for name, arr in convert.to_torch_names(getattr(js, f"{net}_params")).items():
        _close(out[f"{net}/{name}"], arr, 1e-4, 1e-6, name)


def test_dp_tp_shards_match_the_jax_layout(dp_tp):
    """Each 'model' rank holds half of exactly the leaves JAX shards, and its
    half is its rows of the gathered parameter."""
    import jax
    from jax.sharding import NamedSharding

    from gan_lib_tensorflow_tpu_torch import convert
    js, _, out, _, layout, tmp = dp_tp
    specs = jax.tree_util.tree_map(lambda s: "model" in tuple(s.spec), layout.d_params,
                                   is_leaf=lambda x: isinstance(x, NamedSharding))
    sharded = {k for k, v in convert.to_torch_names(specs).items() if v}
    assert sharded
    for rank in range(4):
        held = dict(np.load(tmp / f"held{rank}.npz"))
        assert {k[5:] for k in held} == sharded
        j = rank % 2  # row-major (data, model)
        for name in sharded:
            full = out[f"d/{name}"]
            k = full.shape[0] // 2
            np.testing.assert_array_equal(held[f"held/{name}"], full[j * k:(j + 1) * k])


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    rng = np.random.default_rng(4)
    inp = dict(x=rng.standard_normal((2, 8, 4, 4)).astype(np.float32),
               dy=rng.standard_normal((2, 8, 4, 4)).astype(np.float32),
               w=rng.uniform(0.5, 1.5, 8).astype(np.float32),
               gamma=rng.uniform(0.5, 1.5, (8, 5)).astype(np.float32),
               labels=np.array([1, 3]))
    np.savez(tmp / "inputs.npz", **inp)
    _run("_bn_rank", 2, tmp)
    return inp, [dict(np.load(tmp / f"bn{r}.npz")) for r in range(2)]


def test_global_batch_norm_one_image_per_rank(bn_runs):
    from gan_lib_tensorflow_tpu_torch.ops import BatchNorm, ConditionalBatchNorm
    inp, ranks = bn_runs
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    bn, cbn = BatchNorm(8), ConditionalBatchNorm(5, 8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        cbn.gamma.weight.copy_(torch.from_numpy(inp["gamma"]))
    y = bn(x)
    yc = cbn(x, torch.from_numpy(inp["labels"]))
    loss = (y * torch.from_numpy(inp["dy"])).sum() + (yc ** 2).sum()
    gx, gw, gg = torch.autograd.grad(loss, (x, bn.weight, cbn.gamma.weight))
    for r, got in enumerate(ranks):
        _close(got["y"], y[r:r + 1].detach(), 1e-5, 1e-6)
        _close(got["yc"], yc[r:r + 1].detach(), 1e-5, 1e-6)
        _close(got["gx"], gx[r:r + 1], 1e-5, 1e-6)
        _close(got["gw"], gw, 1e-5, 1e-6)
        _close(got["gg"], gg, 1e-5, 1e-6)
        _close(got["rm"], bn.running_mean, 1e-5, 1e-6)
        _close(got["rv"], bn.running_var, 1e-5, 1e-6)
        _close(got["crm"], cbn.bn.running_mean, 1e-5, 1e-6)


@pytest.mark.parametrize("world,n", [(2, 8), (4, 8), (2, 2)])
def test_minibatch_stddev_over_ranks(world, n, tmp_path):
    """Groups straddle the ranks' rows (sample i sits in group i % (n/g));
    n = 2 over 2 ranks is the reference's g = min(4, n) at one row each."""
    from gan_lib_tensorflow_tpu_torch.ops import minibatch_stddev
    rng = np.random.default_rng(world * 10 + n)
    x = rng.standard_normal((n, 3, 4, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (1, 3, 1, 1)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, w=w)
    _run("_mbstd_rank", world, tmp_path)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, gx, gw = _mbstd_penalty(minibatch_stddev, xt, torch.from_numpy(w).requires_grad_(True))
    k = n // world
    for r in range(world):
        got = dict(np.load(tmp_path / f"mb{r}.npz"))
        _close(got["y"], y[r * k:(r + 1) * k].detach(), 1e-5, 1e-6)
        _close(got["gx"], gx[r * k:(r + 1) * k], 1e-5, 1e-6)
        _close(got["gw"], gw, 1e-5, 1e-6)
