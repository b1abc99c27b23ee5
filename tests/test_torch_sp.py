"""Spatial partitioning (the 'sp' axis, ``parallel/sharding.py``) of the
port against the unsharded port and the JAX package's GSPMD-sharded step
(the port of ``tests/test_spatial_sharding.py``).

Ranks are CPU processes in a gloo group (``dryrun.launch``: a ``FileStore``
in ``tmp_path``, one thread each, a time limit per spawn) that import torch
only and write ``.npz`` files; the unsharded runs are made here, in the
test's process. The JAX reference runs on the conftest's 8 virtual CPU
devices.

- The convolutions at sp 4 ('data' 1 x 'sp' 4, 4 rows per shard): the 3x3
  SAME ``Conv``, the fused ``UpsampleConv`` and ``DownsampleConv`` and an
  S2D cell conv (``ops/s2d.py``), each through its halo exchange: the
  output, the gradient of a loss in the input (kept as a graph), and the
  input and weight gradients of a penalty on that gradient (a double
  backward through the exchange). Against the unsharded port: rtol 1e-5 /
  atol 1e-6 (only the order of the sums differs); against JAX's plain
  function of the whole image: rtol 1e-4 / atol 2e-5.
- One PGGAN step under DP x SP 2 x 2 (res 16, width 1/64, z 8, fade-in at
  alpha 0.3, mbstd group 2, global batch 4, SGD: an update linear in the
  gradient) against JAX's ``make_train_step`` on a ``('data', 'sp')`` mesh
  (2, 2) with ``shard_batch(..., spatial_axis="sp")`` and against the same
  JAX step unsharded: metrics rtol 1e-4 / atol 1e-5, parameters and EMA
  rtol 1e-4 / atol 1e-6. A gradient off by a factor of sp (the penalty's
  inner sum not divided by sp, or the step not averaging over the 'sp'
  ranks) fails it. The reference's GSPMD step itself moves three of G's
  conv weights (``conv_4``, ``block_8.conv2``, ``block_16.conv2``) sp times
  as far as its unsharded step does on this mesh of virtual CPU devices (a
  reference fault, ROADMAP Queue 3): there the port is held to the
  unsharded step, which defines the function, and the sharded JAX update
  is checked to be sp times it.
- The same step with every sharded top level on the S2D grid against the
  composed ``fused_from`` step, both under DP x SP (the reference's
  ``test_pggan_step_dp_sp_s2d_matches_composed``): metrics rtol 2e-4 /
  atol 2e-4, as the reference holds them.
- The data sources: a ``DeviceFakeImages``, a ``DeviceCachedStore`` and a
  host stream through ``train.loop.device_batches`` yield each rank its
  height rows of its batch rows, bit for bit.
- ``cli.train_pggan --sp-shards 2`` on 2 ranks, to 16x16 with the S2D top
  level at every stage from 8: every logged metric within rtol 1e-4 /
  atol 1e-5 of the one-process run.
"""

import json
import os

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.dryrun import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
RES, B, Z, WM, ALPHA, SGD_LR, EMA = 16, 4, 8, 1 / 64, 0.3, 0.01, 0.999


def _run(target, world, workdir, **kwargs):
    launch(f"test_torch_sp:{target}", world, str(workdir),
           {"workdir": str(workdir), **kwargs}, timeout=150, pythonpath=TESTS)


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------------------------ the convolutions

# name -> (input NCHW shape, output channels, the op of the port's layer / kernel)
CONVS = {"conv3": (2, 3, 16, 8), "up": (2, 3, 8, 8), "down": (2, 3, 16, 8),
         "s2d": (2, 3, 16, 8)}


def _conv_op(name, w, b):
    """The port's op of ``name`` with weight ``w`` (OIHW) and bias ``b``."""
    from gan_lib_tensorflow_tpu_torch.ops import Conv, DownsampleConv, UpsampleConv, s2d
    if name == "s2d":
        return lambda x: (s2d.conv_same(s2d.space_to_depth(x), s2d.s2d_conv_kernel(w))
                          + s2d.tile_bias(b).view(1, -1, 1, 1))
    cls = {"conv3": Conv, "up": UpsampleConv, "down": DownsampleConv}[name]
    layer = cls(w.shape[1], w.shape[0], 3)
    del layer.weight, layer.bias  # the test's leaves take their place
    layer.weight, layer.bias = w, b
    return layer


def _penalty(op, x, w, r):
    """y = op(x); g = d sum(y^2) / dx (a graph); P = sum(g^2) + sum(y r);
    returns y, g, dP/dx, dP/dw."""
    y = op(x)
    (g,) = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
    gx, gw = torch.autograd.grad((g ** 2).sum() + (y * r).sum(), (x, w))
    return y, g, gx, gw


def _conv_inputs(name):
    rng = np.random.default_rng(sorted(CONVS).index(name))
    shape = CONVS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((5, shape[1], 3, 3))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    return x, w, b


def _out_shape(name):
    n, _, h, w = CONVS[name]
    return {"conv3": (n, 5, h, w), "up": (n, 5, 2 * h, 2 * w), "down": (n, 5, h // 2, w // 2),
            "s2d": (n, 20, h // 2, w // 2)}[name]


def _convs_rank(workdir):
    import torch.distributed as dist

    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh, sharded_step
    from gan_lib_tensorflow_tpu_torch.parallel.sharding import height_shards, split_height

    mesh = create_mesh((1, 4), ("data", "sp"), device="cpu")
    out = {}
    for name in CONVS:
        x, w, b = _conv_inputs(name)
        r = np.load(os.path.join(workdir, f"r_{name}.npy"))
        with sharded_step(mesh):
            xl = split_height(torch.from_numpy(x)).clone().requires_grad_(True)
            rl = split_height(torch.from_numpy(r))
            wt = torch.from_numpy(w).requires_grad_(True)
            with height_shards():
                y, g, gx, gw = _penalty(_conv_op(name, wt, torch.from_numpy(b)), xl, wt, rl)
        dist.all_reduce(gw)  # a replicated weight: the sum of the shards' parts
        out.update({f"{name}/y": y.detach().numpy(), f"{name}/g": g.detach().numpy(),
                    f"{name}/gx": gx.numpy(), f"{name}/gw": gw.numpy()})
    np.savez(os.path.join(workdir, f"convs{mesh.rank}.npz"), **out)


def _jax_conv_penalty(name, x, w, b, r):
    """JAX's plain function of the whole image: y, and dP/dx, dP/dw."""
    import jax
    import jax.numpy as jnp

    from gan_lib_tensorflow_tpu.ops import downsample_avg, s2d, upsample_nearest

    def op(x, w):
        xh, wh = jnp.transpose(x, (0, 2, 3, 1)), jnp.transpose(w, (2, 3, 1, 0))
        conv = lambda t, k: jax.lax.conv_general_dilated(
            t, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if name == "conv3":
            y = conv(xh, wh) + b
        elif name == "up":
            y = conv(upsample_nearest(xh), wh) + b
        elif name == "down":
            y = downsample_avg(conv(xh, wh)) + b
        else:
            y = s2d.conv_same(s2d.space_to_depth(xh), s2d.s2d_conv_kernel(wh)) + s2d.tile_bias(b)
        return jnp.transpose(y, (0, 3, 1, 2))

    def p(x, w):
        y = op(x, w)
        g = jax.grad(lambda x: (op(x, w) ** 2).sum())(x)
        return (g ** 2).sum() + (y * r).sum()

    gx, gw = jax.grad(p, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(op(jnp.asarray(x), jnp.asarray(w))), np.asarray(gx), np.asarray(gw)


@pytest.fixture(scope="module")
def conv_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("convs")
    for i, name in enumerate(CONVS):
        np.save(tmp / f"r_{name}.npy",
                np.random.default_rng(50 + i).standard_normal(_out_shape(name)).astype(np.float32))
    _run("_convs_rank", 4, tmp)
    return tmp, [dict(np.load(tmp / f"convs{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", sorted(CONVS))
def test_spatially_sharded_conv_matches_unsharded(name, conv_runs):
    """At sp 4 each rank's rows of y, of the inner gradient and of the outer
    input gradient are the unsharded port's and JAX's rows; the weight
    gradient summed over the ranks is theirs."""
    tmp, ranks = conv_runs
    x, w, b = _conv_inputs(name)
    r = np.load(tmp / f"r_{name}.npy")
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    y, g, gx, gw = _penalty(_conv_op(name, wt, torch.from_numpy(b)), xt, wt,
                            torch.from_numpy(r))
    jy, jgx, jgw = _jax_conv_penalty(name, x, w, b, r)
    _close(y.detach(), jy, 1e-4, 2e-5, "y vs JAX")
    _close(gx, jgx, 1e-4, 2e-5 * np.abs(jgx).max(), "dP/dx vs JAX")
    _close(gw, jgw, 1e-4, 2e-5 * np.abs(jgw).max(), "dP/dw vs JAX")
    for rank, got in enumerate(ranks):
        for key, full in (("y", y.detach()), ("g", g.detach()), ("gx", gx)):
            k = full.shape[2] // 4
            _close(got[f"{name}/{key}"], full[:, :, rank * k:(rank + 1) * k], 1e-5,
                   1e-6 * float(full.abs().max()), f"rank {rank} {key}")
        _close(got[f"{name}/gw"], gw, 1e-5, 1e-6 * float(gw.abs().max()), f"rank {rank} gw")


# ------------------------------------------------------------ the PGGAN step


def _port_nets(s2d_from=0, fused_from=0):
    from gan_lib_tensorflow_tpu_torch.models import pggan
    g = pggan.PGGANGenerator(RES, fade_in=True, z_dim=Z, width_mul=WM, s2d_from=s2d_from)
    d = pggan.PGGANDiscriminator(RES, fade_in=True, width_mul=WM, mbstd_group_size=2,
                                 fused_from=fused_from, s2d_from=s2d_from)
    return g, d


def _port_step(init, inputs, mesh=None, s2d_from=0, fused_from=0):
    """One port step from ``init``'s weights with SGD on ``inputs``' batch
    and draws (on ``mesh``: the rank's rows and height rows); returns the
    metrics and the networks' state and EMA."""
    from gan_lib_tensorflow_tpu_torch.models import pggan
    from gan_lib_tensorflow_tpu_torch.parallel import shard_batch
    from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step

    g, d = _port_nets(s2d_from, fused_from)
    state = create_state(g, d, ema_decay=EMA, device="cpu", mesh=mesh)
    for net in ("g", "d"):
        module = getattr(state, net)
        module.load_state_dict({k: torch.as_tensor(v) for k, v in init[net].items()})
        setattr(state, f"{net}_opt", torch.optim.SGD(list(module.parameters()), lr=SGD_LR))
    state.ema_params = {n: p.detach().clone() for n, p in g.named_parameters()}
    state.alpha = ALPHA
    spatial = None if mesh is None else "sp"
    batch = shard_batch({"image": torch.from_numpy(inputs["images"])}, mesh, 1, spatial)
    metrics = make_train_step(pggan.make_pggan_spec(g, d, ema_decay=EMA))(
        state, batch, z_critic=torch.from_numpy(inputs["z_c"]),
        z_g=torch.from_numpy(inputs["z_g"]), u_gp=torch.from_numpy(inputs["u"]))
    out = {f"m/{k}": float(v) for k, v in metrics.items()}
    for net in ("g", "d"):
        out.update({f"{net}/{k}": v.detach().numpy().copy()
                    for k, v in getattr(state, net).state_dict().items()})
    out.update({f"ema/{k}": v.numpy().copy() for k, v in state.ema_params.items()})
    return out


def _init(workdir):
    raw = np.load(os.path.join(workdir, "init.npz"))
    return {net: {k[2:]: raw[k] for k in raw if k.startswith(f"{net}/")} for net in ("g", "d")}


def _step_rank(workdir):
    """The JAX-compared step, then the S2D and composed steps and the data
    sources, all on one ('data' 2, 'sp' 2) mesh."""
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh

    mesh = create_mesh((2, 2), ("data", "sp"), device="cpu")
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    init = _init(workdir)
    np.savez(os.path.join(workdir, f"jaxed{mesh.rank}.npz"), **_port_step(init, inputs, mesh))
    runs = {"s2d": _port_step(init, inputs, mesh, s2d_from=8),
            "composed": _port_step(init, inputs, mesh, fused_from=8)}
    np.savez(os.path.join(workdir, f"s2d{mesh.rank}.npz"),
             **{f"{run}/{k}": v for run, out in runs.items() for k, v in out.items()
                if k.startswith("m/")})
    np.savez(os.path.join(workdir, f"data{mesh.rank}.npz"), **_sources(workdir, mesh))


def _jax_draws(rng):
    """z of the critic's fake, the penalty's u and the G update's z of one
    JAX step (``tests/test_torch_pggan_step.py`` replays the schedule)."""
    import jax
    import jax.numpy as jnp
    rng, sub = jax.random.split(rng)
    rng_z, rng_gp = jax.random.split(sub)
    z_c = jax.random.normal(rng_z, (B, Z))
    u = jax.random.uniform(rng_gp, (B, 1, 1, 1), dtype=jnp.float32)
    _, sub, _ = jax.random.split(rng, 3)
    z_g = jax.random.normal(sub, (B, Z))
    return np.asarray(z_c)[None], np.asarray(u)[None], np.asarray(z_g)


@pytest.fixture(scope="module")
def sp_step(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gan_lib_tensorflow_tpu import train as jtrain
    from gan_lib_tensorflow_tpu.models import pggan as jpggan
    from gan_lib_tensorflow_tpu.parallel import create_mesh, shard_batch
    from gan_lib_tensorflow_tpu_torch import convert

    tmp = tmp_path_factory.mktemp("sp_step")
    jg = jpggan.PGGANGenerator(resolution=RES, fade_in=True, z_dim=Z, width_mul=WM)
    jd = jpggan.PGGANDiscriminator(resolution=RES, fade_in=True, width_mul=WM,
                                   mbstd_group_size=2)
    opt = optax.sgd(SGD_LR)
    state0 = jtrain.create_state(
        jax.random.PRNGKey(0), lambda r: jg.init(r, jnp.zeros((2, Z)), 1.0),
        lambda r: jd.init(r, jnp.zeros((B, RES, RES, 3)), 1.0), opt, opt,
        ema_decay=EMA).replace(alpha=jnp.float32(ALPHA))
    z_c, u, z_g = _jax_draws(state0.rng)
    images = np.tanh(np.random.default_rng(0).standard_normal(
        (1, B, RES, RES, 3))).astype(np.float32)
    np.savez(tmp / "inputs.npz", images=images, z_c=z_c, u=u, z_g=z_g)
    host0 = jax.tree_util.tree_map(np.asarray, state0)
    np.savez(tmp / "init.npz", **{f"{net}/{k}": v for net in ("g", "d") for k, v in
                                  convert.module_tensors(getattr(host0, f"{net}_params"),
                                                         getattr(host0, f"{net}_state")).items()})
    mesh = create_mesh((2, 2), ("data", "sp"), devices=jax.devices()[:4])
    sharded = jax.device_put(state0, NamedSharding(mesh, P()))
    batch = shard_batch({"image": images}, mesh, leading_stack_dims=1, spatial_axis="sp")
    step = jax.jit(jtrain.make_train_step(jpggan.make_pggan_spec(jg, jd, ema_decay=EMA),
                                          opt, opt))
    jaxed = {}
    for how, st, b in (("sharded", sharded, batch), ("whole", state0, {"image": images})):
        state1, jm = step(st, b)
        host1 = jax.tree_util.tree_map(np.asarray, state1)
        jaxed[how] = {f"m/{k}": float(v) for k, v in jm.items()}
        for net, tree in (("g", host1.g_params), ("d", host1.d_params), ("ema", host1.ema_params)):
            jaxed[how].update({f"{net}/{k}": v for k, v in convert.to_torch_names(tree).items()})
    _run("_step_rank", 4, tmp)
    return (tmp, jaxed, _init(tmp), [dict(np.load(tmp / f"jaxed{r}.npz")) for r in range(4)])


def test_pggan_step_dp_sp_matches_jax(sp_step):
    _, jaxed, init, ranks = sp_step
    sharded, whole = jaxed["sharded"], jaxed["whole"]
    tol = lambda k: (1e-4, 1e-5) if k.startswith("m/") else (1e-4, 1e-6)
    # where the reference's sharded step leaves its own unsharded one, its
    # update is sp times the unsharded update (ROADMAP Queue 3)
    astray = set()
    for k, v in whole.items():
        if not np.allclose(sharded[k], v, *tol(k)):
            astray.add(k)
            net, _, name = k.partition("/")
            start = init["g" if net == "ema" else net][name]
            # the updates are ~1e-5 on weights ~1: float32 rounds them to
            # about 1% of their own size
            twice = 2 * (v.astype(np.float64) - start)
            off = np.linalg.norm(sharded[k] - start - twice) / np.linalg.norm(twice)
            assert off <= 2e-2, (k, off)
    assert all(k.startswith(("g/", "ema/")) for k in astray), astray
    for rank, got in enumerate(ranks):
        assert {k for k in got} == set(whole)
        for k, v in whole.items():
            _close(got[k], v, *tol(k), f"rank {rank} {k} vs the unsharded JAX step")
            if k not in astray:
                _close(got[k], sharded[k], *tol(k), f"rank {rank} {k} vs the sharded JAX step")


def test_pggan_step_dp_sp_s2d_matches_composed(sp_step):
    """The S2D top levels (``s2d_from`` 8) and the composed ``fused_from``
    8 levels under the same height sharding give the same metrics, also
    against the one-process run of the composed step."""
    tmp = sp_step[0]
    inputs = dict(np.load(tmp / "inputs.npz"))
    one = _port_step(_init(tmp), inputs, fused_from=8)
    for rank in range(4):
        got = dict(np.load(tmp / f"s2d{rank}.npz"))
        for k in ("d_loss", "wdist", "gp", "g_loss"):
            _close(got[f"s2d/m/{k}"], got[f"composed/m/{k}"], 2e-4, 2e-4, k)
            _close(got[f"composed/m/{k}"], one[f"m/{k}"], 2e-4, 2e-4, k)


# ------------------------------------------------------------ the data sources


def _sources(workdir, mesh):
    """A few batches of each source on ``mesh``'s 'sp' axis (or none)."""
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches

    spatial = None if mesh is None else "sp"
    images = np.random.default_rng(3).integers(0, 256, (12, 16, 16, 3), np.uint8)
    sources = {
        "device_fake": data.DeviceFakeImages(batch_size=4, image_size=16, num_classes=1,
                                             device="cpu", mesh=mesh, spatial_axis=spatial),
        "cached": data.DeviceCachedStore(images=images, batch_size=4, device="cpu",
                                         mesh=mesh, spatial_axis=spatial),
        "host": data.FakeImages(batch_size=4, image_size=16, num_classes=1),
    }
    out = {}
    for name, src in sources.items():
        it = device_batches(src, 1, torch.device("cpu"), mesh)
        for i in range(2):
            out[f"{name}/{i}"] = next(it)["image"].numpy().copy()
    return out


def test_sources_yield_the_ranks_height_rows_bit_for_bit(sp_step):
    tmp = sp_step[0]
    ref = _sources(tmp, None)
    for rank in range(4):
        i, j = divmod(rank, 2)  # row-major ('data', 'sp')
        got = dict(np.load(tmp / f"data{rank}.npz"))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v[:, 2 * i:2 * i + 2, 8 * j:8 * j + 8], k)


def test_a_source_not_made_for_the_sp_axis_is_refused():
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.parallel.mesh import Mesh
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    mesh = Mesh(shape=(1, 2), axis_names=("data", "sp"), rank=0, device=torch.device("cpu"),
                backend="gloo", groups={}, n_cards=1)
    src = data.DeviceFakeImages(batch_size=4, image_size=16, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="spatial_axis='sp'"):
        device_batches(src, 1, torch.device("cpu"), mesh)


# ------------------------------------------------------------ the CLI

CLI_ARGV = ["--device", "cpu", "--data", "device-fake", "--final-resolution", "16",
            "--width-mul", "0.015625", "--z-dim", "8", "--batch-by-res", "4:4,8:4,16:4",
            "--steps-per-phase", "2", "--compute-dtype", "fp32", "--log-every", "1",
            "--s2d-from", "8"]


def _cli_rank(workdir, argv):
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    train_pggan.main(argv)


def _logs(out_dir):
    found = {}
    for root, _, files in os.walk(out_dir):
        if "log.jsonl" in files:
            with open(os.path.join(root, "log.jsonl")) as f:
                found[os.path.relpath(root, out_dir)] = [
                    {k: v for k, v in json.loads(line).items() if k != "sec_per_step"}
                    for line in f]
    return found


def test_cli_sp_shards_2_logs_the_one_process_losses(tmp_path):
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    _run("_cli_rank", 2, tmp_path,
         argv=CLI_ARGV + ["--sp-shards", "2", "--out-dir", str(tmp_path / "ranks")])
    train_pggan.main(CLI_ARGV + ["--out-dir", str(tmp_path / "one")])
    got, ref = _logs(tmp_path / "ranks"), _logs(tmp_path / "one")
    assert set(got) == set(ref) and len(ref) == 5
    for phase, lines in ref.items():
        assert len(got[phase]) == len(lines) == 2
        for a, b in zip(got[phase], lines):
            assert set(a) == set(b)
            for k in b:
                _close(a[k], b[k], 1e-4, 1e-5, f"{phase} {k}")


def test_sp_shards_the_reference_cannot_shard_raise_there_and_exit_2_here(capsys):
    """The reference's mesh takes any sp that divides the device count, but
    GSPMD does not pad an uneven shard: its first PGGAN batch, 4x4 images
    sharded by height over 'sp' 3, raises ``ValueError`` in ``shard_batch``
    (and under ``jax.jit`` with those out_shardings). The port refuses sp 3
    when it parses its flags (rc 2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gan_lib_tensorflow_tpu.parallel import create_mesh, shard_batch
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan

    mesh = create_mesh((1, 3), ("data", "sp"), devices=jax.devices()[:3])
    images = np.zeros((2, 4, 4, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 3"):
        shard_batch({"image": images}, mesh, spatial_axis="sp")
    with pytest.raises(ValueError, match="divisible by 3"):
        jax.jit(lambda: jnp.zeros((2, 4, 4, 3)),
                out_shardings=NamedSharding(mesh, P("data", "sp")))()
    with pytest.raises(SystemExit) as e:
        train_pggan.parse_args(["--device", "cpu", "--sp-shards", "3"])
    assert e.value.code == 2
    assert "--sp-shards 3" in capsys.readouterr().err


def test_cli_sp_shards_2_below_8x8_shards_no_level_and_logs_the_one_process_losses(tmp_path):
    """A ladder that ends at 4x4 under 'sp' 2 (which the reference runs): no
    level is sharded, and every logged metric is the one-process run's."""
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    argv = CLI_ARGV[:CLI_ARGV.index("--final-resolution")] + [
        "--final-resolution", "4", "--width-mul", "0.015625", "--z-dim", "8",
        "--batch-by-res", "4:4", "--steps-per-phase", "2", "--compute-dtype", "fp32",
        "--log-every", "1"]
    _run("_cli_rank", 2, tmp_path,
         argv=argv + ["--sp-shards", "2", "--out-dir", str(tmp_path / "ranks")])
    train_pggan.main(argv + ["--out-dir", str(tmp_path / "one")])
    got, ref = _logs(tmp_path / "ranks"), _logs(tmp_path / "one")
    assert set(got) == set(ref) and len(ref) == 1
    for phase, lines in ref.items():
        assert len(got[phase]) == len(lines) == 2
        for a, b in zip(got[phase], lines):
            assert set(a) == set(b)
            for k in b:
                _close(a[k], b[k], 1e-4, 1e-5, f"{phase} {k}")
