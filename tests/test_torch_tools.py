"""The torch-side tools (``gan_lib_tensorflow_tpu_torch/tools/``) against the
reference's (``tools/*.py``, loaded from their files), on the CPU.

- Configurations, at full width: each bench tool's networks have the
  reference tool's parameter and state shapes (``jax.eval_shape`` of the
  reference's own ``init`` functions; the port's modules on the meta
  device, compared through ``convert.py``'s layout rules), and the same
  batch, critic count, data shapes, Adam hyperparameters and EMA. The
  reference tools are run with ``create_state`` recorded instead of
  called (nothing is initialised or compiled) and ``optax.adam`` recorded.
- Each tool runs end to end with ``--device cpu`` at a tiny size, one or two
  timed steps, and prints the reference's keys; a failing configuration
  prints an ``error`` row and the tool returns 1.
- ``calibrate_rungs.count_flops`` of one forward at a tiny width is 2 x the
  multiply-adds worked out from the layers' weight and output shapes.
"""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.models import pggan
from gan_lib_tensorflow_tpu_torch.ops import layers
from gan_lib_tensorflow_tpu_torch.ops.layers import init_weights
from gan_lib_tensorflow_tpu_torch.tools import (bench_eval, bench_kstep, bench_loader,
                                                bench_pggan, bench_step, calibrate_rungs,
                                                decompose_pggan, harness, probe_cond_cost)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs here are tiny, and in a parallel test
    run several workers' thread pools on the same cores slow them many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_shapes(variables):
    """``convert.to_torch_names``'s names and layouts, on shapes."""
    out = {}
    for coll in variables.values():
        for path, leaf in convert._flatten(coll):
            *mods, name = path
            shape = tuple(leaf.shape)
            if name in ("kernel", "embedding"):
                shape = tuple(shape[i] for i in (3, 2, 0, 1)) if len(shape) == 4 else shape[::-1]
            out[".".join(mods + [convert._LEAF_NAMES[name]])] = shape
    return out


def test_the_shape_rules_are_convert_pys():
    import jax
    import jax.numpy as jnp

    from gan_lib_tensorflow_tpu.models import acgan as jacgan
    d = jacgan.ACGANDiscriminator()
    v = d.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=False)
    want = {k: a.shape for k, a in convert.module_tensors(
        v["params"], {c: t for c, t in v.items() if c != "params"}).items()}
    assert _port_shapes(v) == want


@pytest.fixture
def record(monkeypatch):
    """Run the reference tools' build functions with ``create_state`` and
    ``jax.jit`` recorded (the state is the recorded call) and every
    ``optax.adam``."""
    import jax
    import optax

    from gan_lib_tensorflow_tpu import train
    calls = {"adam": [], "state": []}
    real_adam = optax.adam

    def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, **kw):
        calls["adam"].append((learning_rate, b1, b2, eps))
        return real_adam(learning_rate, b1=b1, b2=b2, eps=eps, **kw)

    def create_state(rng, g_init, d_init, g_optim, d_optim, ema_decay=0.0):
        calls["state"].append((g_init, d_init, ema_decay))
        return "state"

    monkeypatch.setattr(optax, "adam", adam)
    monkeypatch.setattr(train, "create_state", create_state)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    return calls


def _ref_config(calls):
    """(G shapes, D shapes, [(lr, b1, b2, eps)] of G's then D's Adam, EMA)
    of the last reference build."""
    import jax
    g_init, d_init, ema = calls["state"][-1]
    shapes = [_port_shapes(jax.eval_shape(f, jax.random.PRNGKey(0))) for f in (g_init, d_init)]
    return shapes[0], shapes[1], calls["adam"][-2:], ema


def _port_config(build, monkeypatch):
    """The same of a port build function, its modules on the meta device."""
    made = []

    def create_state(g, d, lr=2e-4, beta1=0.0, beta2=0.9, ema_decay=0.0, d_lr=None, **kw):
        made.append((g, d, [(lr, beta1, beta2, 1e-8), (d_lr or lr, beta1, beta2, 1e-8)],
                     ema_decay))
        return argparse.Namespace(g=g)

    monkeypatch.setattr(harness, "create_state", create_state)
    with torch.device("meta"):
        fam = build()
    g, d, adams, ema = made[-1]
    shapes = lambda m: {k: tuple(t.shape) for k, t in m.state_dict().items()}
    return shapes(g), shapes(d), adams, ema, fam


def _same(ref, port, batch, n_micro, data):
    rg, rd, radam, rema = ref
    pg, pd, padam, pema, fam = port
    assert pg == rg and pd == rd
    assert padam == [tuple(float(x) for x in a) for a in radam] and pema == rema
    assert fam.batch == batch and fam.spec.n_critic == n_micro
    assert {k: tuple(v.shape) for k, v in fam.data.items()} == \
           {k: tuple(np.shape(v)) for k, v in data.items()}


@pytest.mark.parametrize("model", ["sngan", "acgan", "imagenet"])
def test_bench_step_configurations_are_the_references(model, record, monkeypatch):
    spec, _, _, data, batch = _ref_tool("bench_step").build(model, None)
    _same(_ref_config(record), _port_config(lambda: bench_step.build(model, None, "cpu"),
                                            monkeypatch), batch, spec.n_micro, data)


@pytest.mark.parametrize("rung", ["acgan", "pix2pix", "imagenet", "pggan1024"])
def test_calibrate_rungs_configurations_are_the_references(rung, record, monkeypatch):
    ref = _ref_tool("calibrate_rungs")
    if rung == "pggan1024":
        _, _, data = ref.build_pggan(1024, 4)
    else:
        _, _, data = getattr(ref, f"build_{rung}")()
    key = "input" if rung == "pix2pix" else "image"
    n_micro, batch = np.shape(data[key])[:2]
    args = argparse.Namespace(device="cpu", width_mul=1.0, pix2pix_batch=4, pggan_batch=0,
                              s2d_from=0)
    _same(_ref_config(record), _port_config(lambda: calibrate_rungs.build(rung, args),
                                            monkeypatch), batch, n_micro, data)


class _Stop(Exception):
    pass


def test_bench_pggan_configuration_is_the_references(record, monkeypatch):
    """``time_config`` builds, then steps: its first step stops it."""
    import jax
    ref = _ref_tool("bench_pggan")
    datas = []

    def jit(f, **kw):
        def step(state, batch):
            datas.append(batch)
            raise _Stop
        return step

    monkeypatch.setattr(jax, "jit", jit)
    with pytest.raises(_Stop):
        ref.time_config(1024, 4, 512, 128, 1, s2d_from=512)
    _same(_ref_config(record), _port_config(
        lambda: harness.pggan_top(1024, 4, "cpu", remat_from=512, fused_from=128,
                                  s2d_from=512), monkeypatch), 4, 1, datas[0])


@pytest.mark.parametrize("n_cls", [1000, 0])
def test_probe_cond_cost_configurations_are_the_references(n_cls, record, monkeypatch):
    _, _, data, batch, spec = _ref_tool("probe_cond_cost").build(n_cls)
    _same(_ref_config(record), _port_config(
        lambda: harness.sngan_imagenet(64, "cpu", num_classes=n_cls), monkeypatch),
        batch, spec.n_micro, data)


@pytest.mark.parametrize("model", ["acgan", "pix2pix"])
def test_bench_kstep_configurations_are_the_references(model, record, monkeypatch):
    spec, _, _, make_batch, batch = _ref_tool("bench_kstep").build(model)
    data = {k: v[0] for k, v in make_batch(np.random.default_rng(0), 1).items()}
    _same(_ref_config(record), _port_config(lambda: bench_kstep.build(model, "cpu"),
                                            monkeypatch), batch, spec.n_micro, data)


# ---- end to end on the CPU, tiny


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


TINY = ["--device", "cpu"]
W = ["--width-mul", "0.015625"]
RUNS = {
    "bench_step": (bench_step, ["--batch", "2", "--timed-steps", "1"] + W,
                   {"model", "batch", "n_critic", "ms_per_step", "img_per_sec"}, 3),
    "bench_pggan": (bench_pggan, ["--resolution", "16", "--batch", "2", "--remat-from", "0",
                                  "16", "--fused-from", "8", "--s2d-from", "8",
                                  "--timed-steps", "1"] + W,
                    {"resolution", "batch", "remat_from", "fused_from", "s2d_from",
                     "ms_per_step", "img_per_sec"}, 2),
    "decompose_pggan": (decompose_pggan, ["--res", "16", "--batch", "2", "--s2d-from", "8",
                                          "--reps", "1"] + W,
                        {"s2d_from", "res", "batch", "g_fwd_ms", "d_fwd_ms", "g_grad_ms",
                         "gp_grad_ms", "d_grad_full_ms"}, 1),
    "calibrate_rungs": (calibrate_rungs, ["--rungs", "pggan16", "--pggan-batch", "2",
                                          "--timed-steps", "1"] + W,
                        {"rung", "batch", "ms_per_step", "img_per_sec", "tf_per_step",
                         "roofline_ms_nominal", "roofline_ms_achieved", "mfu_nominal",
                         "frac_of_achieved"}, 1),
    "probe_cond_cost": (probe_cond_cost, ["--batch", "2", "--timed-steps", "1"] + W,
                        {"config", "ms_per_step", "img_per_sec"}, 2),
    "bench_kstep": (bench_kstep, ["--model", "pix2pix", "--mode", "chained", "--ks", "2",
                                  "--reps", "2", "--image-size", "32"],
                    {"model", "mode", "k", "ms_per_step"}, 1),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tool_runs_on_the_cpu_with_the_references_keys(name, capsys):
    module, argv, keys, n_rows = RUNS[name]
    assert module.main(argv + TINY) == 0
    rows = _rows(capsys)
    assert len(rows) == n_rows
    for row in rows:
        assert keys <= set(row) and "error" not in row and row["card"] == "cpu"
        assert all(v is None or np.isfinite(v) for v in row.values()
                   if isinstance(v, float))


def test_calibrate_rungs_off_the_card_has_no_share_of_peak(capsys):
    calibrate_rungs.main(RUNS["calibrate_rungs"][1] + TINY)
    (row,) = _rows(capsys)
    assert row["tf_per_step"] > 0 and row["achieved_tfs"] is None
    assert row["mfu_nominal"] is None and row["roofline_ms_nominal"] is None


def test_bench_eval_runs_on_the_cpu(monkeypatch, capsys):
    from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
    monkeypatch.setattr(bench_eval, "InceptionV3Features",
                        lambda params_npz=None, device="cpu": FixedFeatureNet(device=device))
    assert bench_eval.main(["--n-samples", "20", "--batch-size", "10"] + TINY) == 0
    rows = _rows(capsys)
    assert [r["mode"] for r in rows] == ["device", "host"]
    for r in rows:
        assert {"mode", "n_samples", "wall_s", "samples_per_s", "is", "trace_cov"} <= set(r)
    assert rows[0]["trace_cov"] == pytest.approx(rows[1]["trace_cov"], rel=1e-5)
    assert rows[0]["is"] == pytest.approx(rows[1]["is"], rel=1e-5)


def test_bench_loader_runs_on_the_cpu(tmp_path, capsys):
    assert bench_loader.main(["--n", "64", "--size", "16", "--batch", "8", "--n-batches", "4",
                              "--store-dir", str(tmp_path / "store"), "--rss-demo"] + TINY) == 0
    rows = _rows(capsys)
    loaders = [r["loader"] for r in rows if "loader" in r]
    assert loaders == ["PackedImageStore", "ThreadedSource(PackedImageStore, workers=1)",
                       "ThreadedSource(PackedImageStore, workers=2)", "DeviceCachedStore"]
    assert {"n", "size", "batch", "store_gb", "img_per_s", "ms_per_batch",
            "rss_delta_mb"} <= set(rows[1])
    assert rows[-1]["rss_demo"] and rows[-1]["streamed_batches"] == 8


def test_a_failing_configuration_prints_an_error_row_and_returns_1(capsys, monkeypatch):
    real = harness.pggan_top

    def pggan_top(*args, s2d_from=0, **kw):  # the second configuration runs out of memory
        if s2d_from:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(*args, s2d_from=s2d_from, **kw)

    monkeypatch.setattr(harness, "pggan_top", pggan_top)
    argv = ["--resolution", "16", "--batch", "2", "--remat-from", "0", "--fused-from", "0",
            "--s2d-from", "0", "8", "--timed-steps", "1"] + W + TINY
    assert bench_pggan.main(argv) == 1
    rows = _rows(capsys)
    assert "error" not in rows[0] and rows[1]["s2d_from"] == 8
    assert rows[1]["error"] == "OutOfMemoryError: CUDA out of memory (simulated)"
    assert bench_kstep.main(["--model", "acgan", "--mode", "fused", "--ks", "1"] + TINY) == 1
    assert "needs the card" in _rows(capsys)[0]["error"]


# ---- the FLOP count


def _macs(module, run):
    """Multiply-adds of every Conv and Dense call in ``run()``: the output's
    elements times the weight's fan-in."""
    total, hooks = [0], []

    def hook(m, _inp, out):
        total[0] += out.numel() * int(np.prod(m.weight.shape[1:]))

    for m in module.modules():
        if isinstance(m, (layers.Conv, layers.Dense, layers.UpsampleConv)):
            hooks.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_flop_count_of_a_forward_is_twice_the_layer_macs():
    """PGGAN G and D at width 1/64: every layer a plain convolution or a
    dense product (G's up-convolutions unfused: the fused ones run a
    transposed convolution of another shape, which is counted as it runs)."""
    g = pggan.PGGANGenerator(resolution=16, width_mul=1 / 64, z_dim=8)
    d = pggan.PGGANDiscriminator(resolution=16, width_mul=1 / 64)
    for m in g.modules():
        if isinstance(m, layers.UpsampleConv):
            m.fused = False
    init_weights(g, torch.Generator().manual_seed(0))
    init_weights(d, torch.Generator().manual_seed(1))
    z, x = torch.randn(3, 8), torch.randn(3, 16, 16, 3)
    for net, arg in ((g, z), (d, x)):
        macs = _macs(net, lambda: net(arg, 1.0))
        assert macs > 0
        assert calibrate_rungs.count_flops(lambda: net(arg, 1.0)) == 2 * macs
