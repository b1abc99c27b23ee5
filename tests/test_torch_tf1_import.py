"""The port's TF1 checkpoint importer (``gan_lib_tensorflow_tpu_torch/tools/
import_tf1_checkpoint.py``) against the reference tool
(``tools/import_tf1_checkpoint.py``), on the same TensorFlow-written
checkpoints.

For every family (SNGAN CIFAR-10 with ``--nchw-boundary`` and conditional,
ACGAN, SNGAN-projection ImageNet-128 narrow, pix2pix small, PGGAN small)
the two tools' ``import_report.json`` are byte-equal, and the reference's
step-0 orbax checkpoint, converted by ``convert.module_tensors`` /
``to_torch_names``, equals the port's step-0 checkpoint tensor for tensor,
bit for bit: G and D (weights, SN ``u``, BN statistics), both Adam slots
and their count, the EMA and the step. ``convert.flax_view`` of each port
network lists the same ``(path, shape, role)`` as the reference's
``flatten_variables`` of the JAX init.

The source values come from numpy (seeded) at the shapes of the port's
flax view, named as tflib names them (``Generator.00.W`` ..., in natural
path order), plus optimizer slots the tools drop, saved by TensorFlow's
``tf.compat.v1.train.Saver`` (run eagerly over one ``tf.Variable`` per
name: the index it writes is the graph-mode Saver's, byte for byte, in a
tenth of the time). The reference tool runs unchanged except for three
things, each to spare op-by-op compiles or disk round trips. Its random
init is traced (``jax.eval_shape``) and zero-filled: every compared leaf
comes from the checkpoint, and ``--allow-partial`` compares the matched
leaves with the reference tool's output and the unmatched one with the
reference's real ``PRNGKey(0)`` init (every family's init:
``tests/test_torch_flax_init.py``). Its ``create_state`` runs under one ``jax.jit`` (the same zeros and
copies, bit for bit, from one compile in place of one per leaf shape). And
the state it hands its orbax ``CheckpointManager.save`` is kept in memory,
except for SNGAN CIFAR-10 (``ORBAX``), whose step-0 checkpoint goes to
disk through orbax and is read back with ``restore_latest_raw`` (orbax's
save and restore keep every float32 bit).
The reference's pix2pix import raises ``TypeError`` (its D init omits
the target image); it runs here with that one call given both images.

Kept variables of other dtypes go through both tools alike: a SNGAN
checkpoint keeps a string, an int16, a uint8 and a complex64 variable
(the last three matched by role and shape ahead of real weights, so both
tools cast them to float32), a V1 checkpoint of PGGAN imports equal, and a
string matched by shape fails both tools' cast with numpy's ``ValueError``
after the same report.
"""

import dataclasses
import functools
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import import_tf1_checkpoint as ref  # noqa: E402

import gan_lib_tensorflow_tpu.train as ref_train_pkg  # noqa: E402
from gan_lib_tensorflow_tpu.train import CheckpointManager as RefCheckpoints  # noqa: E402
from gan_lib_tensorflow_tpu_torch import convert  # noqa: E402
from gan_lib_tensorflow_tpu_torch.tools import import_tf1_checkpoint as port  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "tests", "torch_fixtures", "tf1"))
import bundle_writer  # noqa: E402

FAMILIES = {
    "sngan": ("sngan", ["--nchw-boundary"]),
    "sngan_cond": ("sngan", ["--num-classes", "10"]),
    "acgan": ("acgan", []),
    "imagenet": ("imagenet", ["--num-classes", "5", "--width-mul", "0.015625"]),
    "pix2pix": ("pix2pix", ["--ngf", "4", "--ndf", "4", "--image-size", "32"]),
    "pggan": ("pggan", ["--resolution", "16", "--width-mul", "0.03125"]),
}
ORBAX = {"sngan"}  # families whose reference checkpoint goes through orbax


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the networks here are small, and in a parallel
    test run several workers' thread pools on the same cores slow them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(model, flags):
    return port.parse_args(["--ckpt", "-", "--model", model] + flags)


@functools.lru_cache(maxsize=None)
def _built(family):
    """The port's G and D of a family (read here, never trained)."""
    model, flags = FAMILIES[family]
    return port.build_models(_args(model, flags))


def _write_tf1(directory, named, extra=()):
    variables = {name: tf.Variable(np.asarray(val)) for name, _, val in list(named) + list(extra)}
    return tf.compat.v1.train.Saver(var_list=variables).save(
        None, os.path.join(str(directory), "model.ckpt"), write_meta_graph=False)


class _KeptCheckpoints:
    """Stands in for the reference's orbax ``CheckpointManager``: keeps the
    state ``save`` is given, as numpy fields by directory."""
    saved = {}

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)

    def save(self, step, state, wait=False):
        assert int(step) == 0
        self.saved[self.directory] = {
            f.name: jax.tree_util.tree_map(np.asarray, getattr(state, f.name))
            for f in dataclasses.fields(state)}

    def close(self):
        pass


def _ref_raw(ckpt_dir):
    """The reference tool's step-0 state: kept in memory, or restored from
    its orbax checkpoint."""
    kept = _KeptCheckpoints.saved.get(os.path.abspath(ckpt_dir))
    if kept is not None:
        assert not os.path.exists(ckpt_dir)
        return kept
    return jax.tree_util.tree_map(np.asarray, RefCheckpoints(ckpt_dir).restore_latest_raw())


_ref_build = ref.build_models
_ref_create_state = ref_train_pkg.create_state


def _jitted_create_state(rng, g_init, d_init, g_optim, d_optim, ema_decay=0.0):
    return jax.jit(lambda r, g, d: _ref_create_state(r, lambda _: g, lambda _: d, g_optim,
                                                      d_optim, ema_decay))(
        rng, g_init(rng), d_init(rng))


def _traced_build(args):
    """The reference's models with their init traced and zero-filled; for
    pix2pix its D initialized on both images."""
    if args.model == "pix2pix":
        from gan_lib_tensorflow_tpu.models import pix2pix
        g = pix2pix.UNetGenerator(base_ch=args.ngf)
        d = pix2pix.PatchGANDiscriminator(base_ch=args.ndf)
        xx = jnp.zeros((1, args.image_size, args.image_size, 3))
        g_init = lambda r: g.init(r, xx, train=False)
        d_init = lambda r: d.init(r, xx, xx, train=False)
    else:
        g, d, g_init, d_init = _ref_build(args)
    zeros = lambda init: (lambda r: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(init, r)))
    return g, d, zeros(g_init), zeros(d_init)


def _patch_reference(mp, orbax=False):
    mp.setattr(ref, "build_models", _traced_build)
    mp.setattr(ref_train_pkg, "create_state", _jitted_create_state)
    if not orbax:
        mp.setattr(ref_train_pkg, "CheckpointManager", _KeptCheckpoints)


@pytest.fixture
def traced_reference(monkeypatch):
    _patch_reference(monkeypatch)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One TensorFlow-written checkpoint per family, with slots to drop."""
    out = {}
    for key in FAMILIES:
        g, d = _built(key)
        named = (bundle_writer.tflib_variables(g, "Generator", 100)
                 + bundle_writer.tflib_variables(d, "Discriminator", 101))
        extra = [("beta1_power", None, np.float32(0.9)),
                 ("Generator.00.W/Adam", None, np.zeros(named[0][2].shape, np.float32)),
                 ("global_step", None, np.int64(100000))]
        out[key] = (_write_tf1(tmp_path_factory.mktemp(key), named, extra), named)
    return out


def _port_name(path: str) -> str:
    """The port's tensor name of a flax path (collection first)."""
    tree = np.zeros(1)
    for k in reversed(path.split("/")[1:]):
        tree = {k: tree}
    return next(iter(convert.to_torch_names(tree)))


def _port_main(argv):
    return port.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def imported(checkpoints, tmp_path_factory):
    """Both tools, run once per family on its checkpoint: ``imported(family)``
    -> (reference out dir, port out dir, the G and D leaves the reference
    flattened)."""
    done = {}

    def run(family):
        if family not in done:
            model, flags = FAMILIES[family]
            prefix, _ = checkpoints[family]
            root = tmp_path_factory.mktemp(f"{family}_out")
            seen = []
            flatten = ref.flatten_variables
            with pytest.MonkeyPatch.context() as mp:
                _patch_reference(mp, orbax=family in ORBAX)
                mp.setattr(ref, "flatten_variables", lambda v: seen.append(flatten(v)) or seen[-1])
                assert ref.main(["--ckpt", prefix, "--model", model,
                                 "--out-dir", str(root / "ref")] + flags) == 0
            assert _port_main(["--ckpt", prefix, "--model", model,
                               "--out-dir", str(root / "port")] + flags) == 0
            done[family] = (str(root / "ref"), str(root / "port"), seen)
        return done[family]
    yield run
    _KeptCheckpoints.saved.clear()  # the full-width states and models stay no longer
    _built.cache_clear()


def _ref_tensors(raw) -> dict:
    """The reference's step-0 checkpoint in the port's names and layouts."""
    out = {"step": int(raw["step"])}
    for net in ("g", "d"):
        out[net] = convert.module_tensors(raw[f"{net}_params"], raw[f"{net}_state"])
        count, mu, nu = convert._adam_fields(raw[f"{net}_opt"])
        out[f"{net}_count"] = int(count)
        out[f"{net}_mu"], out[f"{net}_nu"] = convert.to_torch_names(mu), convert.to_torch_names(nu)
    out["ema"] = convert.to_torch_names(raw["ema_params"])
    return out


def _port_tensors(ckpt_dir, family) -> dict:
    raw = torch.load(os.path.join(ckpt_dir, "step_000000.pt"), weights_only=True)
    g, d = _built(family)
    out = {"step": raw["step"]}
    for net, module in (("g", g), ("d", d)):
        out[net] = {k: v.numpy() for k, v in raw[net].items()}
        names = [n for n, _ in module.named_parameters()]
        slots = raw[f"{net}_opt"]["state"]
        assert sorted(slots) == list(range(len(names)))
        out[f"{net}_count"] = {int(s["step"]) for s in slots.values()}.pop()
        out[f"{net}_mu"] = {names[i]: s["exp_avg"].numpy() for i, s in slots.items()}
        out[f"{net}_nu"] = {names[i]: s["exp_avg_sq"].numpy() for i, s in slots.items()}
    out["ema"] = {k: v.numpy() for k, v in raw["ema_params"].items()}
    assert raw["g_sched"] is None and raw["d_sched"] is None
    return out


def _assert_same(got: dict, want: dict, only=None) -> int:
    assert got["step"] == want["step"] == 0
    n = 0
    for key in ("g", "d", "g_mu", "g_nu", "d_mu", "d_nu", "ema"):
        assert set(got[key]) == set(want[key]), key
        for name in want[key]:
            if only is not None and (key, name) not in only:
                continue
            a, b = got[key][name], want[key][name]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (key, name)
            assert a.tobytes() == b.tobytes(), (key, name)
            n += 1
    for net in ("g", "d"):
        assert got[f"{net}_count"] == want[f"{net}_count"] == 0
    return n


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_tool_equals_reference_tool(family, checkpoints, imported):
    _, named = checkpoints[family]
    ref_out, port_out, traced = imported(family)

    ref_report = open(os.path.join(ref_out, "import_report.json"), "rb").read()
    assert open(os.path.join(port_out, "import_report.json"), "rb").read() == ref_report
    report = json.loads(ref_report)
    assert not report["generator"]["unmatched_target"]
    assert not report["discriminator"]["unmatched_target"]
    assert "Adam" not in ref_report.decode() and "global_step" not in ref_report.decode()

    # flax_view of the port's networks is the reference's flatten_variables
    for seen, net in zip(traced, _built(family)):
        assert [(p, v.shape, r) for p, _, v, r in seen] == \
            [(p, v.shape, r) for p, _, v, r in convert.flax_view(net)]

    raw = _ref_raw(os.path.join(ref_out, "ckpt"))
    got = _port_tensors(os.path.join(port_out, "ckpt"), family)
    assert _assert_same(got, _ref_tensors(raw)) > len(named)
    # every imported tensor is its source in the port's layout (under
    # --nchw-boundary G's dense columns in (H, W, C) order)
    for tf_name, path, val in named:
        if family == "sngan" and path in ("params/dense/kernel", "params/dense/bias"):
            val = val[..., np.arange(val.shape[-1]).reshape(-1, 4, 4).transpose(1, 2, 0).ravel()]
        arr = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val
        arr = arr.T if val.ndim == 2 and path.split("/")[-1] in ("kernel", "embedding") else arr
        net = "g" if tf_name.startswith("Generator") else "d"
        np.testing.assert_array_equal(got[net][_port_name(path)], arr, err_msg=tf_name)


SMALL = ["--model", "pggan"] + FAMILIES["pggan"][1]


def test_report_only_writes_no_checkpoint(checkpoints, traced_reference, tmp_path):
    prefix, _ = checkpoints["pggan"]
    for tool, out in ((ref.main, tmp_path / "ref"), (_port_main, tmp_path / "port")):
        assert tool(["--ckpt", prefix, "--out-dir", str(out), "--report-only"] + SMALL) == 0
        assert os.path.exists(out / "import_report.json")
        assert not os.path.exists(out / "ckpt")
    assert (tmp_path / "ref" / "import_report.json").read_bytes() == \
        (tmp_path / "port" / "import_report.json").read_bytes()


def test_unmatched_leaf_fails_loudly_and_allow_partial(checkpoints, traced_reference, tmp_path):
    """G's dense kernel removed: both tools refuse; under --allow-partial
    both write a checkpoint whose matched leaves are equal, with the same
    report, and the unmatched leaf holds the reference's ``PRNGKey(0)``
    draw (the reference tool runs here with its init zero-filled, so the
    draw is taken from its ``g_init`` directly)."""
    _, named = checkpoints["pggan"]
    partial = _write_tf1(tmp_path, [n for n in named if not (
        n[0].startswith("Generator") and n[1] == "params/dense_4/kernel")])
    argv = ["--ckpt", partial] + SMALL
    for tool, out in ((ref.main, "ref"), (_port_main, "port")):
        with pytest.raises(SystemExit, match="1 target leaves have no source variable"):
            tool(argv + ["--out-dir", str(tmp_path / out)])
        assert tool(argv + ["--out-dir", str(tmp_path / out), "--allow-partial"]) == 0
    report = (tmp_path / "ref" / "import_report.json").read_bytes()
    assert (tmp_path / "port" / "import_report.json").read_bytes() == report
    assert json.loads(report)["generator"]["unmatched_target"] == ["params/dense_4/kernel"]
    want = _ref_tensors(_ref_raw(str(tmp_path / "ref" / "ckpt")))
    got = _port_tensors(str(tmp_path / "port" / "ckpt"), "pggan")
    only = {(key, name) for key in ("g", "d", "g_mu", "g_nu", "d_mu", "d_nu", "ema")
            for name in want[key] if not (key in ("g", "ema") and name == "dense_4.weight")}
    assert _assert_same(got, want, only) == len(only)
    # the unmatched leaf holds the reference's init, in G and in the EMA
    g_vars = _ref_inits(_args("pggan", FAMILIES["pggan"][1]))[0]
    draw = convert.to_torch_names(g_vars["params"])["dense_4.weight"]
    np.testing.assert_allclose(got["g"]["dense_4.weight"], draw, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["ema"]["dense_4.weight"], got["g"]["dense_4.weight"])


def _ref_inits(args):
    """The reference tool's ``g_init(PRNGKey(0))`` and ``d_init(PRNGKey(1))``
    (pix2pix's D on both images, as ``_traced_build``)."""
    g, d, g_init, d_init = _ref_build(args) if args.model != "pix2pix" else (
        None, None, None, None)
    if args.model == "pix2pix":
        from gan_lib_tensorflow_tpu.models import pix2pix
        g = pix2pix.UNetGenerator(base_ch=args.ngf)
        d = pix2pix.PatchGANDiscriminator(base_ch=args.ndf)
        xx = jnp.zeros((1, args.image_size, args.image_size, 3))
        g_init = lambda r: g.init(r, xx, train=False)
        d_init = lambda r: d.init(r, xx, xx, train=False)
    return g_init(jax.random.PRNGKey(0)), d_init(jax.random.PRNGKey(1))


def test_map_pins_and_a_typod_key(checkpoints, traced_reference, tmp_path):
    prefix, named = checkpoints["pggan"]
    first = sorted(named, key=lambda t: port._natkey(t[1]))[0]
    (tmp_path / "map.json").write_text(json.dumps({first[0]: first[1]}))
    (tmp_path / "typo.json").write_text(json.dumps({"Generator.99.W_typo": first[1]}))
    argv = ["--ckpt", prefix, "--report-only"] + SMALL
    for tool, out in ((ref.main, "ref"), (_port_main, "port")):
        assert tool(argv + ["--out-dir", str(tmp_path / out),
                            "--map", str(tmp_path / "map.json")]) == 0
        with pytest.raises(SystemExit, match="not in the checkpoint"):
            tool(argv + ["--out-dir", str(tmp_path / out), "--map", str(tmp_path / "typo.json")])
    report = (tmp_path / "ref" / "import_report.json").read_bytes()
    assert (tmp_path / "port" / "import_report.json").read_bytes() == report
    hows = {m["tf"]: m["how"] for m in json.loads(report)["generator"]["matched"]}
    assert hows[first[0]] == "explicit"


def test_sn_u_vectors_land_on_u_leaves():
    from gan_lib_tensorflow_tpu_torch.models import sngan
    d = sngan.cifar_discriminator()
    leaves = convert.flax_view(d)
    assert sum(role == "u" for *_, role in leaves) == 11
    named = bundle_writer.tflib_variables(d, "Discriminator", 3)
    assignments, report = port.match({n: v for n, _, v in named}, leaves, {}, "D")
    assert not report["unmatched_target"] and not report["unmatched_tf"]
    by_path = {p: k for p, k, _, _ in leaves}
    for name, path, val in named:
        if name.endswith(".u"):
            assert path.startswith("sn/")
            np.testing.assert_array_equal(assignments[by_path[path]], val)


def test_nchw_boundary_permutation_exact():
    """As the reference's test: column j of the TF dense holds its (c,h,w)
    index; after the fixup, NHWC position (h,w,c) reads it."""
    C, H, W = 3, 4, 4
    dim = C * H * W
    g_vars = {("params", "dense", "kernel"): np.tile(np.arange(dim, dtype=np.float32), (5, 1)),
              ("params", "dense", "bias"): np.arange(dim, dtype=np.float32),
              ("params", "conv", "kernel"): np.zeros((1, 1, 2, dim), np.float32)}
    fixed = port.nchw_boundary_fixups(g_vars, "sngan")
    want, _ = ref.nchw_boundary_fixups({"params": {"dense": {
        "kernel": g_vars[("params", "dense", "kernel")],
        "bias": g_vars[("params", "dense", "bias")]}}}, {"params": {}}, "sngan")
    np.testing.assert_array_equal(fixed[("params", "dense", "kernel")],
                                  want["params"]["dense"]["kernel"])
    np.testing.assert_array_equal(fixed[("params", "dense", "bias")],
                                  want["params"]["dense"]["bias"])
    for h in range(H):
        for w in range(W):
            for c in range(C):
                assert fixed[("params", "dense", "bias")][(h * W + w) * C + c] == c * H * W + h * W + w
    np.testing.assert_array_equal(fixed[("params", "conv", "kernel")], 0)
    assert port.nchw_boundary_fixups(g_vars, "pggan") is g_vars


def test_cli_sample_takes_the_import_and_train_clis_refuse_it_as_the_reference_does(
        imported, tmp_path):
    """``cli.sample`` samples the imported EMA; ``train_sngan`` refuses the
    step-0 checkpoint (it holds no lr schedule), as the reference's
    ``train_sngan`` refuses its tool's (the optax schedule state)."""
    from gan_lib_tensorflow_tpu.cli import train_sngan as ref_train
    from gan_lib_tensorflow_tpu_torch.cli import sample, train_sngan
    ref_out, port_out, _ = imported("sngan")
    out = str(tmp_path / "imported")
    shutil.copytree(port_out, out)
    imgs = sample.main(["--model", "sngan", "--ckpt-dir", os.path.join(out, "ckpt"),
                        "--out", str(tmp_path / "grid.png"), "--n", "4", "--device", "cpu"])
    assert tuple(imgs.shape) == (4, 32, 32, 3) and bool(torch.isfinite(imgs).all())
    assert os.path.getsize(tmp_path / "grid.png") > 0
    with pytest.raises(ValueError, match="g_sched"):
        train_sngan.main(["--out-dir", out, "--steps", "1", "--device", "cpu",
                          "--data", "device-fake", "--batch-size", "2", "--n-critic", "1"])
    args = types.SimpleNamespace(compute_dtype="fp32", num_classes=0, n_critic=5, ema_decay=0.9999,
                                 lr=2e-4, lr_decay_steps=0, steps=1, beta1=0.0, beta2=0.9, seed=0)
    abstract = jax.eval_shape(lambda: ref_train.build(args)[-1])
    with pytest.raises(ValueError, match="tree structures do not match"):
        RefCheckpoints(os.path.join(ref_out, "ckpt")).restore_latest(abstract)


def test_pggan_ladder_trains_beside_the_import_as_the_reference_does(imported, tmp_path, capsys):
    """``train_pggan`` reads per-phase checkpoint directories
    (``<out>/<res>x<res>_<phase>/ckpt``), as the reference's ladder does, so
    on an imported out dir it trains from scratch and leaves ``ckpt/``
    (the import) as it was."""
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    out = str(tmp_path / "imported")
    shutil.copytree(imported("pggan")[1], out)
    train_pggan.main(["--device", "cpu", "--data", "device-fake", "--final-resolution", "8",
                      "--width-mul", "0.03125", "--batch-by-res", "4:2,8:2",
                      "--steps-per-phase", "1", "--out-dir", out])
    assert "resumed" not in capsys.readouterr().out
    assert os.listdir(os.path.join(out, "ckpt")) == ["step_000000.pt"]
    assert {"4x4_stabilize", "8x8_transition", "8x8_stabilize"} <= set(os.listdir(out))


def _tflib_named(family, prefix_g, prefix_d):
    g, d = _built(family)
    return (bundle_writer.tflib_variables(g, prefix_g, 100)
            + bundle_writer.tflib_variables(d, prefix_d, 101))


def _both_tools(prefix, model, flags, root):
    """The reference tool (traced init, state kept in memory) and the
    port's on one checkpoint: (reference out dir, port out dir)."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_reference(mp)
        assert ref.main(["--ckpt", prefix, "--model", model, "--out-dir", str(root / "ref")]
                        + flags) == 0
    assert _port_main(["--ckpt", prefix, "--model", model, "--out-dir", str(root / "port")]
                      + flags) == 0
    return str(root / "ref"), str(root / "port")


def test_kept_variables_of_every_dtype_import_as_the_reference_imports(tmp_path):
    """SNGAN CIFAR-10 (full width, 32 variables) named ``gen/w.NN.W`` /
    ``dis/w.NN.W`` plus ``gen/note`` (string), ``gen/mask`` (uint8, the
    shape of G's last conv kernel), ``dis/counts`` (int16, D's dense
    kernel) and ``dis/phase`` (complex64, D's first conv kernel): the three
    numbers sort first in their (role, shape) groups, so both tools match
    them and cast them to float32 (the complex one loses its imaginary
    part), and list the weights they displace and the string unmatched."""
    named = _tflib_named("sngan", "gen/w", "dis/w")
    shapes = {path: val.shape for _, path, val in named}
    rng = np.random.default_rng(7)
    g_last = max((p for p in shapes if p.startswith("params/conv")), key=port._natkey)
    extra = [("gen/note", None, np.array(b"trained 100k steps")),
             ("gen/mask", None, rng.integers(0, 256, shapes[g_last]).astype(np.uint8))]
    d_named = [(n, p, v) for n, p, v in named if n.startswith("dis/")]
    d_dense = next(v.shape for n, p, v in d_named if v.ndim == 2 and n.endswith(".W"))
    d_first = next(v.shape for n, p, v in d_named if v.ndim == 4)
    extra += [("dis/counts", None, rng.integers(-32768, 32768, d_dense).astype(np.int16)),
              ("dis/phase", None, (rng.standard_normal(d_first)
                                   + 1j * rng.standard_normal(d_first)).astype(np.complex64))]
    prefix = _write_tf1(tmp_path, named, extra)
    got = port.read_tf_checkpoint(prefix)
    assert [got[n].dtype.name for n in ("gen/note", "gen/mask", "dis/counts", "dis/phase")] == \
        ["bytes144", "uint8", "int16", "complex64"]
    with pytest.warns(np.exceptions.ComplexWarning):
        ref_out, port_out = _both_tools(prefix, "sngan", [], tmp_path)
    report = open(os.path.join(ref_out, "import_report.json"), "rb").read()
    assert open(os.path.join(port_out, "import_report.json"), "rb").read() == report
    parsed = json.loads(report)
    matched = {m["tf"] for net in ("generator", "discriminator") for m in parsed[net]["matched"]}
    assert {"gen/mask", "dis/counts", "dis/phase"} <= matched
    assert "gen/note" in parsed["generator"]["unmatched_tf"]
    assert len(parsed["discriminator"]["unmatched_tf"]) == 2
    want = _ref_tensors(_ref_raw(os.path.join(ref_out, "ckpt")))
    assert _assert_same(_port_tensors(os.path.join(port_out, "ckpt"), "sngan"), want) > len(named)


@pytest.mark.parametrize("fmt", ["v2", "v1_2_files"])
def test_names_tied_in_natural_order_match_as_the_reference_tool_matches_them(fmt, tmp_path):
    """Within a (role, shape) group both tools sort TensorFlow's names by a
    natural key, stably, so names that tie in it (``a01``/``a1``) keep the
    order they were read in: the port reads them in
    ``get_variable_to_shape_map()``'s order, as the reference does, and
    the two assign the same leaves, where the bundle's key order would not."""
    from gan_lib_tensorflow_tpu_torch.tools import tf1_bundle
    rng = np.random.default_rng(11)
    stems = ["a1", "a01", "w_01", "w_1", "c2", "c002", "x10", "x010"]
    stems += [f"b{i}" for i in range(40)]
    tensors = {f"dis/{stem}/W": rng.standard_normal((3, 2)).astype(np.float32) for stem in stems}
    tensors.update({f"gen/{stem}/b": rng.standard_normal(4).astype(np.float32) for stem in stems})
    prefix = str(tmp_path / "model.ckpt")
    path = (bundle_writer.write_bundle(prefix, tensors) if fmt == "v2"
            else bundle_writer.write_v1(prefix, tensors, num_shards=2))
    ref_vars, port_vars = ref.read_tf_checkpoint(path), tf1_bundle.read_tf_checkpoint(path)
    assert list(port_vars) == list(ref_vars)
    leaves = {"d": [(f"conv{i}/kernel", ("conv%d" % i, "kernel"), np.zeros((3, 2)), "kernel")
                    for i in range(len(stems))],
              "g": [(f"dense{i}/bias", ("dense%d" % i, "bias"), np.zeros(4), "bias")
                    for i in range(len(stems))]}
    nets = dict(zip("gd", ref.partition_networks(ref_vars, None, None)[:2]))
    port_nets = dict(zip("gd", port.partition_networks(port_vars, None, None)[:2]))
    differs = False
    for net in "gd":
        want, ref_report = ref.match(nets[net], leaves[net], {}, net)
        got, port_report = port.match(port_nets[net], leaves[net], {}, net)
        assert port_report == ref_report
        assert set(got) == set(want)
        for keys in want:
            np.testing.assert_array_equal(got[keys], want[keys])
        _, key_order = port.match(dict(sorted(port_nets[net].items())), leaves[net], {}, net)
        differs |= key_order != ref_report
    assert differs


def test_v1_checkpoint_imports_as_the_reference_imports(tmp_path):
    """A ``SaverDef.V1`` checkpoint (one table file) of PGGAN at small
    width, written by TensorFlow: the same report and step-0 tensors."""
    named = _tflib_named("pggan", "Generator", "Discriminator")
    variables = {name: tf.Variable(np.asarray(val)) for name, _, val in named}
    variables["global_step"] = tf.Variable(np.int64(7))
    prefix = tf.compat.v1.train.Saver(
        var_list=variables, write_version=tf.compat.v1.train.SaverDef.V1).save(
        None, str(tmp_path / "model.ckpt"), write_meta_graph=False)
    assert not os.path.exists(prefix + ".index") and os.path.isfile(prefix)
    ref_out, port_out = _both_tools(prefix, "pggan", FAMILIES["pggan"][1], tmp_path)
    report = open(os.path.join(ref_out, "import_report.json"), "rb").read()
    assert open(os.path.join(port_out, "import_report.json"), "rb").read() == report
    assert not json.loads(report)["generator"]["unmatched_target"]
    want = _ref_tensors(_ref_raw(os.path.join(ref_out, "ckpt")))
    assert _assert_same(_port_tensors(os.path.join(port_out, "ckpt"), "pggan"), want) > len(named)


def test_a_string_matched_by_shape_fails_both_casts(tmp_path):
    """A string vector sorted first among PGGAN's G kernels of its shape:
    both tools write the same report and then fail to cast it to float32
    (numpy's ``ValueError``), writing no checkpoint."""
    named = _tflib_named("pggan", "gen/w", "dis/w")
    shape = next(v.shape for n, p, v in named if n.startswith("gen/") and v.ndim == 2)
    words = np.array([b"not a number"] * int(np.prod(shape)), object).reshape(shape)
    prefix = _write_tf1(tmp_path / "ckpt", named, [("gen/a_note", None, words)])
    argv = ["--ckpt", prefix, "--model", "pggan"] + FAMILIES["pggan"][1]
    with pytest.MonkeyPatch.context() as mp:
        _patch_reference(mp)
        with pytest.raises(ValueError, match="could not convert string to float"):
            ref.main(argv + ["--out-dir", str(tmp_path / "ref")])
    with pytest.raises(ValueError, match="could not convert string to float"):
        _port_main(argv + ["--out-dir", str(tmp_path / "port")])
    report = (tmp_path / "ref" / "import_report.json").read_bytes()
    assert (tmp_path / "port" / "import_report.json").read_bytes() == report
    assert any(m["tf"] == "gen/a_note" for m in json.loads(report)["generator"]["matched"])
    assert not os.path.exists(tmp_path / "ref" / "ckpt") and not os.path.exists(
        tmp_path / "port" / "ckpt")
