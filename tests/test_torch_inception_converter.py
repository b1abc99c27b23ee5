"""The port's InceptionV3 converter (``gan_lib_tensorflow_tpu_torch/tools/
convert_inception_weights.py``) against the reference's
(``tools/convert_inception_weights.py``, loaded as
``tests/test_inception_converter.py`` loads it), on the CPU.

- The target paths: the port's creation order (``param_paths(sort=False)``)
  puts the conv kernels and the BN units in the reference's flax creation
  order, over the same set of paths and shapes.
- The same random torchvision-layout state dict (``torchvision_state_dict``:
  torchvision's key names and order, ``AuxLogits`` included), the same random
  keras-named npz and the same target-layout npz give output npz files equal
  array for array.
- A shape mismatch and a missing tensor fail hard (``SystemExit``), in each
  route.
- ``main --verify`` loads the result into ``InceptionV3Features`` and runs a
  batch; ``cli.north_star`` converts a raw ``.pth`` itself, once (cached).

The reference's target paths come from one flax ``init`` of InceptionV3
(about 25 s on the CPU), made once for the module and handed to its
converter.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.cli import north_star
from gan_lib_tensorflow_tpu_torch.tools import convert_inception_weights as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_convert_inception_weights",
        os.path.join(REPO, "tools", "convert_inception_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    paths = mod.creation_order_paths()
    mod.creation_order_paths = lambda: paths
    return mod


def _unit_order(mod, paths):
    convs, bns, fc = mod._partition_targets(paths)
    return ([p for p, _ in convs], [sorted((k, v) for k, v in u.items()) for u in bns],
            sorted(fc.items()))


def test_target_paths_are_the_references_creation_order(ref):
    ours, theirs = port.creation_order_paths(), ref.creation_order_paths()
    assert sorted(ours) == sorted(theirs)
    assert _unit_order(port, ours) == _unit_order(ref, theirs)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torchvision_route_equals_the_references(ref, tmp_path):
    path = str(tmp_path / "tv.pth")
    sd = port.torchvision_state_dict(1)
    assert next(iter(sd)) == "Conv2d_1a_3x3.conv.weight" and "AuxLogits.fc.weight" in sd
    torch.save(sd, path)
    got = port.convert(path)
    _assert_same(got, ref.convert(path))
    np.testing.assert_array_equal(got["mixed10/bpool/conv/kernel"],
                                  sd["Mixed_7c.branch_pool.conv.weight"].numpy()
                                  .transpose(2, 3, 1, 0))


def _keras_npz(mod, path, seed=0):
    """Random keras-named tensors at the real shapes, numbered in creation
    order (the reference test's synthetic source)."""
    rng = np.random.default_rng(seed)
    convs, bns, fc = mod._partition_targets(mod.creation_order_paths())
    src = {}
    for i, (_, shape) in enumerate(convs):
        src["conv2d/kernel:0" if i == 0 else f"conv2d_{i}/kernel:0"] = \
            rng.standard_normal(shape).astype(np.float32)
    for i, unit in enumerate(bns):
        base = "batch_normalization" if i == 0 else f"batch_normalization_{i}"
        for stat, (_, shape) in unit.items():
            arr = rng.standard_normal(shape).astype(np.float32)
            src[f"{base}/{stat}:0"] = np.abs(arr) + 0.1 if stat == "moving_variance" else arr
    for name, (_, shape) in fc.items():
        src[f"predictions/{name}:0"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(path, **src)
    return src


def test_keras_and_target_layout_routes_equal_the_references(ref, tmp_path):
    keras = str(tmp_path / "keras.npz")
    _keras_npz(ref, keras)
    _assert_same(port.convert(keras), ref.convert(keras))
    flat = str(tmp_path / "flat.npz")
    rng = np.random.default_rng(2)
    np.savez(flat, **{"/".join(p): rng.standard_normal(s).astype(np.float32)
                      for p, s in ref.creation_order_paths()})
    _assert_same(port.convert(flat), ref.convert(flat))


def test_shape_mismatch_and_missing_tensor_fail_hard(ref, tmp_path):
    keras = str(tmp_path / "keras.npz")
    src = _keras_npz(ref, keras)
    bad = {**src, "conv2d_5/kernel:0": np.zeros((1, 1, 7, 7), np.float32)}
    np.savez(keras, **bad)
    with pytest.raises(SystemExit, match="shape mismatch"):
        port.convert(keras)
    del bad["conv2d_3/kernel:0"]
    np.savez(keras, **bad)
    with pytest.raises(SystemExit, match="conv kernels"):
        port.convert(keras)
    sd = port.torchvision_state_dict(0)
    del sd["Mixed_6b.branch7x7_2.bn.running_var"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(SystemExit, match="running_var|missing"):
        port.convert(str(tmp_path / "short.pth"))
    sd = port.torchvision_state_dict(0)
    sd["fc.weight"] = sd["fc.weight"][:10]
    torch.save(sd, tmp_path / "narrow.pth")
    with pytest.raises(SystemExit, match="shape mismatch fc/kernel"):
        port.convert(str(tmp_path / "narrow.pth"))
    assert not os.path.exists(tmp_path / "out.npz")


def test_main_verify_and_north_star_convert_a_raw_pth(tmp_path, monkeypatch, capsys):
    pth, out = str(tmp_path / "tv.pth"), str(tmp_path / "out.npz")
    torch.save(port.torchvision_state_dict(3), pth)
    assert port.main([pth, out, "--verify", "--device", "cpu"]) == 0
    assert "verify ok: feats (2, 2048), logits (2, 1000)" in capsys.readouterr().out
    converted = north_star.resolve_inception(pth, str(tmp_path / "ns"))
    assert os.path.dirname(converted) == str(tmp_path / "ns")
    with np.load(converted) as a, np.load(out) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.setattr(port, "convert", lambda path: pytest.fail("converted twice"))
    assert north_star.resolve_inception(pth, str(tmp_path / "ns")) == converted
