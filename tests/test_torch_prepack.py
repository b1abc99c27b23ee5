"""The port's npz prepack (``gan_lib_tensorflow_tpu_torch/tools/
prepack_dataset.py``) against the reference's (``tools/prepack_dataset.py``,
loaded from its file), on the CPU: the same random ``.npz`` files at
``--size 32 --resolutions 32,16,8,4`` (NHWC ``data``, 1-indexed labels across
the files), and one file of CHW rows as the downsampled-ImageNet files hold
them, give byte-equal stores and pyramid members and equal metadata; a
folder of images and ``--paired`` exit 2 naming Pillow."""

import importlib.util
import json
import os

import numpy as np
import pytest

from gan_lib_tensorflow_tpu_torch.tools import prepack_dataset as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_prepack_dataset", os.path.join(REPO, "tools", "prepack_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _npz_dir(path, chw=False):
    os.makedirs(path)
    rng = np.random.default_rng(0)
    for i, n in enumerate((70, 13)):  # the second file's first chunk starts mid-way
        x = rng.integers(0, 256, (n, 32, 32, 3), np.uint8)
        if chw:
            x = x.transpose(0, 3, 1, 2).reshape(n, -1)
        np.savez(os.path.join(path, f"part{i}.npz"), data=x,
                 labels=rng.integers(1, 6, n))  # 1-indexed in every file
    return str(path)


def _store(d):
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    images = np.fromfile(os.path.join(d, "images.u8"), np.uint8)
    return meta, images, np.load(os.path.join(d, "labels.npy"))


@pytest.mark.parametrize("resolutions,chw", [("32,16,8,4", False), (None, True)])
def test_stores_are_byte_equal_to_the_references(ref, tmp_path, resolutions, chw):
    src = _npz_dir(tmp_path / "src", chw)
    extra = ["--resolutions", resolutions] if resolutions else []
    port.main(["--src", src, "--out", str(tmp_path / "port"), "--size", "32",
               "--chunk", "32"] + extra)
    ref.main(["--src", src, "--out", str(tmp_path / "ref"), "--size", "32",
              "--chunk", "32"] + extra)
    members = [f"r{int(r):04d}" for r in resolutions.split(",")] if resolutions else [""]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    for m in members:
        got, want = _store(tmp_path / "port" / m), _store(tmp_path / "ref" / m)
        assert got[0] == want[0] and got[0]["num_classes"] == 5 and got[0]["n"] == 83
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].min() == 0  # shifted from 1-indexed


def test_folders_and_paired_exit_2_naming_pillow(tmp_path, capsys):
    (tmp_path / "imgs" / "cls").mkdir(parents=True)
    (tmp_path / "imgs" / "cls" / "a.jpg").write_bytes(b"jpeg")
    for argv in (["--src", str(tmp_path / "imgs")],
                 ["--src", str(tmp_path / "imgs"), "--paired"]):
        with pytest.raises(SystemExit) as err:
            port.main(argv + ["--out", str(tmp_path / "out"), "--size", "32"])
        assert err.value.code == 2 and "Pillow" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")
