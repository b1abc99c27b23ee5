"""The port's npz prepack (``gan_lib_tensorflow_tpu_torch/tools/
prepack_dataset.py``) against the reference's (``tools/prepack_dataset.py``,
loaded from its file), on the CPU: the same random ``.npz`` files at
``--size 32 --resolutions 32,16,8,4`` (NHWC ``data``, 1-indexed labels across
the files), and one file of CHW rows as the downsampled-ImageNet files hold
them, give byte-equal stores and pyramid members and equal metadata; a
folder of class subdirectories and ``--paired`` are packed (byte-equal
there: ``test_torch_image_folders.py``); a folder holding WebP files is
packed byte-equal to the reference tool's store, and a truncated WebP
stops the tool with a ``ValueError`` naming it."""

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


def test_folders_and_paired_exit_2_naming_pillow(ref, tmp_path):
    """(Its name is from when folders and --paired exited 2.) A class folder
    and --paired are packed; a folder with WebP files (lossy, lossless with
    alpha) packs to the reference tool's store bytes; a truncated WebP is
    refused by name."""
    from PIL import Image
    (tmp_path / "imgs" / "cls").mkdir(parents=True)
    Image.fromarray(np.full((40, 64, 3), 90, np.uint8)).save(tmp_path / "imgs" / "cls" / "a.jpg")
    port.main(["--src", str(tmp_path / "imgs"), "--out", str(tmp_path / "out"), "--size", "32"])
    meta, images, labels = _store(tmp_path / "out")
    assert (meta["n"], meta["classes"], images.size, labels.tolist()) == (1, ["cls"], 3072, [0])
    port.main(["--src", str(tmp_path / "imgs"), "--out", str(tmp_path / "pairs"),
               "--size", "32", "--paired"])
    with open(tmp_path / "pairs" / "meta.json") as f:
        assert json.load(f)["paired"] is True
    rng = np.random.default_rng(1)
    (tmp_path / "imgs" / "other").mkdir()
    Image.fromarray(rng.integers(0, 256, (45, 67, 3), np.uint8)).save(
        tmp_path / "imgs" / "cls" / "b.webp", quality=70)
    Image.fromarray(rng.integers(0, 256, (50, 37, 4), np.uint8), "RGBA").save(
        tmp_path / "imgs" / "other" / "c.WEBP", lossless=True)
    args = ["--src", str(tmp_path / "imgs"), "--size", "32"]
    port.main(args + ["--out", str(tmp_path / "w_port")])
    ref.main(args + ["--out", str(tmp_path / "w_ref")])
    got, want = _store(tmp_path / "w_port"), _store(tmp_path / "w_ref")
    assert got[0] == want[0] and got[0]["n"] == 3
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    webp = tmp_path / "imgs" / "cls" / "d.webp"
    webp.write_bytes((tmp_path / "imgs" / "cls" / "b.webp").read_bytes()[:-9])
    with pytest.raises(ValueError, match="d.webp: truncated WebP"):
        port.main(["--src", str(tmp_path / "imgs"), "--out", str(tmp_path / "w"), "--size", "32"])
