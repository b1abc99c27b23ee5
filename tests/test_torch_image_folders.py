"""The port's image-folder route against the JAX package's, on the CPU.

- ``ImageFolderFlat``, ``ImageFolderByClass`` and ``PairedImageFolder``
  (training iterator and ``eval_iter``): batches bit-equal (float32 ``==``,
  int32 labels) to the reference loaders', which decode with Pillow, over the
  same Pillow-written folder and seed;
- ``tools/prepack_dataset``: the folder (class subdirectories and flat,
  ``--resolutions``) and ``--paired`` stores byte-equal to the reference
  tool's (``tools/prepack_dataset.py``, loaded from its file);
- one short run of each CLI on a folder at a few layers and narrow widths:
  ``train_pix2pix`` (train, then ``--mode test``), ``train_sngan_imagenet``,
  ``train_pggan`` and ``cli.evaluate`` (``--model imagenet`` over a class
  folder, ``--model pggan`` over a flat one);
- the committed fixtures ``tests/torch_fixtures/images/`` (made with
  Pillow, but for the Adam7 PNG, which ``test_torch_imgcodec.encode_png``
  writes) and their ``manifest.json``, which ``chip_smoke.py`` holds the
  card's decoder to: the manifest regenerated here with Pillow and the
  reference tool must equal the committed one.

To rewrite the manifest (after a change of fixture or of the loader sizes):
``python tests/test_torch_image_folders.py --manifest``. To rewrite the
fixture images themselves with this Pillow, then the manifest:
``python tests/test_torch_image_folders.py --fixtures``.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gan_lib_tensorflow_tpu_torch import data  # noqa: E402
from gan_lib_tensorflow_tpu_torch.data import packed  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "images")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
# the loaders' sizes: ImageNet-128's and the PGGAN folder ladder's center
# squares, pix2pix's jitter scale and test-mode size per half
SQUARE_SIZES = (128, 256)
HALF_SIZES = (256, 286)
# the stores the card rebuilds from the fixtures (chip_smoke.py phase 18 f)
STORES = {
    "classes": ["--src", "{root}", "--size", "64"],
    "flat_pyramid": ["--src", "{root}/single", "--size", "64", "--resolutions",
                     "64,32,16,8,4"],
    "paired": ["--src", "{root}/combined", "--size", "286", "--paired"],
}


def reference_prepack():
    spec = importlib.util.spec_from_file_location(
        "reference_prepack_dataset", os.path.join(REPO, "tools", "prepack_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def row_digests(rgb: np.ndarray) -> str:
    """The first 8 hex digits of each row's sha256, concatenated: the card
    names the rows where its decode differs (chip_smoke.py phase 18 a)."""
    return "".join(_sha(row)[:8] for row in rgb)


def _scene(h, w, seed, noise):
    """A synthetic photo-like RGB image: gradients, a few discs and bars,
    mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 200 + 30, y / h * 180 + 40, (x + y) / (w + h) * 120 + 60], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.3) * min(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    for _ in range(4):
        x0 = int(rng.integers(0, w))
        img[:, x0:x0 + int(rng.integers(2, 9))] = rng.uniform(0, 255, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(root: str = FIXTURES) -> None:
    """The committed fixture images, made with Pillow."""
    for sub in ("combined", "single"):
        shutil.rmtree(os.path.join(root, sub), ignore_errors=True)
        os.makedirs(os.path.join(root, sub))

    def facade(seed):
        b = _scene(256, 256, seed, 4)
        a = (b // 64 * 64 + 32).astype(np.uint8)  # a flat-coloured label map
        return Image.fromarray(np.concatenate([b, a], axis=1))

    facade(1).save(f"{root}/combined/facade_baseline.jpg", quality=75, subsampling="4:2:0")
    facade(2).save(f"{root}/combined/facade_progressive.jpg", quality=90,
                   subsampling="4:2:0", progressive=True)
    Image.fromarray(_scene(375, 500, 3, 6)).save(
        f"{root}/single/street_422_restart.jpg", quality=85, subsampling="4:2:2",
        restart_marker_rows=2)
    Image.fromarray(_scene(150, 200, 4, 5)).convert("L").save(
        f"{root}/single/grey.jpg", quality=80)
    Image.fromarray(_scene(257, 333, 5, 3)).save(
        f"{root}/single/odd_444.jpg", quality=95, subsampling="4:4:4")
    rgba = np.concatenate([_scene(120, 160, 6, 0), np.full((120, 160, 1), 200, np.uint8)], -1)
    Image.fromarray(rgba).save(f"{root}/single/rgba.png")
    Image.fromarray(_scene(140, 180, 7, 0)).quantize(colors=64).save(f"{root}/single/palette.png")
    # Pillow writes no interlaced PNG: this one comes from the test encoder
    from test_torch_imgcodec import encode_png
    with open(f"{root}/single/adam7.png", "wb") as f:
        f.write(encode_png(_scene(150, 150, 8, 0), 8, 2, interlace=1))


def fixture_files(root: str = FIXTURES):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f != "manifest.json")


def _pillow_square(path, size):
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        s = min(w, h)
        im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        return np.asarray(im.resize((size, size), Image.BILINEAR))


def _pillow_halves(path, size):
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        return [np.asarray(im.crop(box).resize((size, size), Image.BILINEAR))
                for box in ((0, 0, w // 2, h), (w // 2, 0, w, h))]


def build_manifest(root: str, work: str) -> dict:
    """Pillow's decode of every fixture, its crops and resizes at the
    loaders' sizes, and the reference tool's stores, as sha256 digests."""
    from PIL import features
    files = {}
    for rel in fixture_files(root):
        path = os.path.join(root, rel)
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        entry = {"shape": list(rgb.shape), "rgb": _sha(rgb), "rows": row_digests(rgb),
                 "square": {str(s): _sha(_pillow_square(path, s)) for s in SQUARE_SIZES}}
        if rel.startswith("combined"):
            entry["halves"] = {str(s): _sha(np.concatenate(_pillow_halves(path, s), axis=1))
                               for s in HALF_SIZES}
        files[rel] = entry
    ref = reference_prepack()
    stores = {}
    for name, argv in STORES.items():
        out = os.path.join(work, name)
        shutil.rmtree(out, ignore_errors=True)
        ref.main([a.format(root=root) for a in argv] + ["--out", out])
        stores[name] = {"argv": argv, "sha256": packed.store_digest(out)}
    return {"pillow": Image.__version__,
            "libjpeg_turbo": features.version("libjpeg_turbo"),
            "files": files, "stores": stores}


def test_committed_manifest_is_pillows(tmp_path):
    with open(MANIFEST) as f:
        committed = json.load(f)
    assert build_manifest(FIXTURES, str(tmp_path)) == committed
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in fixture_files()) < 260_000


def test_fixtures_decode_as_the_manifest_says():
    """What the card's phase 18 (a) checks, here on the host."""
    from gan_lib_tensorflow_tpu_torch.data import codec
    with open(MANIFEST) as f:
        files = json.load(f)["files"]
    for rel, want in files.items():
        path = os.path.join(FIXTURES, rel)
        rgb = codec.decode_rgb(path)
        assert [list(rgb.shape), _sha(rgb), row_digests(rgb)] == [
            want["shape"], want["rgb"], want["rows"]], rel
        for s, digest in want["square"].items():
            assert _sha(codec.load_square(path, int(s))) == digest, (rel, s)
        for s, digest in want.get("halves", {}).items():
            got = np.concatenate(codec.load_halves(path, int(s)), axis=1)
            assert _sha(got) == digest, (rel, s)


# ---------------------------------------------------------------- loaders

@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A flat folder, a class folder and a paired folder, Pillow-written:
    JPEGs of several kinds and sizes, PNGs, an upper-case extension."""
    root = tmp_path_factory.mktemp("folders")
    for sub in ("flat", "classes/cat", "classes/dog", "classes/empty", "paired"):
        os.makedirs(root / sub)
    kinds = [dict(quality=60, subsampling="4:2:0"), dict(quality=90, progressive=True),
             dict(quality=95, subsampling="4:4:4"), dict(quality=70, subsampling="4:2:2")]
    for i in range(7):
        img = Image.fromarray(_scene(40 + 7 * i, 66 - 3 * i, 10 + i, 5))
        img.save(root / "flat" / f"f{i}.jpg", **kinds[i % 4])
        cls = "cat" if i % 2 else "dog"
        if i % 3:
            img.save(root / "classes" / cls / f"c{i}.JPG", **kinds[(i + 1) % 4])
        else:
            img.save(root / "classes" / cls / f"c{i}.png")
        Image.fromarray(_scene(48, 96, 20 + i, 4)).save(root / "paired" / f"p{i}.jpg",
                                                       **kinds[(i + 2) % 4])
    Image.fromarray(_scene(50, 50, 30, 0)).save(root / "flat" / "g.png")
    (root / "flat" / "notes.txt").write_text("not an image")
    (root / "classes" / "readme.txt").write_text("not a class")
    return root


def _batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind,size,batch,seed", [
    ("ImageFolderFlat", 32, 3, 0), ("ImageFolderFlat", 64, 2, 5),
    ("ImageFolderByClass", 24, 2, 1), ("ImageFolderByClass", 48, 4, 3)])
def test_folder_loaders_are_bit_equal_to_the_references(folders, kind, size, batch, seed):
    from gan_lib_tensorflow_tpu import data as jdata
    path = str(folders / ("flat" if kind == "ImageFolderFlat" else "classes"))
    kw = dict(batch_size=batch, image_size=size, seed=seed)
    ref, port = getattr(jdata, kind)(path, **kw), getattr(data, kind)(path, **kw)
    assert port.files == ref.files
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(5):  # past an epoch boundary
        _batches_equal(next(it_port), next(it_ref))


@pytest.mark.parametrize("direction,flip,seed", [("AtoB", True, 0), ("BtoA", True, 7),
                                                 ("AtoB", False, 2)])
def test_paired_folder_is_bit_equal_to_the_references(folders, direction, flip, seed):
    from gan_lib_tensorflow_tpu import data as jdata
    kw = dict(batch_size=2, image_size=32, scale_size=36, which_direction=direction,
              flip=flip, seed=seed)
    path = str(folders / "paired")
    ref, port = jdata.PairedImageFolder(path, **kw), data.PairedImageFolder(path, **kw)
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(5):
        _batches_equal(next(it_port), next(it_ref))
    n = 0
    for got, want in zip(port.eval_iter(), ref.eval_iter()):
        _batches_equal(got, want)
        n += 1
    assert n == 7


def test_loaders_refuse_as_the_reference_does(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images under"):
        data.ImageFolderFlat(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no class subdirectories"):
        data.ImageFolderByClass(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no images in"):
        data.PairedImageFolder(str(tmp_path / "empty"))
    # fewer images than a batch: the reference's iterator would spin forever
    Image.fromarray(_scene(20, 20, 0, 0)).save(tmp_path / "empty" / "a.png")
    with pytest.raises(ValueError, match="1 images < batch_size 2"):
        data.ImageFolderFlat(str(tmp_path / "empty"), batch_size=2)
    # a file the decoder cannot read fails the batch that holds it, by name
    (tmp_path / "empty" / "b.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 20)
    src = iter(data.ImageFolderFlat(str(tmp_path / "empty"), batch_size=2, image_size=8))
    with pytest.raises(ValueError, match="b.png"):
        next(src)


# ---------------------------------------------------------------- prepack

@pytest.mark.parametrize("sub,extra", [
    ("classes", ["--size", "40"]),
    ("flat", ["--size", "32", "--resolutions", "32,16,8,4", "--chunk", "3"]),
    ("paired", ["--size", "36", "--paired"])])
def test_prepack_stores_are_byte_equal_to_the_references(folders, tmp_path, sub, extra):
    from gan_lib_tensorflow_tpu_torch.tools import prepack_dataset as port
    src = str(folders / sub)
    port.main(["--src", src, "--out", str(tmp_path / "port")] + extra)
    reference_prepack().main(["--src", src, "--out", str(tmp_path / "ref")] + extra)
    assert packed.store_digest(str(tmp_path / "port")) == \
        packed.store_digest(str(tmp_path / "ref"))
    with open(tmp_path / "port" / ("r0032" if "--resolutions" in extra else "")
              / "meta.json") as f:
        meta = json.load(f)
    assert meta["n"] == {"classes": 7, "flat": 8, "paired": 7}[sub]
    assert meta.get("paired", False) == (sub == "paired")


# ---------------------------------------------------------------- CLIs

def test_cli_pix2pix_trains_and_tests_from_a_folder(folders, tmp_path):
    from gan_lib_tensorflow_tpu_torch.cli import train_pix2pix
    tiny = ["--device", "cpu", "--image-size", "32", "--scale-size", "36", "--ngf", "4",
            "--ndf", "4", "--compute-dtype", "fp32", "--data", str(folders / "paired"),
            "--out-dir", str(tmp_path), "--log-every", "1"]
    args = train_pix2pix.parse_args(tiny)
    src = train_pix2pix.paired_source(args)
    assert isinstance(src, data.ThreadedSource) and src.num_workers == 2
    assert isinstance(src.source, data.PairedImageFolder)
    state = train_pix2pix.main(tiny + ["--steps", "2"])
    assert state.step == 2
    metrics = train_pix2pix.main(tiny + ["--mode", "test"])
    assert metrics["n_examples"] == 7 and metrics["step"] == 2
    names = sorted(os.listdir(tmp_path / "images"))
    assert names[:3] == ["p0.jpg-input.png", "p0.jpg-output.png", "p0.jpg-target.png"]


def test_cli_sngan_imagenet_and_evaluate_from_a_class_folder(folders, tmp_path):
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_sngan_imagenet
    out = str(tmp_path / "run")
    narrow = ["--device", "cpu", "--width-mul", "0.015625", "--num-classes", "2"]
    args = train_sngan_imagenet.parse_args(narrow + ["--data", str(folders / "classes"),
                                                     "--batch-size", "2"])
    src = train_sngan_imagenet.image_source(args, 1)
    assert isinstance(src, data.ThreadedSource)
    assert isinstance(src.source, data.ImageFolderByClass) and src.source.image_size == 128
    state = train_sngan_imagenet.main(narrow + [
        "--data", str(folders / "classes"), "--batch-size", "2", "--n-critic", "1",
        "--steps", "1", "--log-every", "1", "--out-dir", out])
    assert state.step == 1
    res = evaluate.main(["--model", "imagenet", "--device", "cpu", "--ckpt-dir",
                         out + "/ckpt", "--width-mul", "0.015625", "--num-classes", "2",
                         "--data", str(folders / "classes"), "--n-samples", "10",
                         "--n-real", "4", "--batch-size", "2"])
    assert res["real_source"] == str(folders / "classes") and np.isfinite(res["fid"])


def test_cli_pggan_ladder_and_evaluate_from_a_flat_folder(folders, tmp_path):
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_pggan
    tiny = ["--device", "cpu", "--final-resolution", "8", "--width-mul", "0.015625",
            "--z-dim", "8", "--batch-by-res", "4:2,8:2", "--steps-per-phase", "1",
            "--data", str(folders / "flat"), "--out-dir", str(tmp_path), "--log-every", "1",
            "--ckpt-every", "1"]
    make = train_pggan.source_factory(train_pggan.parse_args(tiny))
    src = make(4, 2)
    assert isinstance(src, data.ThreadedSource) and isinstance(src.source, data.MultiResolution)
    assert src.source.base.image_size == 8 and src.source.resolution == 4
    assert next(iter(src))["image"].shape == (2, 4, 4, 3)
    state = train_pggan.main(tiny)
    assert state.step == 1 and state.alpha == 1.0
    res = evaluate.main(["--model", "pggan", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path / "8x8_stabilize" / "ckpt"), "--resolution", "8",
                         "--width-mul", "0.015625", "--data", str(folders / "flat"),
                         "--n-samples", "40", "--batch-size", "2"])
    assert res["swd_images"] == 4 and np.isfinite(res["swd_avg"])


if __name__ == "__main__":
    import tempfile
    if "--fixtures" in sys.argv:
        write_fixtures()
    with tempfile.TemporaryDirectory() as work:
        manifest = build_manifest(FIXTURES, work)
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {MANIFEST}")
