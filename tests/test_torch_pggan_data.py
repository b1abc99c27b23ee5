"""PGGAN's data layer in the port against the JAX package's, on the CPU:

- host ``FakeImages`` in the ``blobs`` and ``rich`` styles: bit-equal to the
  reference's batches (both draw from ``np.random.default_rng(seed)``);
- ``DeviceFakeImages(style="rich")``: deterministic in ``(seed, k)``, in
  [-1, 1]; ``_compose_rich`` on torch tensors with injected parameters within
  1e-6 of the reference's numpy call (exp and the sums in another library);
- ``box_downsample``: bit-equal to the reference's native C path on float
  inputs, and ``MultiResolution`` to the reference's;
- ``write_pyramid``: bit-equal (uint8) to ``tools/prepack_dataset.py``'s
  ``_pyramid_write`` on the same chunks;
- ``resolve_pyramid_dir``/``open_pyramid``: the reference's errors, and
  batches bit-equal to the reference's;
- ``train_pggan --data``: every choice resolves to the reference's kind of
  source, a plain folder exits with code 2; a ladder to 16^2 at width 1/64
  from a pyramid store reads each phase's own member and resumes bit-equal.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.data import fake as jfake
from gan_lib_tensorflow_tpu.data import multires as jmultires
from gan_lib_tensorflow_tpu.data import native as jnative
from gan_lib_tensorflow_tpu.data import packed as jpacked
from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.cli import train_pggan
from gan_lib_tensorflow_tpu_torch.data import fake as tfake
from gan_lib_tensorflow_tpu_torch.train import to_checkpoint
from gan_lib_tensorflow_tpu_torch.train.pggan_loop import train_pggan_ladder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prepack_tool():
    spec = importlib.util.spec_from_file_location(
        "prepack_dataset", os.path.join(REPO, "tools", "prepack_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --- synthetic images ----------------------------------------------------------

@pytest.mark.parametrize("style", ["blobs", "rich"])
@pytest.mark.parametrize("size,classes", [(16, 10), (9, 1)])
def test_host_fake_images_bit_equal(style, size, classes):
    kw = dict(batch_size=5, image_size=size, num_classes=classes, seed=3, style=style)
    got, want = iter(data.FakeImages(**kw)), iter(jfake.FakeImages(**kw))
    for _ in range(3):
        g, w = next(got), next(want)
        assert g["image"].dtype == np.float32 and g["image"].shape == (5, size, size, 3)
        np.testing.assert_array_equal(g["image"].view(np.uint32), w["image"].view(np.uint32))
        np.testing.assert_array_equal(g["label"], w["label"])


def test_unknown_style_is_refused_as_the_reference_refuses_it():
    for cls in (data.FakeImages, jfake.FakeImages):
        with pytest.raises(ValueError, match="unknown synthetic style 'stripes'"):
            cls(style="stripes")
    with pytest.raises(ValueError, match="unknown synthetic style 'stripes'"):
        data.DeviceFakeImages(style="stripes", device="cpu")


def test_device_rich_is_deterministic_in_seed_and_position():
    src = data.DeviceFakeImages(batch_size=3, image_size=12, num_classes=4, seed=5,
                                n_micro=2, style="rich", device="cpu")
    first = [src.render() for _ in range(3)]
    src.set_stream_position(1)
    again = src.render()
    assert torch.equal(again["image"], first[1]["image"])
    assert torch.equal(again["label"], first[1]["label"])
    assert not torch.equal(first[0]["image"], first[1]["image"])
    other = data.DeviceFakeImages(batch_size=3, image_size=12, num_classes=4, seed=6,
                                  n_micro=2, style="rich", device="cpu").render()
    assert not torch.equal(other["image"], first[0]["image"])
    img = first[0]["image"]
    assert img.shape == (2, 3, 12, 12, 3) and img.dtype == torch.float32
    assert float(img.min()) >= -1 and float(img.max()) <= 1
    assert first[0]["label"].dtype == torch.int32
    # not the blobs style of the same stream
    blobs = data.DeviceFakeImages(batch_size=3, image_size=12, num_classes=4, seed=5,
                                  n_micro=2, device="cpu").render()
    assert not torch.equal(blobs["image"], img)


def test_compose_rich_matches_the_reference():
    rng = np.random.default_rng(9)
    n, s, k = 4, 10, jfake._RICH_BLOBS
    u = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / (s - 1)
    params = dict(lab_color=u(-1, 1, (n, 3)), centers=u(0.15, 0.85, (n, k, 2)),
                  sigmas=u(0.05, 0.16, (n, k, 2)), weights=u(0.3, 1.0, (n, k)),
                  colors=u(-1, 1, (n, k, 3)), bg_color=u(-0.4, 0.4, (n, 3)),
                  bg_dir=u(-1, 1, (n, 2)), noise=0.05 * u(-1, 1, (n, s, s, 3)))
    want = jfake._compose_rich(np, xx[None], yy[None], **params)
    got = tfake._compose_rich(torch, torch.from_numpy(xx), torch.from_numpy(yy),
                              **{key: torch.from_numpy(v) for key, v in params.items()})
    assert got.shape == want.shape == (n, s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- box downsample and the pyramid ----------------------------------------------

@pytest.mark.parametrize("factor", [2, 4, 8])
def test_box_downsample_bit_equal_to_the_native_path(factor):
    assert jnative.available(), "the reference's native tier did not build"
    x = np.random.default_rng(factor).standard_normal((3, 32, 32, 3)).astype(np.float32) * 97.3
    want = jnative.box_downsample(x, factor)
    got = data.box_downsample(x, factor)
    assert got.dtype == np.float32 and got.shape == (3, 32 // factor, 32 // factor, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_multiresolution_matches_the_reference():
    kw = dict(batch_size=2, max_resolution=32, resolution=8, seed=4)
    got, want = iter(data.MultiResolution(**kw)), iter(jmultires.MultiResolution(**kw))
    for _ in range(2):
        g, w = next(got)["image"], next(want)["image"]
        assert g.shape == (2, 8, 8, 3)
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    reseeded = data.MultiResolution(**kw).reseeded(11).at_resolution(16)
    assert reseeded.seed == 11 and reseeded.resolution == 16


def test_write_pyramid_bit_equal_to_the_prepack_tool(tmp_path):
    tool = _prepack_tool()
    res = [32, 16, 8, 4]
    images = _u8((70, 32, 32, 3), 1)  # two of the writer's 64-image chunks
    dirs = data.write_pyramid(str(tmp_path / "pyr"), images, res)
    stores = [np.zeros((70, r, r, 3), np.uint8) for r in res]
    for pos in range(0, 70, 4):
        tool._pyramid_write(stores, [None] * len(res), pos, images[pos:pos + 4], None, res)
    assert list(dirs) == res
    for r, want in zip(res, stores):
        assert dirs[r] == str(tmp_path / "pyr" / f"r{r:04d}")
        got = data.PackedImageStore(dirs[r], batch_size=2)
        np.testing.assert_array_equal(np.asarray(got.images), want)
        assert got.labels is None and got.meta["num_classes"] == 0
    with pytest.raises(ValueError, match="must start at the images' 32 and descend"):
        data.write_pyramid(str(tmp_path / "bad"), images, [32, 4, 8])


def test_write_rich_pyramid_is_the_host_rich_images(tmp_path):
    """The synthetic pyramid holds the host ``rich`` images, mapped to uint8,
    at its top member, and ``write_pyramid``'s levels below it."""
    dirs = data.write_rich_pyramid(str(tmp_path / "rich"), n_images=16, resolution=16,
                                   seed=3)
    assert list(dirs) == [16, 8, 4]
    img = next(iter(jfake.FakeImages(batch_size=16, image_size=16, num_classes=1, seed=3,
                                     style="rich")))["image"]
    u8 = np.clip(np.rint((img + 1.0) * 127.5), 0, 255).astype(np.uint8)
    want = data.write_pyramid(str(tmp_path / "want"), u8, [16, 8, 4])
    for r in (16, 8, 4):
        np.testing.assert_array_equal(
            np.asarray(data.PackedImageStore(dirs[r], batch_size=4).images),
            np.asarray(data.PackedImageStore(want[r], batch_size=4).images))


def test_pyramid_resolution_and_its_errors(tmp_path):
    pyr = str(tmp_path / "pyr")
    data.write_pyramid(pyr, _u8((8, 16, 16, 3), 2), [16, 8, 4])
    for r in (16, 8, 4):
        assert (data.resolve_pyramid_dir(pyr, r) == jpacked.resolve_pyramid_dir(pyr, r)
                == os.path.join(pyr, f"r{r:04d}"))
    single = os.path.join(pyr, "r0008")
    assert data.resolve_pyramid_dir(single, 8) == jpacked.resolve_pyramid_dir(single, 8) == single
    for mod in (data, jpacked):
        with pytest.raises(ValueError, match="is 8px, wanted 16px and no r0016/ member"):
            mod.resolve_pyramid_dir(single, 16)
        with pytest.raises(FileNotFoundError, match="no packed store at"):
            mod.resolve_pyramid_dir(str(tmp_path), 8)
        with pytest.raises(FileNotFoundError, match="no packed store at"):
            mod.open_pyramid(pyr, batch_size=2, resolution=32)
    got = iter(data.open_pyramid(pyr, batch_size=3, resolution=8, seed=1))
    want = iter(jpacked.open_pyramid(pyr, batch_size=3, resolution=8, seed=1))
    for _ in range(4):  # across an epoch boundary (8 images, 2 batches per epoch)
        g, w = next(got)["image"], next(want)["image"]
        assert g.shape == (3, 8, 8, 3)
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


# --- train_pggan --data ------------------------------------------------------------

TINY = ["--device", "cpu", "--width-mul", "0.015625", "--z-dim", "8",
        "--batch-by-res", "4:4,8:4,16:4", "--log-every", "1", "--compute-dtype", "fp32"]


@pytest.mark.parametrize("choice,style", [("auto", "blobs"), ("fake", "blobs"),
                                          ("fake-rich", "rich")])
def test_host_synthetic_choices(choice, style):
    args = train_pggan.parse_args(TINY + ["--data", choice, "--final-resolution", "16"])
    src = train_pggan.source_factory(args)(8, 4)
    assert isinstance(src, data.ThreadedSource) and isinstance(src.source, data.FakeImages)
    assert (src.source.style, src.source.image_size, src.source.batch_size,
            src.source.num_classes) == (style, 8, 4, 1)
    want = next(iter(jfake.FakeImages(batch_size=4, image_size=8, num_classes=1, seed=0,
                                      style=style)))
    np.testing.assert_array_equal(next(iter(src.source))["image"], want["image"])


def test_host_synthetic_source_is_one_ordered_stream_on_a_mesh():
    """On a mesh every rank cuts its rows from the host renderer's batches,
    so they come in a fixed order: two workers taken in turn, with a mesh
    and without one."""
    args = train_pggan.parse_args(TINY + ["--data", "fake", "--final-resolution", "16"])
    assert train_pggan.source_factory(args)(8, 4).num_workers == 2
    make = train_pggan.source_factory(args, mesh=object())
    runs = []
    for _ in range(2):
        it = iter(make(8, 4))
        runs.append(np.stack([next(it)["image"] for _ in range(6)]))
    assert make(8, 4).num_workers == 2
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("choice,style", [("device-fake", "blobs"), ("device-rich", "rich")])
def test_device_synthetic_choices(choice, style):
    args = train_pggan.parse_args(TINY + ["--data", choice])
    src = train_pggan.source_factory(args)(16, 4)
    assert isinstance(src, data.DeviceFakeImages) and src.style == style
    assert src.render()["image"].shape == (1, 4, 16, 16, 3)


def test_pyramid_choice_and_refusals(tmp_path, capsys):
    pyr = str(tmp_path / "pyr")
    data.write_pyramid(pyr, _u8((8, 16, 16, 3), 3), [16, 8, 4])
    args = train_pggan.parse_args(TINY + ["--data", pyr, "--final-resolution", "16"])
    for r in (16, 8, 4):
        src = train_pggan.source_factory(args)(r, 4)
        assert isinstance(src, data.DeviceCachedStore)
        assert src.path == os.path.join(pyr, f"r{r:04d}") and src.image_size == r
    off = train_pggan.parse_args(TINY + ["--data", pyr, "--final-resolution", "16",
                                         "--device-cache", "off"])
    src = train_pggan.source_factory(off)(8, 4)
    assert isinstance(src, data.ThreadedSource) and src.num_workers == 1
    assert src.source.wire_dtype == "uint8" and src.source.path == os.path.join(pyr, "r0008")
    # a single store of the final resolution is a pyramid of one member
    single = train_pggan.parse_args(TINY + ["--data", os.path.join(pyr, "r0016"),
                                            "--final-resolution", "16"])
    assert train_pggan.source_factory(single)(16, 4).image_size == 16
    with pytest.raises(ValueError, match="is 16px, wanted 8px"):
        train_pggan.source_factory(single)(8, 4)
    folder = tmp_path / "images"
    folder.mkdir()
    with pytest.raises(SystemExit) as e:
        train_pggan.parse_args(TINY + ["--data", str(folder)])
    assert e.value.code == 2
    assert "tools/prepack_dataset.py --resolutions" in capsys.readouterr().err
    missing = train_pggan.parse_args(TINY + ["--data", str(tmp_path / "nowhere")])
    with pytest.raises(FileNotFoundError, match="no such directory"):
        train_pggan.source_factory(missing)


class _Interrupted(Exception):
    pass


class _RaiseAfterOne:
    """One batch of the wrapped source, then an interruption."""
    yields_stacks = True

    def __init__(self, inner):
        self.inner = inner

    def set_stream_position(self, pos):
        self.inner.set_stream_position(pos)

    def __iter__(self):
        it = iter(self.inner)
        yield next(it)
        raise _Interrupted()


def _leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (i,))
    else:
        yield path, obj


def test_ladder_from_a_pyramid_reads_each_member_and_resumes(tmp_path):
    pyr = str(tmp_path / "pyr")
    data.write_pyramid(pyr, _u8((12, 16, 16, 3), 4), [16, 8, 4])
    argv = TINY + ["--data", pyr, "--final-resolution", "16", "--steps-per-phase", "2",
                   "--ckpt-every", "1", "--sample-every", "100"]

    def run(out, interrupt_at=None):
        args = train_pggan.parse_args(argv + ["--out-dir", str(out)])
        make, read, current = train_pggan.source_factory(args), [], []

        def hook(when, res, name, st):
            if when == "start":
                current[:] = [(res, name)]

        def factory(res, batch):
            src = make(res, batch)
            read.append((current[0], src.path))
            return _RaiseAfterOne(src) if current[0] == interrupt_at else src

        state = train_pggan_ladder(train_pggan.ladder_config(args), factory, phase_hook=hook)
        return state, read

    straight, read = run(tmp_path / "straight")
    assert read == [((r, n), os.path.join(pyr, f"r{r:04d}")) for r, n in [
        (4, "stabilize"), (8, "transition"), (8, "stabilize"), (16, "transition"),
        (16, "stabilize")]]
    with pytest.raises(_Interrupted):
        run(tmp_path / "run", interrupt_at=(16, "transition"))
    resumed, _ = run(tmp_path / "run")
    got, want = dict(_leaves(to_checkpoint(resumed))), dict(_leaves(to_checkpoint(straight)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v), k
