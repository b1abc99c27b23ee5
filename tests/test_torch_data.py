"""The port's host data layer against the JAX package's, on small synthetic
files: CIFAR-10 pickles, a downsampled-ImageNet npz and a packed store.

The port's sources ship uint8 and normalize on the device; the reference's
ship float32 from its native gather. After the port's normalize the batches
equal the reference's bit for bit (no tolerance), labels too.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu import data as jdata
from gan_lib_tensorflow_tpu.data import native
from gan_lib_tensorflow_tpu.data.packed import finalize_store as j_finalize
from gan_lib_tensorflow_tpu.data.packed import write_store as j_write
from gan_lib_tensorflow_tpu.parallel.prefetch import _u8_normalize
from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.data import packed
from gan_lib_tensorflow_tpu_torch.parallel import prefetch_to_device


def _cifar_dir(tmp_path, n=24):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    return str(d)


def _packed(tmp_path, n=40, size=16, labeled=True, write=packed.write_store,
            finalize=packed.finalize_store):
    out = str(tmp_path / "store")
    rng = np.random.default_rng(7)
    images, labels = write(out, n, size, size, 3,
                           classes=[str(c) for c in range(4)] if labeled else None)
    images[:] = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    if labeled:
        labels[:] = rng.integers(0, 4, n).astype(np.int32)
    finalize(out, images, labels)
    return out


def _take(src, k):
    it = iter(src)
    return [next(it) for _ in range(k)]


def _norm(u8):
    return data.normalize_u8(torch.from_numpy(np.asarray(u8))).numpy()


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_normalize_equals_the_reference_for_every_byte():
    """All 256 byte values: the port's normalize (torch and numpy) against
    the reference's native gather and its jitted device normalize."""
    u8 = np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1)
    want = native.gather_normalize(u8, np.arange(256))
    _bits_equal(np.asarray(_u8_normalize(jnp.asarray(u8))), want)
    _bits_equal(_norm(u8), want)
    _bits_equal(data.base.normalize_u8_np(u8), want)
    # 0 maps to -1; 255 one float32 ulp above 1 (1/127.5 rounds up)
    assert want.min() == -1.0 and want.max() == np.nextafter(np.float32(1), np.float32(2))


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_batches_equal_the_reference(tmp_path, split):
    path = _cifar_dir(tmp_path)
    ours = data.Cifar10(batch_size=16, data_dir=path, split=split, seed=3)
    ref = jdata.Cifar10(batch_size=16, data_dir=path, split=split, seed=3)
    assert ours.images.shape == ((120 if split == "train" else 24), 32, 32, 3)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    for a, b in zip(_take(ours, 9), _take(ref, 9)):  # across epoch boundaries
        assert a["image"].dtype == np.uint8 and a["label"].dtype == np.int32
        _bits_equal(_norm(a["image"]), b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_find_cifar10_env_and_missing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GANTPU_DATA_DIR", raising=False)
    assert data.find_cifar10(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError, match="GANTPU_DATA_DIR"):
        data.Cifar10(data_dir=str(tmp_path / "nope"))
    path = _cifar_dir(tmp_path)
    monkeypatch.setenv("GANTPU_DATA_DIR", path)
    assert data.find_cifar10() == path


def test_imagenet_npz_batches_equal_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    for i in (1, 2):
        np.savez(tmp_path / f"train_data_batch_{i}.npz",
                 data=rng.integers(0, 256, (12, 3 * 16 * 16), np.uint8),
                 labels=rng.integers(1, 11, 12))  # 1-based, flat CHW
    ours = data.ImageNetNpz(str(tmp_path), batch_size=8, image_size=16, seed=2)
    ref = jdata.ImageNetNpz(str(tmp_path), batch_size=8, image_size=16, seed=2)
    assert ours.labels.min() == 0 and ours.images.shape == (24, 16, 16, 3)
    np.testing.assert_array_equal(ours.images, ref.images)
    for a, b in zip(_take(ours, 7), _take(ref, 7)):
        _bits_equal(_norm(a["image"]), b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_packed_store_batches_equal_the_reference(tmp_path, wire):
    path = _packed(tmp_path)
    assert data.is_packed_dir(path) and not data.is_packed_dir(str(tmp_path))
    ours = data.PackedImageStore(path, batch_size=6, seed=4, wire_dtype=wire)
    ref = jdata.PackedImageStore(path, batch_size=6, seed=4)
    assert ours.num_classes == 4 and ours.image_size == 16 and len(ours) == 40
    for a, b in zip(_take(ours, 15), _take(ref, 15)):
        got = a["image"] if wire == "float32" else _norm(a["image"])
        assert a["image"].dtype == np.dtype(wire)
        _bits_equal(got, b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_packed_store_written_by_either_package_reads_the_same(tmp_path):
    ours = _packed(tmp_path / "a")
    ref = _packed(tmp_path / "b", write=j_write, finalize=j_finalize)
    for f in ("meta.json", "images.u8", "labels.npy"):
        with open(os.path.join(ours, f), "rb") as x, open(os.path.join(ref, f), "rb") as y:
            assert x.read() == y.read(), f


def test_packed_store_refusals(tmp_path):
    path = _packed(tmp_path, n=4, labeled=False)
    with pytest.raises(ValueError, match="batch_size"):
        data.PackedImageStore(path, batch_size=8)
    with pytest.raises(ValueError, match="wire_dtype"):
        data.PackedImageStore(path, batch_size=2, wire_dtype="float16")
    with pytest.raises(FileNotFoundError, match="not a packed store"):
        data.PackedImageStore(str(tmp_path), batch_size=2)
    assert "label" not in next(iter(data.PackedImageStore(path, batch_size=2)))


def test_threaded_source_delivers_and_reseeds(tmp_path):
    path = _cifar_dir(tmp_path)
    store = data.Cifar10(batch_size=8, data_dir=path, seed=5)
    one = data.ThreadedSource(store, num_workers=1)
    got = _take(one, 6)
    # one worker: the stream of the store reseeded to seed + 1000003
    want = _take(store.reseeded(5 + 1000003), 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
    two = _take(data.ThreadedSource(store, num_workers=2), 6)
    assert all(b["image"].shape == (8, 32, 32, 3) for b in two)


def test_threaded_source_surfaces_a_worker_error():
    class Broken(data.DataSource):
        batch_size, seed = 2, 0

        def __iter__(self):
            yield {"image": np.zeros((2, 4, 4, 3), np.uint8)}
            raise OSError("disk went away")

    it = iter(data.ThreadedSource(Broken(), num_workers=1))
    next(it)
    with pytest.raises(RuntimeError, match="worker failed") as e:
        next(it)
    assert isinstance(e.value.__cause__, OSError)


def test_microbatch_stack_shapes(tmp_path):
    src = data.Cifar10(batch_size=4, data_dir=_cifar_dir(tmp_path), seed=0)
    b = next(data.microbatch_stack(src, 3))
    assert b["image"].shape == (3, 4, 32, 32, 3) and b["label"].shape == (3, 4)
    first = _take(src, 3)
    np.testing.assert_array_equal(b["image"], np.stack([x["image"] for x in first]))
    assert next(data.microbatch_stack(src, 1))["image"].shape == (1, 4, 32, 32, 3)


def test_prefetch_to_device_normalizes_uint8_on_cpu(tmp_path):
    path = _packed(tmp_path)
    u8 = data.PackedImageStore(path, batch_size=6, seed=5, wire_dtype="uint8")
    host = _take(u8, 3)
    dev = _take(prefetch_to_device(iter(host), "cpu", depth=2), 3)
    for h, d in zip(host, dev):
        assert d["image"].dtype == torch.float32 and d["label"].dtype == torch.int32
        _bits_equal(d["image"].numpy(), np.asarray(_u8_normalize(jnp.asarray(h["image"]))))
        np.testing.assert_array_equal(d["label"].numpy(), h["label"])
    floats = {"image": np.ones((2, 3), np.float32)}
    out = next(prefetch_to_device(iter([floats]), "cpu"))
    assert out["image"].dtype == torch.float32 and torch.equal(out["image"], torch.ones(2, 3))
