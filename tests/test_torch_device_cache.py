"""The port's device-resident store against the JAX package's, on the CPU:
the index stream (a pure function of ``(seed, pos)``) and the gathered
batches equal the reference's bit for bit; the budget policies, the
sequential real-moment pass, a resumed stream, and ``--data`` resolution in
``cli/common.py`` and the train loop's host-source branch."""

import argparse
import pickle

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu import data as jdata
from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.cli import common
from gan_lib_tensorflow_tpu_torch.data.packed import finalize_store, write_store
from gan_lib_tensorflow_tpu_torch.train.loop import device_batches


def _store(tmp_path, n=40, size=16, labeled=True):
    out = str(tmp_path / "store")
    rng = np.random.default_rng(7)
    images, labels = write_store(out, n, size, size, 3,
                                 classes=[str(c) for c in range(4)] if labeled else None)
    images[:] = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    if labeled:
        labels[:] = rng.integers(0, 4, n).astype(np.int32)
    finalize_store(out, images, labels)
    return out


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_indices_equal_the_reference_across_epochs(tmp_path, seed):
    path = _store(tmp_path)
    ours = data.DeviceCachedStore(path, batch_size=4, n_micro=3, seed=seed, device="cpu")
    ref = jdata.DeviceCachedStore(path, batch_size=4, n_micro=3, seed=seed)
    for pos in [0, 1, 2, 3, 4, 7, 2, 30, 0]:  # 3 steps per epoch; seeks back too
        idx = ours.indices_for(pos)
        assert idx.dtype == np.int32 and idx.shape == (3, 4)
        np.testing.assert_array_equal(idx, ref.indices_for(pos))


def test_gathered_batches_equal_the_reference(tmp_path):
    path = _store(tmp_path)
    ours = data.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=1, device="cpu")
    ref = jdata.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=1)
    assert ours.yields_stacks and ours.nbytes_resident() == 40 * 16 * 16 * 3 + 40 * 4
    it_o, it_r = iter(ours), iter(ref)
    for _ in range(7):  # 5 steps per epoch
        a, b = next(it_o), next(it_r)
        assert a["image"].shape == (2, 4, 16, 16, 3) and a["image"].dtype == torch.float32
        assert a["label"].dtype == torch.int32
        _bits_equal(a["image"].numpy(), b["image"])
        np.testing.assert_array_equal(a["label"].numpy(), np.asarray(b["label"]))


def test_resumed_stream_equals_an_uninterrupted_one(tmp_path):
    path = _store(tmp_path)
    a = data.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=3, device="cpu")
    it = iter(a)
    straight = [next(it) for _ in range(8)]
    b = data.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=3, device="cpu")
    b.set_stream_position(5)
    it_b = iter(b)
    for want in straight[5:]:
        got = next(it_b)
        assert torch.equal(got["image"], want["image"])
        assert torch.equal(got["label"], want["label"])
    # a second iter() continues the instance's stream
    assert torch.equal(next(iter(b))["image"], next(it)["image"])


def test_epoch_has_no_repeats_and_permutation_is_memoized(tmp_path):
    path = _store(tmp_path)
    c = data.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=5, device="cpu")
    per_epoch = 40 // 8
    seen = np.concatenate([c.indices_for(p).reshape(-1) for p in range(per_epoch)])
    assert len(np.unique(seen)) == len(seen)
    order = c._perm_cache[1]
    c.indices_for(1)
    assert c._perm_cache[1] is order
    c.indices_for(per_epoch)
    assert c._perm_cache[0] == 1
    np.testing.assert_array_equal(c.indices_for(0).reshape(-1), seen[:8])


def test_sizes_and_budget_are_checked(tmp_path):
    path = _store(tmp_path, n=8)
    with pytest.raises(ValueError, match="fused-step stack"):
        data.DeviceCachedStore(path, batch_size=4, n_micro=3, device="cpu")
    with pytest.raises(ValueError, match="device-cache budget"):
        data.DeviceCachedStore(path, batch_size=4, max_bytes=100, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        data.DeviceCachedStore(images=np.zeros((8, 4, 4, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="path or an images array"):
        data.DeviceCachedStore(device="cpu")


def test_training_source_policies(tmp_path):
    path = _store(tmp_path)
    kw = dict(batch_size=4, n_micro=2, device="cpu")
    assert isinstance(data.packed_training_source(path, **kw), data.DeviceCachedStore)
    streamed = data.packed_training_source(path, budget_bytes=100, **kw)
    assert isinstance(streamed, data.ThreadedSource) and streamed.num_workers == 1
    assert streamed.source.wire_dtype == "uint8"
    with pytest.raises(ValueError, match="device-cache budget"):
        data.packed_training_source(path, policy="on", budget_bytes=100, **kw)
    assert isinstance(data.packed_training_source(path, policy="off", **kw),
                      data.ThreadedSource)
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        data.packed_training_source(path, policy="maybe", **kw)


def test_sequential_batches_read_the_resident_store(tmp_path):
    path = _store(tmp_path)
    cache = data.DeviceCachedStore(path, batch_size=4, n_micro=2, seed=0, device="cpu")
    host = jdata.PackedImageStore(path, batch_size=4, seed=0)
    cache.set_stream_position(7)
    got = torch.cat(list(cache.sequential_batches(8, 3)))
    assert cache._pos == 7
    from gan_lib_tensorflow_tpu.data import native
    _bits_equal(got.numpy(), native.gather_normalize(host.images, np.arange(24)))
    with pytest.raises(ValueError, match="holds"):
        list(cache.sequential_batches(8, 100))


def _args(**kw):
    base = dict(data="fake", seed=0, device="cpu", device_cache="auto",
                device_cache_gb=2.0)
    return argparse.Namespace(**{**base, **kw})


def _cifar_dir(tmp_path, n=16):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    return str(d)


def test_image_source_resolves_the_data_vocabulary(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GANTPU_DATA_DIR", raising=False)
    src = common.image_source(_args(data="auto"), 4, 32, 10, n_micro=2)
    # the reference's fallback: host blobs behind ThreadedSource
    assert isinstance(src, data.ThreadedSource) and isinstance(src.source, data.FakeImages)
    assert "CIFAR-10 not found" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        common.image_source(_args(data="cifar10"), 4, 32, 10)
    with pytest.raises(FileNotFoundError, match="no such directory"):
        common.image_source(_args(data=str(tmp_path / "nope")), 4, 32, 10)
    with pytest.raises(FileNotFoundError, match="neither a packed store"):
        common.image_source(_args(data=str(tmp_path)), 4, 32, 10)

    cifar = _cifar_dir(tmp_path)
    cached = common.image_source(_args(data=cifar), 4, 32, 10, n_micro=2)
    assert isinstance(cached, data.DeviceCachedStore)
    assert cached.nbytes_resident() == 80 * 3072 + 80 * 4
    ref = jdata.DeviceCachedStore(images=jdata.Cifar10(data_dir=cifar).images,
                                  labels=jdata.Cifar10(data_dir=cifar).labels,
                                  batch_size=4, n_micro=2)
    np.testing.assert_array_equal(cached.indices_for(3), ref.indices_for(3))
    streamed = common.image_source(_args(data=cifar, device_cache="off"), 4, 32, 10)
    assert isinstance(streamed, data.ThreadedSource)
    monkeypatch.setenv("GANTPU_DATA_DIR", cifar)
    assert isinstance(common.image_source(_args(data="cifar10"), 4, 32, 10),
                      data.DeviceCachedStore)

    store = _store(tmp_path, size=32)
    assert isinstance(common.image_source(_args(data=store), 4, 32, 4, n_micro=2),
                      data.DeviceCachedStore)
    with pytest.raises(ValueError, match="trains at 64"):
        common.image_source(_args(data=store), 4, 64, 4)
    with pytest.raises(ValueError, match="32\\^2"):
        common.image_source(_args(data=cifar), 4, 128, 4)


def test_loop_branch_streams_host_batches_through_prefetch(tmp_path):
    """A host source is stacked by n_micro and normalized on the device; an
    on-device source is iterated as it is."""
    cifar = _cifar_dir(tmp_path)
    streamed = common.image_source(_args(data=cifar, device_cache="off"), 4, 32, 10)
    batch = next(device_batches(streamed, 3, torch.device("cpu")))
    assert batch["image"].shape == (3, 4, 32, 32, 3) and batch["image"].dtype == torch.float32
    host = data.Cifar10(batch_size=4, data_dir=cifar, seed=1000003)
    want = [b for _, b in zip(range(3), host)]
    for i, b in enumerate(want):
        assert torch.equal(batch["image"][i], data.normalize_u8(torch.from_numpy(b["image"])))
        assert torch.equal(batch["label"][i], torch.from_numpy(b["label"]))
    fake = data.DeviceFakeImages(batch_size=4, n_micro=3, device="cpu")
    assert next(device_batches(fake, 3, torch.device("cpu")))["image"].shape == (3, 4, 32, 32, 3)


def test_train_sngan_eval_reads_the_resident_store(tmp_path, monkeypatch):
    """``train_sngan --data <cifar dir> --eval-every``: training runs from
    the store held on the device, and the real moments read that store in
    place (``sequential_batches``), not a second upload. Tiny networks and
    ``FixedFeatureNet`` keep it CPU-cheap."""
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan
    from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
    from gan_lib_tensorflow_tpu_torch.models import sngan

    monkeypatch.setattr(sngan, "cifar_generator", lambda compute_dtype=None, num_classes=0:
                        sngan.ResNetGenerator(channels=(8, 8, 8), bottom_ch=8, z_dim=8,
                                              num_classes=num_classes,
                                              compute_dtype=compute_dtype))
    monkeypatch.setattr(sngan, "cifar_discriminator", lambda compute_dtype=None, num_classes=0:
                        sngan.ResNetDiscriminator(channels=(8,) * 4, num_classes=num_classes,
                                                  compute_dtype=compute_dtype))
    monkeypatch.setattr(train_sngan, "InceptionV3Features", lambda params_npz=None,
                        device="cpu": FixedFeatureNet(image_size=32, feature_dim=8,
                                                      device=device))
    reads, uploads = [], []
    inner = data.DeviceCachedStore.sequential_batches
    monkeypatch.setattr(data.DeviceCachedStore, "sequential_batches",
                        lambda self, b, n: reads.append((b, n)) or inner(self, b, n))
    real_source = common.image_source
    monkeypatch.setattr(common, "image_source",
                        lambda *a, **k: uploads.append(a[1:]) or real_source(*a, **k))
    cifar = _cifar_dir(tmp_path, n=40)
    state = train_sngan.main(["--device", "cpu", "--data", cifar, "--steps", "2",
                              "--n-critic", "2", "--batch-size", "4", "--eval-every", "2",
                              "--eval-samples", "100", "--out-dir", str(tmp_path / "run")])
    assert state.step == 2
    assert reads == [(100, 1)] and uploads == [(4, 32, 10)]
