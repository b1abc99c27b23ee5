"""pix2pix's data layer of the port against the JAX package's: the packed
paired store (host jitter and test pass), its device cache (here on the CPU
device), the policy that picks between them, and the synthetic pairs.

Every comparison is bit for bit (no tolerance): the reference's host jitter
is its native ``crop_flip_normalize`` (a fused multiply-add normalize), which
the port's float64-then-one-rounding normalize reproduces exactly.
"""

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu import data as jdata
from gan_lib_tensorflow_tpu.data import native
from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.data import packed
from gan_lib_tensorflow_tpu_torch.data.fake import edge_map

N, SCALE, CROP = 7, 40, 32


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A paired store of 7 combined A|B rows at scale 40, written by the
    port's ``write_store``; every byte value occurs in it."""
    out = str(tmp_path_factory.mktemp("paired") / "store")
    rows, labels = packed.write_store(out, N, SCALE, 2 * SCALE, 3, paired=True)
    assert labels is None
    rows[:] = np.random.default_rng(3).integers(0, 256, rows.shape, np.uint8)
    rows[0].reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    packed.finalize_store(out, rows, None)
    return out


def _kw(direction, flip, batch_size=2, seed=5):
    return dict(batch_size=batch_size, image_size=CROP, which_direction=direction,
                flip=flip, seed=seed)


def test_native_jitter_is_the_reference():
    assert native.available()  # else the reference divides, 205 bytes differ


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
@pytest.mark.parametrize("flip", [True, False])
def test_packed_paired_batches_equal_the_reference(store, direction, flip):
    ours = iter(data.PackedPairedStore(store, **_kw(direction, flip)))
    ref = iter(jdata.PackedPairedStore(store, **_kw(direction, flip)))
    for _ in range(8):  # 3 batches per epoch: across two epoch boundaries
        a, b = next(ours), next(ref)
        assert set(a) == set(b) == {"input", "target"}
        for k in a:
            assert a[k].shape == (2, CROP, CROP, 3) and a[k].dtype == np.float32
            _bits_equal(a[k], b[k])


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
def test_eval_iter_equals_the_reference(store, direction):
    ours = list(data.PackedPairedStore(store, **_kw(direction, True)).eval_iter())
    ref = list(jdata.PackedPairedStore(store, **_kw(direction, True)).eval_iter())
    assert len(ours) == len(ref) == N
    for a, b in zip(ours, ref):
        assert a["name"] == b["name"]
        _bits_equal(a["input"], b["input"])
        _bits_equal(a["target"], b["target"])
    # AtoB reads the left half as the input, BtoA the right one
    row = np.fromfile(f"{store}/images.u8", np.uint8).reshape(N, SCALE, 2 * SCALE, 3)[0]
    o = (SCALE - CROP) // 2
    half = row[o:o + CROP, (SCALE if direction == "BtoA" else 0) + o:][:, :CROP]
    _bits_equal(ours[0]["input"][0], data.base.normalize_u8_np(half))


def test_paired_store_checks(store, tmp_path):
    single = str(tmp_path / "single")
    imgs, _ = packed.write_store(single, 2, 8, 8, 3)
    packed.finalize_store(single, imgs, None)
    with pytest.raises(ValueError, match="--paired"):
        data.PackedPairedStore(single)
    with pytest.raises(ValueError, match="exceeds the store's scale_size"):
        data.PackedPairedStore(store, image_size=64)
    with pytest.raises(ValueError, match="pairs < batch_size"):
        data.PackedPairedStore(store, batch_size=8, image_size=CROP)


@pytest.mark.parametrize("flip", [True, False])
def test_device_cache_controls_and_batches(store, flip):
    """``controls_for`` is the reference's; a device batch (CPU device) is
    the reference's host jitter of the same controls, bit for bit; the
    stream replays from any position."""
    kw = dict(_kw("BtoA", flip), n_micro=2)
    ours = data.DeviceCachedPairedStore(store, device="cpu", **kw)
    ref = jdata.DeviceCachedPairedStore(store, **kw)
    assert ours.nbytes_resident() == N * SCALE * 2 * SCALE * 3
    rows = np.asarray(jdata.PackedPairedStore(store, **_kw("BtoA", flip)).images)
    for pos in (0, 1, 5, 2**31 - 1):
        got, want = ours.controls_for(pos), ref.controls_for(pos)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        batch = ours.gather(*got)
        idx, oy, ox, fl = got
        for k, x0 in (("input", SCALE), ("target", 0)):
            assert batch[k].shape == (2, 2, CROP, CROP, 3)
            host = np.stack([native.crop_flip_normalize(rows[i], y, x0 + x, CROP, bool(f))
                             for i, y, x, f in zip(idx, oy, ox, fl)])
            _bits_equal(batch[k].reshape(-1, CROP, CROP, 3).numpy(), host)
    assert not flip or any(ours.controls_for(p)[3].any() for p in range(4))
    ours.set_stream_position(5)
    first = next(iter(ours))
    ours.set_stream_position(5)
    again = next(iter(ours))
    for k in first:
        assert torch.equal(first[k], again[k])
        assert torch.equal(first[k], ours.gather(*ours.controls_for(5))[k])


def test_device_cache_matches_the_host_store(store):
    """The port's own host store and its device cache agree for the same
    controls (one code path, ``crop_pairs``)."""
    host = data.PackedPairedStore(store, **_kw("AtoB", True))
    dev = data.DeviceCachedPairedStore(store, device="cpu", **_kw("AtoB", True))
    controls = dev.controls_for(3)
    want = host._crops(*controls)
    got = dev.gather(*controls)
    for k in want:
        _bits_equal(got[k][0].numpy(), want[k])


def test_training_source_policy(store, capsys):
    kw = dict(batch_size=2, image_size=CROP, device="cpu")
    nbytes = N * SCALE * 2 * SCALE * 3
    assert isinstance(data.packed_paired_training_source(store, **kw),
                      data.DeviceCachedPairedStore)
    small = nbytes - 1
    src = data.packed_paired_training_source(store, budget_bytes=small, **kw)
    assert isinstance(src, data.ThreadedSource)
    assert isinstance(src.source, data.PackedPairedStore) and src.num_workers == 1
    assert "streaming" in capsys.readouterr().out
    assert isinstance(data.packed_paired_training_source(store, policy="off", **kw),
                      data.ThreadedSource)
    with pytest.raises(ValueError, match="device-cache budget"):
        data.packed_paired_training_source(store, policy="on", budget_bytes=small, **kw)
    with pytest.raises(ValueError, match=r"auto\|on\|off"):
        data.packed_paired_training_source(store, policy="maybe", **kw)
    batch = next(iter(src))
    assert batch["input"].shape == (2, CROP, CROP, 3) and batch["input"].dtype == np.float32


@pytest.mark.parametrize("det", [False, True])
def test_fake_pairs_equal_the_reference(det):
    ours = iter(data.FakePairedImages(batch_size=2, image_size=32, seed=4,
                                      deterministic_color=det))
    ref = iter(jdata.FakePairedImages(batch_size=2, image_size=32, seed=4,
                                      deterministic_color=det))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b) == {"input", "target"}
        for k in a:
            assert a[k].dtype == np.float32
            _bits_equal(a[k], b[k])


@pytest.mark.parametrize("det", [False, True])
def test_device_fake_pairs(det):
    src = data.DeviceFakePairedImages(batch_size=3, image_size=32, seed=2, n_micro=2,
                                      deterministic_color=det, device="cpu")
    assert src.yields_stacks
    b0, b1 = src.render(), src.render()
    tgt = b0["target"].numpy()
    assert b0["input"].shape == b0["target"].shape == (2, 3, 32, 32, 3)
    # the input is the edge map of its own target, as the host function makes it
    _bits_equal(b0["input"].numpy(), edge_map(tgt))
    assert tgt.min() == -1.0 and tgt.max() <= 1.0 and (b0["input"] > -1).any()
    assert not torch.equal(b0["target"], b1["target"])
    src.set_stream_position(1)
    assert torch.equal(next(iter(src))["target"], b1["target"])
    if det:  # a circle's color is a function of its geometry: within [-1, 1]
        colors = np.unique(tgt.reshape(-1, 3), axis=0)
        assert len(colors) <= 1 + 4 * 6 and np.abs(colors).max() <= 1.0
