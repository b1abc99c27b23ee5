"""The reference's ``--data`` vocabulary on the port's CLIs, on the CPU.

- Every word the reference's ``cli/common.py:image_source`` takes (the
  source of ``train_sngan`` and ``train_acgan``), ``train_sngan_imagenet``
  and ``cli.evaluate`` take gives the port the reference's kind of source:
  'fake'/'fake-rich' (and 'auto' without CIFAR-10) host ``FakeImages``
  behind ``ThreadedSource``, 'device-fake'/'device-rich' ``DeviceFakeImages``
  in that style, 'cifar10' raises without CIFAR-10; a word of the reference
  never raises in the port.
- The host words' batches equal the reference's ``FakeImages`` draws bit for
  bit, per worker stream (worker ``w`` draws from ``seed + 1000003 (w + 1)``);
  ``cli.evaluate``'s host reals, and its CIFAR-10 reals, equal the
  reference's bit for bit.
- ``ThreadedSource`` delivers ``k = 0, 1, 2, ...`` in a fixed round-robin
  order over its workers, run after run, under a short switch interval and
  workers that sleep at random; a worker's error reaches the consumer at its
  turn, chained.
- Two gloo ranks with ``--data fake`` cut their rows from the same global
  batches as one process (``dryrun.launch``; the ranks import torch only).
"""

import argparse
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.cli import common, evaluate, train_sngan_imagenet
from gan_lib_tensorflow_tpu_torch.dryrun import launch
from gan_lib_tensorflow_tpu_torch.train.loop import device_batches

TESTS = os.path.dirname(os.path.abspath(__file__))
WORDS = ["auto", "fake", "fake-rich", "device-fake", "device-rich"]


def _args(word, **kw):
    base = dict(data=word, seed=3, device="cpu", device_cache="auto", device_cache_gb=2.0,
                batch_size=4, model="sngan", num_classes=0)
    return argparse.Namespace(**{**base, **kw})


def _kind(src):
    """(wrapper, renderer) of a synthetic source in either package."""
    return type(src).__name__, type(getattr(src, "source", src)).__name__


def _style(word):
    return "rich" if word.endswith("-rich") else "blobs"


@pytest.fixture
def no_cifar(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("GANTPU_DATA_DIR", raising=False)


@pytest.mark.parametrize("word", WORDS)
def test_image_source_words_are_the_references(word, no_cifar):
    from gan_lib_tensorflow_tpu.cli import common as jcommon
    got = common.image_source(_args(word), 4, 16, 10, n_micro=2)
    want = jcommon.image_source(_args(word), 4, 16, 10, n_micro=2)
    assert _kind(got) == _kind(want)
    assert _kind(got)[1] in ("FakeImages", "DeviceFakeImages")
    assert getattr(got, "source", got).style == _style(word)


def test_cifar10_word_requires_cifar10(no_cifar):
    from gan_lib_tensorflow_tpu.cli import common as jcommon
    for pkg in (common, jcommon):
        with pytest.raises(FileNotFoundError):
            pkg.image_source(_args("cifar10"), 4, 32, 10)


@pytest.mark.parametrize("word", WORDS)
def test_imagenet_words_are_the_references(word, no_cifar):
    """The reference's ``train_sngan_imagenet`` maps 'auto' to 'fake' and
    hands the synthetic words to ``common.image_source`` at 128^2."""
    from gan_lib_tensorflow_tpu.cli import common as jcommon
    got = train_sngan_imagenet.image_source(_args(word, batch_size=2, num_classes=5),
                                            n_micro=2)
    want = jcommon.image_source(_args("fake" if word == "auto" else word), 2, 128, 5,
                                n_micro=2)
    assert _kind(got) == _kind(want)
    renderer = getattr(got, "source", got)
    assert renderer.style == _style(word)
    assert next(iter(renderer))["image"].shape[-3:] == (128, 128, 3)


@pytest.mark.parametrize("word", ["fake", "fake-rich"])
def test_host_words_draw_the_references_batches_per_worker(word):
    """Batch ``k`` is worker ``k % 2``'s ``k // 2``-th batch, bit-equal to
    the reference's ``FakeImages`` on that worker's seed."""
    from gan_lib_tensorflow_tpu.data import fake as jfake
    style = _style(word)
    src = common.image_source(_args(word), 4, 16, 10)
    it = iter(src)
    got = [next(it) for _ in range(6)]
    for w in range(2):
        want = iter(jfake.FakeImages(batch_size=4, image_size=16, num_classes=10,
                                     seed=3 + 1000003 * (w + 1), style=style))
        for j in range(3):
            ref = next(want)
            np.testing.assert_array_equal(got[2 * j + w]["image"], ref["image"])
            np.testing.assert_array_equal(got[2 * j + w]["label"], ref["label"])


@pytest.mark.parametrize("word", ["auto", "fake", "device-fake", "device-rich"])
def test_evaluate_reals_are_the_references(word, no_cifar):
    """'fake' and 'auto' (no CIFAR-10): the reference's host ``FakeImages``,
    one stream, bit for bit; the device words render on the device."""
    from gan_lib_tensorflow_tpu.data import fake as jfake
    batches, name = evaluate.real_image_batches(_args(word), "cpu", 32)
    first = next(batches)
    assert name == "synthetic" and first.shape == (4, 32, 32, 3)
    if word.startswith("device-"):
        ref = data.DeviceFakeImages(batch_size=4, image_size=32, num_classes=10, seed=3,
                                    style=_style(word), device="cpu")
        np.testing.assert_array_equal(first.numpy(), next(iter(ref))["image"][0].numpy())
    else:
        ref = next(iter(jfake.FakeImages(batch_size=4, image_size=32, seed=3)))
        np.testing.assert_array_equal(first.numpy(), ref["image"])


def test_evaluate_cifar10_reals_are_images(tmp_path, monkeypatch):
    """'cifar10' (and 'auto' when it is found) give image batches, bit-equal
    to the reference's ``Cifar10`` batches."""
    import pickle

    from gan_lib_tensorflow_tpu.data import Cifar10 as JCifar10
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (8, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, 8).tolist()}, f)
    monkeypatch.setenv("GANTPU_DATA_DIR", str(d))
    want = next(iter(JCifar10(batch_size=4, data_dir=str(d), seed=3)))["image"]
    for word in ("cifar10", "auto"):
        batches, name = evaluate.real_image_batches(_args(word), "cpu", 32)
        assert name == "cifar10"
        np.testing.assert_array_equal(next(batches).numpy(), want)


class _Tagged(data.DataSource):
    """Batches that name their worker's seed and their index in its stream;
    each takes a random nap first, so the workers finish out of order."""

    def __init__(self, seed=0, fail_at=None):
        self.batch_size, self.seed, self.fail_at = 1, seed, fail_at

    def __iter__(self):
        rnd = random.Random(self.seed)
        for j in range(10_000):
            time.sleep(rnd.random() * 2e-3)
            if self.fail_at == (self.seed, j):
                raise ValueError(f"worker of seed {self.seed} fails at {j}")
            yield {"image": np.array([self.seed, j])}


def test_threaded_source_is_round_robin_under_stress():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seeds = [1000003 * (w + 1) for w in range(4)]
        want = [[seeds[k % 4], k // 4] for k in range(40)]
        for _ in range(3):
            it = iter(data.ThreadedSource(_Tagged(), num_workers=4, depth=3))
            assert [next(it)["image"].tolist() for _ in range(40)] == want
            it.close()
        src = data.ThreadedSource(_Tagged(fail_at=(seeds[1], 2)), num_workers=4, depth=3)
        it = iter(src)
        got = [next(it)["image"].tolist() for _ in range(9)]  # k = 9 is the failing batch
        assert got == want[:9]
        with pytest.raises(RuntimeError, match="worker failed") as err:
            next(it)
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        sys.setswitchinterval(interval)


# ---- two gloo ranks


def _rank_rows(workdir, word):
    import torch.distributed as dist

    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    mesh = create_mesh(device="cpu")
    src = common.image_source(_args(word), 4, 8, 10, n_micro=2, mesh=mesh)
    it = device_batches(src, 2, torch.device("cpu"), mesh)
    got = [next(it) for _ in range(3)]
    np.savez(os.path.join(workdir, f"rows{dist.get_rank()}.npz"),
             **{k: np.stack([b[k].numpy() for b in got]) for k in ("image", "label")})


def test_two_ranks_cut_their_rows_from_the_same_global_batches(tmp_path):
    launch("test_torch_data_vocab:_rank_rows", 2, str(tmp_path),
           {"workdir": str(tmp_path), "word": "fake"}, timeout=120, pythonpath=TESTS)
    one = device_batches(common.image_source(_args("fake"), 4, 8, 10, n_micro=2), 2,
                         torch.device("cpu"))
    whole = [next(one) for _ in range(3)]
    ranks = [np.load(tmp_path / f"rows{r}.npz") for r in range(2)]
    for k in ("image", "label"):
        want = np.stack([b[k].numpy() for b in whole])       # [3, n_micro, 4, ...]
        got = np.concatenate([r[k] for r in ranks], axis=2)  # rows 0-1, then 2-3
        np.testing.assert_array_equal(got, want)
