"""The port's train -> sample -> evaluate CLIs end to end on the CPU, the
real-moment cache (mirrors tests/test_evaluate_cli.py:78-96,157-181), and the
standard-library PNG writer against the JAX package's PIL grid.

SNGAN runs at a tiny width (``sngan.cifar_generator`` / ``cifar_discriminator``
monkeypatched), and ``FixedFeatureNet`` stands in for InceptionV3, as the JAX
test does, so everything stays CPU-cheap.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from gan_lib_tensorflow_tpu.utils.images import save_image_grid as jax_save_image_grid
from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_sngan
from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
from gan_lib_tensorflow_tpu_torch.models import sngan
from gan_lib_tensorflow_tpu_torch.utils import save_image_grid


def _fixed_net(params_npz=None, device="cpu"):
    return FixedFeatureNet(image_size=32, feature_dim=16, device=device)


@pytest.fixture
def tiny(monkeypatch):
    """Tiny SNGAN networks (32x32 out) and the cheap extractor in every CLI."""
    monkeypatch.setattr(sngan, "cifar_generator", lambda compute_dtype=None, num_classes=0:
                        sngan.ResNetGenerator(channels=(16, 16, 16), bottom_ch=16,
                                              z_dim=16, num_classes=num_classes,
                                              compute_dtype=compute_dtype))
    monkeypatch.setattr(sngan, "cifar_discriminator", lambda compute_dtype=None, num_classes=0:
                        sngan.ResNetDiscriminator(channels=(16,) * 4, num_classes=num_classes,
                                                  compute_dtype=compute_dtype))
    monkeypatch.setattr(train_sngan, "InceptionV3Features", _fixed_net)
    monkeypatch.setattr(evaluate, "InceptionV3Features", _fixed_net)


def test_train_sample_evaluate_on_cpu(tiny, tmp_path, capsys):
    out = tmp_path / "run"
    state = train_sngan.main([
        "--device", "cpu", "--data", "fake", "--steps", "4", "--n-critic", "2",
        "--batch-size", "4", "--out-dir", str(out), "--ckpt-every", "2",
        "--sample-every", "2", "--eval-every", "2", "--eval-samples", "200",
        "--log-every", "1"])
    assert state.step == 4
    assert sorted(os.listdir(out / "ckpt")) == ["step_000002.pt", "step_000004.pt"]
    assert sorted(os.listdir(out / "samples")) == ["sample_000002.png", "sample_000004.png"]
    with Image.open(out / "samples" / "sample_000004.png") as im:
        assert im.size == (8 * 32, 8 * 32) and im.mode == "RGB"  # 64 samples
    with open(out / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log if "d_loss" in r] == [1, 2, 3, 4]
    scores = [r for r in log if "fid" in r]
    assert [r["step"] for r in scores] == [2, 4]
    assert all(np.isfinite(r["fid"]) and r["inception_score"] >= 1.0 for r in scores)
    assert "step 4  " in capsys.readouterr().out  # the logger's printed line

    png = tmp_path / "grid.png"
    sample.main(["--model", "sngan", "--ckpt-dir", str(out / "ckpt"), "--out", str(png),
                 "--n", "16", "--device", "cpu"])
    with Image.open(png) as im:
        assert im.size == (4 * 32, 4 * 32)
        assert np.asarray(im).std() > 0

    out_json = tmp_path / "result.json"
    res = evaluate.main(["--ckpt-dir", str(out / "ckpt"), "--n-samples", "210",
                         "--batch-size", "100", "--n-real", "200", "--data", "fake",
                         "--device", "cpu", "--out-json", str(out_json)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out_json.read_text())
    assert set(line) == {"inception_score", "inception_score_std", "fid",
                         "samples_evaluated", "samples_dropped", "step", "extractor",
                         "real_source"}
    assert line["step"] == 4 and line["samples_evaluated"] == 200
    assert line["samples_dropped"] == 10 and line["real_source"] == "synthetic"
    assert line["extractor"] == "inception_v3_random_init"
    assert np.isfinite(res["fid"]) and res["inception_score"] >= 1.0


def test_real_moments_npz_cache_roundtrip(tmp_path, capsys):
    """First call computes and saves; the second loads without reading any
    data source."""
    net = _fixed_net()
    cache = str(tmp_path / "stats.npz")
    args = types.SimpleNamespace(data="fake", seed=0, batch_size=8, n_real=32,
                                 real_stats_npz=cache, inception_weights=None,
                                 device="cpu")
    (mu1, cov1), src1 = evaluate.real_moments(args, net)
    assert os.path.exists(cache) and src1 == "synthetic"
    poisoned = types.SimpleNamespace(**{**vars(args), "data": "/definitely/not/here",
                                        "device": "no-such-device"})
    (mu2, cov2), _ = evaluate.real_moments(poisoned, net)
    assert "loaded cached real moments" in capsys.readouterr().out
    np.testing.assert_array_equal(mu1, mu2)
    np.testing.assert_array_equal(cov1, cov2)


def test_real_moments_cache_extractor_mismatch_refused(tmp_path):
    net = _fixed_net()
    cache = str(tmp_path / "stats.npz")
    args = types.SimpleNamespace(data="fake", seed=0, batch_size=8, n_real=16,
                                 real_stats_npz=cache, inception_weights=None,
                                 device="cpu")
    evaluate.real_moments(args, net)
    pretrained = types.SimpleNamespace(**{**vars(args), "inception_weights": "w.npz"})
    with pytest.raises(ValueError, match="inception_v3_random_init"):
        evaluate.real_moments(pretrained, net)


def test_real_moments_n_real_below_batch_raises():
    args = types.SimpleNamespace(data="fake", seed=0, batch_size=100, n_real=50,
                                 real_stats_npz=None, inception_weights=None,
                                 device="cpu")
    with pytest.raises(ValueError, match="zero real batches"):
        evaluate.real_moments(args, None)


@pytest.mark.parametrize("model", ["pggan", "acgan", "imagenet"])
def test_evaluate_refuses_families_not_ported(model, tmp_path):
    """Every family's eval is ported now (the SNGAN-projection ``imagenet``,
    ACGAN and, since the PGGAN eval came, PGGAN): none is refused, each gets
    as far as looking for its checkpoint."""
    argv = ["--model", model, "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate.main(argv)


@pytest.mark.parametrize("shape", [(5, 8, 6, 3), (4, 4, 4, 1), (3, 5, 5, 4)])
def test_png_matches_the_jax_packages_grid(shape, tmp_path):
    """The standard-library PNG decodes (with PIL) to the same pixels as
    the reference's PIL-written grid: RGB, grey and RGBA, float and uint8."""
    rng = np.random.default_rng(sum(shape))
    for images in (rng.uniform(-1.2, 1.2, shape).astype(np.float32),
                   rng.integers(0, 256, shape).astype(np.uint8)):
        save_image_grid(images, str(tmp_path / "port.png"))
        jax_save_image_grid(images, str(tmp_path / "jax.png"))
        with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
            assert a.mode == b.mode and a.size == b.size
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sample_cli_pggan_transition_checkpoint(tmp_path):
    """A PGGAN phase checkpoint (here the 8x8 transition's, its second toRGB
    included) samples through cli.sample, with G built without the fade-in
    as the reference builds it."""
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import LadderConfig, train_pggan_ladder
    from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages

    cfg = LadderConfig(final_resolution=8, batch_by_res={4: 4, 8: 4}, width_mul=1 / 64,
                       z_dim=8, steps_per_phase=1, out_dir=str(tmp_path), device="cpu")
    train_pggan_ladder(cfg, lambda res, b: DeviceFakeImages(
        batch_size=b, image_size=res, num_classes=1, device="cpu"))
    png = tmp_path / "pg.png"
    sample.main(["--model", "pggan", "--ckpt-dir", str(tmp_path / "8x8_transition" / "ckpt"),
                 "--resolution", "8", "--width-mul", str(1 / 64),
                 "--n", "4", "--out", str(png), "--device", "cpu"])
    with Image.open(png) as im:
        assert im.size == (16, 16)
    assert torch.load(tmp_path / "8x8_transition" / "ckpt" / "step_000001.pt",
                      weights_only=True)["alpha"] == 1.0
