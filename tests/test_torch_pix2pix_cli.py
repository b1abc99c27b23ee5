"""The port's pix2pix CLI on the CPU at a tiny width (ngf = ndf = 4) and
32^2, float32: train from host synthetic pairs and from a written paired
store (held on the CPU device, and streamed), a faulted run resumed bit-equal
to an uninterrupted one, the test pass with its gallery, the export bundle
reloaded with ``torch.export.load`` against the eager G, and ``cli.sample
--export-dir`` for SNGAN, ACGAN and PGGAN.

The reloaded bundles run the same float32 operations on the same inputs as
the eager modules: they are held equal at rtol 1e-6 / atol 1e-6 (a traced
graph may fuse or reorder an operation)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.cli import sample, train_acgan, train_pix2pix, train_sngan
from gan_lib_tensorflow_tpu_torch.data import packed
from gan_lib_tensorflow_tpu_torch.models import acgan, pix2pix, sngan
from gan_lib_tensorflow_tpu_torch.train import CheckpointManager, to_checkpoint
from gan_lib_tensorflow_tpu_torch.train.export import BUNDLE_FILENAME

TINY = ["--device", "cpu", "--image-size", "32", "--scale-size", "36", "--ngf", "4",
        "--ndf", "4", "--compute-dtype", "fp32", "--log-every", "1"]
N_PAIRS = 5


def _flat(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat(v, path + (i,))
    else:
        yield path, obj


def _bit_equal_states(a, b):
    got, want = dict(_flat(to_checkpoint(a))), dict(_flat(to_checkpoint(b)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pairs") / "store")
    rows, _ = packed.write_store(out, N_PAIRS, 36, 72, 3, paired=True)
    rows[:] = np.random.default_rng(0).integers(0, 256, rows.shape, np.uint8)
    packed.finalize_store(out, rows, None)
    return out


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    """A 4-step run from the store faulted after step 3 and resumed from its
    step-2 checkpoint, and an uninterrupted one."""
    tmp = tmp_path_factory.mktemp("p2p")
    run, straight = str(tmp / "run"), str(tmp / "straight")
    args = TINY + ["--data", store, "--steps", "4", "--ckpt-every", "2",
                   "--sample-every", "2"]
    with pytest.raises(RuntimeError, match="fault injected at step 3"):
        train_pix2pix.main(args + ["--out-dir", run, "--fault-inject-step", "3"])
    resumed = train_pix2pix.main(args + ["--out-dir", run])
    whole = train_pix2pix.main(args + ["--out-dir", straight])
    return run, resumed, whole


def test_train_from_store_resumes_bit_equal(runs):
    """Every leaf: G and D (BN running stats), both Adams, both noise
    generators (the dropout masks' source), the step; the store's stream
    position is the step, so the resumed run saw the same pairs."""
    run, resumed, whole = runs
    assert resumed.step == whole.step == 4
    _bit_equal_states(resumed, whole)
    with open(os.path.join(run, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2, 3, 4]  # 1-2, then 3-4 after the resume
    assert set(log[-1]) == {"step", "d_loss", "g_gan", "g_l1", "g_loss", "sec_per_step"}
    assert all(np.isfinite(v) for r in log for v in r.values())
    with Image.open(os.path.join(run, "samples", "000004.png")) as im:
        assert im.size == (3 * 32, 32)  # input | output | target


def test_train_from_host_fake_and_streamed_store(store, tmp_path):
    st = train_pix2pix.main(TINY + ["--data", "fake", "--steps", "2",
                                    "--out-dir", str(tmp_path / "fake")])
    assert st.step == 2
    st = train_pix2pix.main(TINY + ["--data", store, "--device-cache", "off", "--steps", "1",
                                    "--out-dir", str(tmp_path / "off")])
    assert st.step == 1
    st = train_pix2pix.main(TINY + ["--data", "device-det", "--steps", "1",
                                    "--out-dir", str(tmp_path / "dev")])
    assert st.step == 1


def test_test_mode_gallery_and_metrics(runs, store):
    run, _, _ = runs
    metrics = train_pix2pix.main(TINY + ["--data", store, "--mode", "test",
                                         "--out-dir", run, "--max-test-images", "4"])
    assert metrics["n_examples"] == 4 and metrics["step"] == 4
    assert 0 < metrics["test_l1"] < 2
    with open(os.path.join(run, "test_metrics.json")) as f:
        assert json.load(f) == metrics
    with open(os.path.join(run, "index.html")) as f:
        html = f.read()
    assert html.count("<tr><td>") == 4 and 'src="images/00003-output.png"' in html
    for name in ("00000", "00003"):
        for kind in ("input", "output", "target"):
            with Image.open(os.path.join(run, "images", f"{name}-{kind}.png")) as im:
                assert im.size == (32, 32) and im.mode == "RGB"


def test_export_bundle_equals_the_eager_generator(runs):
    run, _, whole = runs
    path = train_pix2pix.main(TINY + ["--mode", "export", "--out-dir", run])
    assert path == os.path.join(run, "export", BUNDLE_FILENAME)
    raw = CheckpointManager(os.path.join(run, "export")).restore_latest_raw()
    assert raw["step"] == 4
    g = pix2pix.UNetGenerator(32, 4)
    g.load_state_dict(raw["g"])
    for k, v in whole.g.state_dict().items():
        assert torch.equal(g.state_dict()[k], v), k
    masks = g.draw_masks(1, torch.Generator().manual_seed(0))
    x = torch.tanh(torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(1)))
    served = torch.export.load(path).module()(x)
    with torch.no_grad():
        eager = g(x, masks, train=False)
    torch.testing.assert_close(served, eager, rtol=1e-6, atol=1e-6)
    other = g(x, g.draw_masks(1, torch.Generator().manual_seed(1)), train=False)
    assert not torch.allclose(served, other)  # the masks are part of the bundle


def test_non_packed_folder_is_refused(tmp_path):
    """(Its name is from when such folders were refused.) A folder that is
    no store is the reference's ``PairedImageFolder`` (two workers in train
    mode); an empty one is refused with its ``FileNotFoundError``;
    --scale-size below --image-size exits 2."""
    folder = tmp_path / "facades"
    folder.mkdir()
    with pytest.raises(FileNotFoundError, match="no images in"):
        train_pix2pix.main(TINY + ["--data", str(folder), "--out-dir", str(tmp_path / "o")])
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (40, 80, 3), np.uint8)).save(folder / f"{i}.jpg")
    args = train_pix2pix.parse_args(TINY + ["--data", str(folder)])
    src = train_pix2pix.paired_source(args)
    assert isinstance(src.source, data.PairedImageFolder) and src.num_workers == 2
    batch = next(iter(src))
    assert batch["input"].shape == batch["target"].shape == (1, 32, 32, 3)
    assert isinstance(train_pix2pix.paired_source(args, threaded=False), data.PairedImageFolder)
    with pytest.raises(SystemExit) as e:
        train_pix2pix.main(TINY + ["--scale-size", "16"])
    assert e.value.code == 2


@pytest.mark.parametrize("model", ["sngan", "acgan"])
def test_sample_export_dir(model, tmp_path):
    """A checkpoint of the freshly built state (EMA parameters for SNGAN),
    sampled with ``--export-dir``: the bundle equals the sampler."""
    common = ["--device", "cpu", "--data", "fake", "--compute-dtype", "fp32"]
    if model == "sngan":
        args = train_sngan.parse_args(common)
        g, _, _, state = train_sngan.build(args)
        make_sampler = sngan.make_sampler
        with torch.no_grad():  # an EMA apart from G's own parameters
            for t in state.ema_params.values():
                t.mul_(0.5)
    else:
        g, _, _, state = train_acgan.build(train_acgan.parse_args(common))
        make_sampler = acgan.make_sampler
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(0, state, wait=True)
    ckpt.close()
    out = tmp_path / "export"
    sample.main(["--model", model, "--ckpt-dir", str(tmp_path / "ckpt"), "--n", "6",
                 "--out", str(tmp_path / "grid.png"), "--device", "cpu",
                 "--export-dir", str(out)])
    z = torch.randn(6, g.z_dim, generator=torch.Generator().manual_seed(3))
    served = torch.export.load(str(out / BUNDLE_FILENAME)).module()(z)
    want = make_sampler(g)(state, z)
    assert served.shape == (6, 32, 32, 3)
    torch.testing.assert_close(served, want, rtol=1e-6, atol=1e-6)
    raw = CheckpointManager(str(out)).restore_latest_raw()
    assert raw["step"] == 0 and ("ema_params" in raw) == (model == "sngan")


def test_sample_export_refuses_pggan(tmp_path):
    """The PGGAN export, once refused with rc 2, is no longer refused: a
    mid-transition checkpoint (alpha 0.5, an EMA apart from G) exports G
    without the fade-in, as the reference's export does, and the reloaded
    bundle equals the eager sampler ``cli.sample`` returns; the payload keeps
    the checkpoint's parameters, second toRGB included, and its alpha."""
    from gan_lib_tensorflow_tpu_torch.models import pggan
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import LadderConfig, build_phase
    cfg = LadderConfig(final_resolution=8, batch_by_res={4: 4, 8: 4}, width_mul=1 / 64,
                       z_dim=8, device="cpu")
    st = build_phase(cfg, 8, "transition").state
    st.alpha, st.step = 0.5, 3
    with torch.no_grad():
        for t in st.ema_params.values():
            t.mul_(0.5)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, st, wait=True)
    ckpt.close()
    out = tmp_path / "export"
    eager = sample.main(["--model", "pggan", "--ckpt-dir", str(tmp_path / "ckpt"),
                         "--resolution", "8", "--width-mul", str(1 / 64), "--n", "6",
                         "--out", str(tmp_path / "grid.png"), "--device", "cpu",
                         "--export-dir", str(out)])
    z = torch.randn(6, 8, generator=torch.Generator().manual_seed(0))
    served = torch.export.load(str(out / BUNDLE_FILENAME)).module()(z)
    assert served.shape == (6, 8, 8, 3)
    torch.testing.assert_close(served, eager, rtol=1e-6, atol=1e-6)
    g = pggan.PGGANGenerator(resolution=8, z_dim=8, width_mul=1 / 64)
    g.load_state_dict({k: v for k, v in st.ema_params.items() if not k.startswith("torgb_4.")})
    torch.testing.assert_close(eager, g(z).detach(), rtol=0, atol=0)
    raw = CheckpointManager(str(out)).restore_latest_raw()
    assert raw["step"] == 3 and raw["alpha"] == 0.5
    assert "torgb_4.weight" in raw["g"] and "torgb_4.weight" in raw["ema_params"]


def test_train_pix2pix_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks the CUDA-less policy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pix2pix.main(["--data", "fake", "--steps", "1"])
