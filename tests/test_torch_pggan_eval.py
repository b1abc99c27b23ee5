"""PGGAN's eval, sampling and ``--remat-from`` in the port, on the CPU:

- ``--remat-from 8``: one PGGAN step's losses at 16^2 (transition and
  stabilize; the critic's loss with its gradient penalty, whose double
  backward runs through the rematerialized blocks) give G and D gradients
  bit-equal to remat off, while the blocks' forwards do run again;
- ``cli.evaluate --model pggan``: the record's keys equal the reference's on
  the same arguments, with a pyramid store, ``device-rich``, ``auto`` and
  ``fake`` as --data, on a mid-transition checkpoint carried across with
  ``convert.py``; a repeat gives the same record; a flat folder of images
  gives the reference's record keys, and an empty folder the reference's
  ``FileNotFoundError``;
- ``cli.sample --model pggan`` on that mid-transition checkpoint (alpha 0.5):
  equal to the reference's sampler (G built without the fade-in, applied to
  the EMA parameters) on the same z within rtol 1e-5, atol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_lib_tensorflow_tpu.cli import evaluate as jevaluate
from gan_lib_tensorflow_tpu.models import pggan as jpggan
from gan_lib_tensorflow_tpu.train import CheckpointManager as JaxCheckpointManager
from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_pggan
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.train import CheckpointManager
from gan_lib_tensorflow_tpu_torch.train.pggan_loop import LadderConfig, build_phase

WM = 1 / 64


# --- remat ------------------------------------------------------------------------

def _step_grads(remat_from, fade, calls):
    cfg = LadderConfig(final_resolution=16, batch_by_res={16: 4}, width_mul=WM, z_dim=8,
                       fused_from_resolution=8, remat_from_resolution=remat_from,
                       device="cpu")
    ph = build_phase(cfg, 16, "transition" if fade else "stabilize")
    g, d = ph.state.g, ph.state.d
    for net in (g, d):
        for name in ("block_8", "block_16"):
            getattr(net, name).register_forward_pre_hook(lambda *a, n=name: calls.append(n))
    gen = torch.Generator().manual_seed(0)
    real = torch.rand(4, 16, 16, 3, generator=gen) * 2 - 1
    z = torch.randn(2, 4, 8, generator=gen)
    u_gp = torch.rand(4, 1, 1, 1, generator=gen)
    alpha = 0.37 if fade else 1.0
    fake = ph.spec.prepare_fakes(z[:1], alpha)[0]
    d_loss, _ = ph.spec.d_loss(real, fake, alpha, None, u_gp)
    d_grads = torch.autograd.grad(d_loss, list(d.parameters()))
    g_loss, _ = ph.spec.g_loss(z[1], alpha)
    g_grads = torch.autograd.grad(g_loss, list(g.parameters()))
    return d_loss, g_loss, d_grads, g_grads


@pytest.mark.parametrize("fade", [True, False])
def test_remat_gives_bit_equal_grads(fade):
    plain_calls, remat_calls = [], []
    plain = _step_grads(0, fade, plain_calls)
    remat = _step_grads(8, fade, remat_calls)
    assert torch.equal(plain[0], remat[0]) and torch.equal(plain[1], remat[1])
    for a, b in zip(plain[2] + plain[3], remat[2] + remat[3]):
        assert torch.equal(a, b)
    # the rematerialized blocks ran their forwards again in the backward
    assert len(remat_calls) > len(plain_calls)


def test_remat_from_reaches_the_networks():
    args = train_pggan.parse_args(["--device", "cpu", "--remat-from", "512"])
    cfg = train_pggan.ladder_config(args)
    assert cfg.remat_from_resolution == 512
    ph = build_phase(LadderConfig(final_resolution=8, batch_by_res={8: 4}, width_mul=WM,
                                  z_dim=8, remat_from_resolution=8, device="cpu"),
                     8, "transition")
    assert ph.state.g.remat_from == ph.state.d.remat_from == 8
    plain = build_phase(LadderConfig(final_resolution=8, batch_by_res={8: 4}, width_mul=WM,
                                     z_dim=8, device="cpu"), 8, "transition")
    assert ([n for n, _ in ph.state.g.named_parameters()]
            == [n for n, _ in plain.state.g.named_parameters()])
    assert train_pggan.parse_args(["--device", "cpu"]).remat_from == 0


# --- a mid-transition checkpoint in both packages ------------------------------------

def _transition_params(res, z_dim, seed):
    jg = jpggan.PGGANGenerator(resolution=res, fade_in=True, z_dim=z_dim, width_mul=WM)
    return jg.init(jax.random.PRNGKey(seed), jnp.zeros((2, z_dim)), 1.0)["params"]


def _checkpoints(tmp_path, res, z_dim):
    """The same mid-transition G (EMA apart from G, alpha 0.5, step 7) as a
    reference checkpoint and as a port checkpoint (``convert.py``)."""
    params = _transition_params(res, z_dim, 0)
    ema = jax.tree_util.tree_map(lambda a, b: 0.5 * a + 0.5 * b, params,
                                 _transition_params(res, z_dim, 1))
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "torch_ckpt")
    cm = JaxCheckpointManager(jdir)
    cm.save(7, {"g_params": params, "g_state": {}, "ema_params": ema, "step": 7,
                "alpha": jnp.float32(0.5)}, wait=True)
    cm.close()
    as_torch = lambda tree: {k: torch.tensor(np.asarray(v))
                             for k, v in to_torch_names(tree).items()}
    cm = CheckpointManager(tdir)
    cm.save_payload(7, {"step": 7, "alpha": 0.5, "g": as_torch(params),
                        "ema_params": as_torch(ema)}, wait=True)
    cm.close()
    assert f"torgb_{res // 2}.weight" in as_torch(params)
    return jdir, tdir, ema


def test_sample_cli_on_a_mid_transition_checkpoint_is_the_references(tmp_path):
    """The reference samples G built without the fade-in; on the parent the
    port blended at the checkpoint's alpha instead."""
    _, tdir, ema = _checkpoints(tmp_path, 8, 8)
    got = sample.main(["--model", "pggan", "--ckpt-dir", tdir, "--resolution", "8",
                       "--width-mul", str(WM), "--n", "6", "--seed", "5",
                       "--out", str(tmp_path / "grid.png"), "--device", "cpu"])
    z = torch.randn(6, 8, generator=torch.Generator().manual_seed(5))
    jg = jpggan.PGGANGenerator(resolution=8, z_dim=8, width_mul=WM)
    want = np.asarray(jg.apply({"params": ema}, jnp.asarray(z.numpy()), 0.5))
    assert got.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and not the blend at the checkpoint's alpha
    blended = np.asarray(jpggan.PGGANGenerator(resolution=8, fade_in=True, z_dim=8,
                                               width_mul=WM).apply(
        {"params": ema}, jnp.asarray(z.numpy()), 0.5))
    assert np.abs(blended - want).max() > 1e-3


RES, Z = 16, 512  # the reference's eval builds G at its default z 512


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pggan_eval")
    jdir, tdir, _ = _checkpoints(tmp, RES, Z)
    pyr = str(tmp / "pyr")
    imgs = np.random.default_rng(0).integers(0, 256, (8, RES, RES, 3), dtype=np.uint8)
    data.write_pyramid(pyr, imgs, [RES, RES // 2, RES // 4])
    return tmp, jdir, tdir, pyr


def _args(ckpt, data_arg):
    return ["--model", "pggan", "--ckpt-dir", ckpt, "--resolution", str(RES),
            "--width-mul", str(WM), "--n-samples", "40", "--batch-size", "4",
            "--swd-samples", "8", "--data", data_arg]


@pytest.mark.parametrize("source", ["store", "device-rich", "auto", "fake"])
def test_evaluate_record_keys_are_the_references(source, eval_setup, capsys):
    tmp, jdir, tdir, pyr = eval_setup
    data_arg = pyr if source == "store" else source
    out_json = str(tmp / f"{source}.json")
    jevaluate.main(_args(jdir, data_arg) + ["--out-json", out_json])
    with open(out_json) as f:
        want = json.load(f)
    got = evaluate.main(_args(tdir, data_arg) + ["--device", "cpu"])
    assert list(got) == list(want)
    assert got["step"] == want["step"] == 7 and got["resolution"] == RES
    assert 0 <= got["ms_ssim"] <= 1 and got["ms_ssim_pairs"] == want["ms_ssim_pairs"] == 4
    if "swd_avg" in want:
        assert got["swd_images"] == want["swd_images"] == 8
        assert got["swd_desc_dtype"] == want["swd_desc_dtype"] == "float16"
        assert all(np.isfinite(got[k]) for k in got if k.startswith("swd_")
                   and k != "swd_desc_dtype")
    if source == "fake":
        assert "skipping SWD" in capsys.readouterr().out
    again = evaluate.main(_args(tdir, data_arg) + ["--device", "cpu"])
    assert {k: v for k, v in again.items() if k != "swd_seconds"} == {
        k: v for k, v in got.items() if k != "swd_seconds"}


def test_evaluate_refuses_an_image_folder_and_a_wrong_store(eval_setup, tmp_path):
    """An empty folder is refused as the reference refuses it; a folder of
    images is read (the reference's record keys); a store of the wrong
    resolution is refused."""
    _, jdir, tdir, pyr = eval_setup
    folder = tmp_path / "celeba"
    folder.mkdir()
    for ev, ckpt in ((jevaluate, jdir), (evaluate, tdir)):  # as the reference refuses it
        with pytest.raises(FileNotFoundError, match="no images under"):
            ev.main(_args(ckpt, str(folder)) + (["--device", "cpu"] if ev is evaluate else []))
    rng = np.random.default_rng(1)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (RES + 4, RES, 3), np.uint8)).save(
            folder / f"{i}.png" if i % 2 else folder / f"{i}.jpg")
    out_json = str(tmp_path / "ref.json")
    jevaluate.main(_args(jdir, str(folder)) + ["--out-json", out_json])
    with open(out_json) as f:
        want = json.load(f)
    got = evaluate.main(_args(tdir, str(folder)) + ["--device", "cpu"])
    assert list(got) == list(want) and got["swd_images"] == want["swd_images"] == 8
    assert all(np.isfinite(got[k]) for k in got if k.startswith("swd_")
               and k != "swd_desc_dtype")
    with pytest.raises(ValueError, match="is 8px, wanted 16px"):
        evaluate.main(_args(tdir, pyr + "/r0008") + ["--device", "cpu"])
