"""Data parallelism of every family of the port against its one-rank run,
and what the sharded run rests on: the sharded eval, the rank's rows of
every data source, checkpoints across world sizes, and the CLIs under
several ranks.

Ranks are CPU processes in a gloo group (``dryrun.launch``: a ``FileStore``
in ``tmp_path``, one thread each, a time limit per spawn) that import torch
only and write ``.npz`` files; the one-rank run is made here, in the test's
process, from the same seed. Every draw of a sharded step is made at the
global batch and sliced, so both runs draw the same numbers; they differ
only in the order of the sums that cross ranks.

Tolerances (float32): metrics rtol 1e-4 / atol 1e-5. Parameters after an
Adam update: within 2 * lr of each other everywhere (Adam's first update
is about lr * sign(g), and a gradient element near 0 can change sign with
the summation order; ``tests/test_torch_step.py`` explains the bound) and
within 1e-6 on all but a handful of elements. The eval moments rtol 1e-5 /
atol 1e-7. Data batches and checkpoint shards: bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.dryrun import launch

TESTS = os.path.dirname(os.path.abspath(__file__))


def _run(target, world, workdir, **kwargs):
    launch(f"test_torch_dp_families:{target}", world, str(workdir),
           {"workdir": str(workdir), **kwargs}, timeout=150, pythonpath=TESTS)


def _close(a, b, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------------------------ the families


def _family(name):
    """G, D, spec, global batch and Adam settings of one family, small."""
    from gan_lib_tensorflow_tpu_torch.models import acgan, pggan, pix2pix
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    if name == "pggan":
        g = pggan.PGGANGenerator(resolution=8, fade_in=True, z_dim=16, width_mul=1 / 32)
        d = pggan.PGGANDiscriminator(resolution=8, fade_in=True, width_mul=1 / 32)
        spec = pggan.make_pggan_spec(g, d, ema_decay=0.999)
        batch = {"image": t(np.tanh(rng.standard_normal((1, 4, 8, 8, 3))))}
        kw = dict(lr=1e-3, beta2=0.99, ema_decay=0.999)
    elif name == "acgan":
        g, d = acgan.ACGANGenerator(base_ch=32, z_dim=16), acgan.ACGANDiscriminator(base_ch=8)
        spec = acgan.make_acgan_spec(g, d)
        batch = {"image": t(np.tanh(rng.standard_normal((1, 4, 32, 32, 3)))),
                 "label": torch.from_numpy(rng.integers(0, 10, (1, 4)).astype(np.int32))}
        kw = dict(beta1=0.5, beta2=0.999)
    else:
        g, d = pix2pix.UNetGenerator(32, base_ch=4), pix2pix.PatchGANDiscriminator(base_ch=4)
        spec = pix2pix.make_pix2pix_spec(g, d)
        batch = {k: t(np.tanh(rng.standard_normal((1, 2, 32, 32, 3))))
                 for k in ("input", "target")}
        kw = dict(beta1=0.5, beta2=0.999)
    return g, d, spec, batch, kw


def _family_step(name, mesh=None):
    from gan_lib_tensorflow_tpu_torch.parallel import shard_batch
    from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step
    g, d, spec, batch, kw = _family(name)
    state = create_state(g, d, device="cpu", mesh=mesh, **kw)
    if name == "pggan":
        state.alpha = 0.5
    metrics = make_train_step(spec)(state, shard_batch(batch, mesh, 1))
    out = {f"m/{k}": float(v) for k, v in metrics.items()}
    for net in ("g", "d"):
        out.update({f"{net}/{k}": v.detach().numpy().copy()
                    for k, v in getattr(state, net).state_dict().items()})
        opt = getattr(state, f"{net}_opt")
        out.update({f"{net}_mu/{k}": opt.state[p]["exp_avg"].numpy().copy()
                    for k, p in getattr(state, net).named_parameters()})
    return out, kw


def _family_rank(workdir, name):
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    mesh = create_mesh(device="cpu")
    out, _ = _family_step(name, mesh)
    np.savez(os.path.join(workdir, f"out{mesh.rank}.npz"), **out)


@pytest.mark.parametrize("name", ["pggan", "acgan", "pix2pix"])
def test_family_dp_step_matches_one_rank(name, tmp_path):
    """PGGAN: minibatch stddev over the global batch, the penalty's u drawn
    globally, the fade-in; ACGAN: D's dropout masks drawn globally over
    [real; fake]; pix2pix: batch norm at one image per rank."""
    _run("_family_rank", 2, tmp_path, name=name)
    ref, kw = _family_step(name)
    lr = kw.get("lr", 2e-4)
    scale = {net: max(np.abs(v).max() for k, v in ref.items() if k.startswith(f"{net}_mu/"))
             for net in ("g", "d")}
    for rank in range(2):
        got = dict(np.load(tmp_path / f"out{rank}.npz"))
        assert set(got) == set(ref)
        n_far = n_all = 0
        for k, v in ref.items():
            net, _, name = k.partition("/")
            if net == "m":
                _close(got[k], v, msg=k)
                continue
            if net.endswith("_mu"):  # slots relative to the net's largest entry
                _close(got[k] / scale[net[0]], v / scale[net[0]], 1e-3, 1e-5, k)
                continue
            diff = np.abs(got[k] - v)
            assert diff.max() <= 2 * lr + 1e-5, k
            # a conv bias that feeds a batch norm has a gradient of rounding
            # noise in both runs (tests/test_torch_step.py): its sign is noise
            if f"{net}_mu/{name}" in ref and np.abs(ref[f"{net}_mu/{name}"]).max() <= 1e-4 * scale[net]:
                continue
            n_far += int((diff > 1e-6).sum())
            n_all += diff.size
        assert n_far <= max(10, n_all // 1000), (n_far, n_all)


# ------------------------------------------------------------ sharded eval


def _eval_net():
    from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
    return FixedFeatureNet(image_size=8, feature_dim=16, device="cpu")


def _eval(mesh=None):
    """IS/FID moments of 3 batches of 8 from a fixed 'generator' (z -> a
    tanh of a fixed map), each rank sampling and featurizing its rows."""
    from gan_lib_tensorflow_tpu_torch.eval.metrics import DeviceEvalAccumulator
    from gan_lib_tensorflow_tpu_torch.parallel import shard_batch
    proj = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 8 * 8 * 3)).astype(np.float32))
    acc = DeviceEvalAccumulator(_eval_net(), 16, splits=4, split_size=6, mesh=mesh)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        z = shard_batch(torch.randn(8, 4, generator=gen), mesh)
        acc.add_images(torch.tanh(z @ proj).view(-1, 8, 8, 3))
    mu, cov = acc.moments()
    return mu, cov, np.array(acc.inception_score()), acc.count


def _eval_rank(workdir):
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    mesh = create_mesh(device="cpu")
    mu, cov, is_, n = _eval(mesh)
    np.savez(os.path.join(workdir, f"eval{mesh.rank}.npz"), mu=mu, cov=cov, is_=is_, n=n)


def test_sharded_eval_moments(tmp_path):
    """Every rank gets the one-rank moments and IS (the splits cut across
    the ranks' rows: 6 samples per split, 4 rows per rank)."""
    _run("_eval_rank", 2, tmp_path)
    mu, cov, is_, n = _eval()
    for rank in range(2):
        got = np.load(tmp_path / f"eval{rank}.npz")
        assert int(got["n"]) == n == 24
        _close(got["mu"], mu, 1e-5, 1e-7)
        _close(got["cov"], cov, 1e-5, 1e-7)
        _close(got["is_"], is_, 1e-5, 1e-7)


# ------------------------------------------------------------ data sources


def _sources(workdir, mesh=None):
    """Two batches of each source kind, on this rank's rows."""
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    kinds = {
        "blobs": data.DeviceFakeImages(batch_size=4, image_size=8, n_micro=2,
                                       device="cpu", mesh=mesh),
        "rich": data.DeviceFakeImages(batch_size=4, image_size=8, n_micro=2, style="rich",
                                      device="cpu", mesh=mesh),
        "paired": data.DeviceFakePairedImages(batch_size=4, image_size=8, n_micro=2,
                                              device="cpu", mesh=mesh),
        "cached": data.DeviceCachedStore(os.path.join(workdir, "store"), batch_size=4,
                                         n_micro=2, device="cpu", mesh=mesh),
        "cached_paired": data.DeviceCachedPairedStore(
            os.path.join(workdir, "paired"), batch_size=4, image_size=8, n_micro=2,
            device="cpu", mesh=mesh),
        "host": data.FakeImages(batch_size=4, image_size=8),
    }
    out = {}
    for kind, src in kinds.items():
        it = device_batches(src, 2, "cpu", mesh)
        for i in range(2):
            for k, v in next(it).items():
                out[f"{kind}/{i}/{k}"] = v.numpy()
    return out


def _sources_rank(workdir):
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    mesh = create_mesh(device="cpu")
    np.savez(os.path.join(workdir, f"src{mesh.rank}.npz"), **_sources(workdir, mesh))


def test_rank_batches_are_the_one_rank_batch_bit_for_bit(tmp_path):
    from gan_lib_tensorflow_tpu_torch.data import packed
    rng = np.random.default_rng(7)
    images, labels = packed.write_store(str(tmp_path / "store"), 24, 8, 8,
                                        classes=[str(i) for i in range(10)])
    images[:] = rng.integers(0, 256, images.shape, np.uint8)
    labels[:] = rng.integers(0, 10, len(labels))
    packed.finalize_store(str(tmp_path / "store"), images, labels)
    pairs, _ = packed.write_store(str(tmp_path / "paired"), 24, 10, 20, paired=True)
    pairs[:] = rng.integers(0, 256, pairs.shape, np.uint8)
    packed.finalize_store(str(tmp_path / "paired"), pairs, None)
    _run("_sources_rank", 2, tmp_path)
    ref = _sources(str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"src{r}.npz")) for r in range(2)]
    assert set(ranks[0]) == set(ref) and len(ref) == 24
    for k, v in ref.items():
        np.testing.assert_array_equal(np.concatenate([r[k] for r in ranks], axis=1), v,
                                      err_msg=k)


def test_a_batch_that_does_not_divide_is_refused():
    from types import SimpleNamespace

    from gan_lib_tensorflow_tpu_torch import data
    mesh = SimpleNamespace(size=lambda axis: 2 if axis == "data" else 1,
                           coord=lambda axis: 0)
    with pytest.raises(ValueError, match="not divisible by data-mesh size 2"):
        data.DeviceFakeImages(batch_size=3, image_size=8, device="cpu", mesh=mesh)


# ------------------------------------------------------------ checkpoints


def _ckpt_rank(workdir, phase):
    """'save': DP x TP (1 x 2) SNGAN, one step, a checkpoint, and the shards
    this rank held; 'restore': a fresh state restored from that checkpoint
    must hold the same shards."""
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    from gan_lib_tensorflow_tpu_torch.train import (CheckpointManager, create_state,
                                                    make_train_step)
    mesh = create_mesh((1, 2), ("data", "model"), device="cpu")
    g = sngan.ResNetGenerator(channels=(32, 32), bottom_ch=32, z_dim=8)
    d = sngan.ResNetDiscriminator(channels=(32, 32, 32), downsample=(True, True, False))
    spec = sngan.make_sngan_spec(g, d, n_critic=1, ema_decay=0.99)
    state = create_state(g, d, ema_decay=0.99, device="cpu", mesh=mesh, min_features=32,
                         seed=1 if phase == "restore" else 0)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"))
    if phase == "save":
        images = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (1, 4, 16, 16, 3)).astype(np.float32))
        make_train_step(spec)(state, {"image": images})
        ckpt.save(1, state, wait=True)
    else:
        assert ckpt.restore_latest(state) is not None
    held = {}
    for net in ("g", "d"):
        sh = getattr(state, f"{net}_shards")
        opt = getattr(state, f"{net}_opt")
        for n, m in sh.masters.items():
            held[f"{net}/{n}"] = m.detach().numpy()
            held[f"{net}_mu/{n}"] = opt.state[m]["exp_avg"].numpy()
            held[f"{net}_nu/{n}"] = opt.state[m]["exp_avg_sq"].numpy()
    held.update({f"ema/{n}": t.numpy() for n, t in state.ema_params.items()})
    np.savez(os.path.join(workdir, f"{phase}{mesh.rank}.npz"), **held)
    ckpt.close()


def test_checkpoint_written_at_two_ranks_restores_at_one_and_at_two(tmp_path):
    """Rank 0 writes the one-rank format (the shards gathered); a one-rank
    state restores it; each rank of a new 'model' pair restores its own
    shards of it, bit for bit. Each rank held half of every wide leaf, of
    both Adam slots and of the EMA."""
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.train import CheckpointManager, create_state
    _run("_ckpt_rank", 2, tmp_path, phase="save")
    _run("_ckpt_rank", 2, tmp_path, phase="restore")
    raw = CheckpointManager(str(tmp_path / "ckpt")).restore_latest_raw()
    g = sngan.ResNetGenerator(channels=(32, 32), bottom_ch=32, z_dim=8)
    d = sngan.ResNetDiscriminator(channels=(32, 32, 32), downsample=(True, True, False))
    one = create_state(g, d, ema_decay=0.99, device="cpu")
    assert CheckpointManager(str(tmp_path / "ckpt")).restore_latest(one) is not None
    assert one.step == 1
    full = {}
    for net in ("g", "d"):
        names = [n for n, _ in getattr(one, net).named_parameters()]
        for idx, st in raw[f"{net}_opt"]["state"].items():
            full[f"{net}_mu/{names[idx]}"] = st["exp_avg"].numpy()
            full[f"{net}_nu/{names[idx]}"] = st["exp_avg_sq"].numpy()
        full.update({f"{net}/{k}": v.numpy() for k, v in raw[net].items()})
    full.update({f"ema/{k}": v.numpy() for k, v in raw["ema_params"].items()})
    n_wide = 0
    for rank in range(2):
        saved = dict(np.load(tmp_path / f"save{rank}.npz"))
        restored = dict(np.load(tmp_path / f"restore{rank}.npz"))
        assert set(saved) == set(restored)
        for k, v in saved.items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
            ref = full[k]
            if v.shape != ref.shape:
                n_wide += 1
                h = ref.shape[0] // 2
                assert v.shape[0] == h, k
                np.testing.assert_array_equal(v, ref[rank * h:(rank + 1) * h], err_msg=k)
            else:
                np.testing.assert_array_equal(v, ref, err_msg=k)
    # every wide G/D weight: its value, both slots; G's also in the EMA
    assert n_wide > 0 and n_wide % 2 == 0


# ------------------------------------------------------------ the CLIs


PGGAN_ARGV = ["--device", "cpu", "--data", "device-fake", "--final-resolution", "8",
              "--width-mul", "0.015625", "--z-dim", "8", "--batch-by-res", "4:4,8:4",
              "--steps-per-phase", "2", "--compute-dtype", "fp32", "--log-every", "1"]
SNGAN_ARGV = ["--device", "cpu", "--data", "fake", "--batch-size", "2", "--n-critic", "1",
              "--steps", "2", "--compute-dtype", "fp32", "--log-every", "1"]


def _cli_rank(workdir, module, argv):
    import importlib
    importlib.import_module(f"gan_lib_tensorflow_tpu_torch.cli.{module}").main(argv)


def _logs(out_dir):
    found = {}
    for root, _, files in os.walk(out_dir):
        if "log.jsonl" in files:
            with open(os.path.join(root, "log.jsonl")) as f:
                found[os.path.relpath(root, out_dir)] = [
                    {k: v for k, v in json.loads(line).items() if k != "sec_per_step"}
                    for line in f]
    return found


@pytest.mark.parametrize("module,argv,world", [
    ("train_pggan", PGGAN_ARGV, 2),
    ("train_sngan", SNGAN_ARGV + ["--tp-shards", "2"], 2),
])
def test_cli_under_ranks_logs_the_one_rank_losses(module, argv, world, tmp_path):
    """The CLI under ``world`` ranks logs the one-rank run's losses (rank 0
    writes ``log.jsonl``): PGGAN through the whole 4 -> 8 ladder under DP,
    SNGAN CIFAR-10 at full width with its 256-wide G sharded over 'model'."""
    import importlib
    _run("_cli_rank", world, tmp_path, module=module,
         argv=argv + ["--out-dir", str(tmp_path / "ranks")])
    one_argv = [a for i, a in enumerate(argv)
                if a != "--tp-shards" and (i == 0 or argv[i - 1] != "--tp-shards")]
    importlib.import_module(f"gan_lib_tensorflow_tpu_torch.cli.{module}").main(
        one_argv + ["--out-dir", str(tmp_path / "one")])
    got, ref = _logs(tmp_path / "ranks"), _logs(tmp_path / "one")
    assert set(got) == set(ref) and ref
    for phase, lines in ref.items():
        assert len(got[phase]) == len(lines)
        for a, b in zip(got[phase], lines):
            assert set(a) == set(b)
            for k in b:
                _close(a[k], b[k], 1e-4, 1e-5, f"{phase} {k}")


# ------------------------------------------------------------ IS/FID CLIs


def _tiny_clis():
    """Tiny SNGAN networks and the cheap extractor in the CLIs (as
    ``tests/test_torch_evaluate_cli.py`` patches them)."""
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_sngan
    from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet
    from gan_lib_tensorflow_tpu_torch.models import sngan
    net = lambda params_npz=None, device="cpu": FixedFeatureNet(
        image_size=32, feature_dim=16, device=device)
    sngan.cifar_generator = lambda compute_dtype=None, num_classes=0: sngan.ResNetGenerator(
        channels=(16, 16, 16), bottom_ch=16, z_dim=16, compute_dtype=compute_dtype)
    sngan.cifar_discriminator = lambda compute_dtype=None, num_classes=0: (
        sngan.ResNetDiscriminator(channels=(16,) * 4, compute_dtype=compute_dtype))
    train_sngan.InceptionV3Features = evaluate.InceptionV3Features = net
    return train_sngan, evaluate


TRAIN_EVAL = ["--device", "cpu", "--data", "fake", "--steps", "4", "--n-critic", "2",
              "--batch-size", "4", "--eval-every", "2", "--eval-samples", "200",
              "--log-every", "1", "--compute-dtype", "fp32"]
EVALUATE = ["--n-samples", "210", "--batch-size", "100", "--n-real", "200", "--data", "fake",
            "--device", "cpu"]


def _eval_clis_rank(workdir):
    train_sngan, evaluate = _tiny_clis()
    train_sngan.main(TRAIN_EVAL + ["--out-dir", os.path.join(workdir, "ranks")])
    evaluate.main(EVALUATE + ["--ckpt-dir", os.path.join(workdir, "one", "ckpt"),
                              "--out-json", os.path.join(workdir, "eval_ranks.json")])


def test_eval_every_and_evaluate_cli_under_two_ranks(tmp_path, monkeypatch):
    """``train_sngan --eval-every`` and ``cli.evaluate`` on two ranks give
    the one-rank IS/FID: ``cli.evaluate`` of one checkpoint within 1e-5
    (only the order of the sums differs); the periodic eval of a run
    trained on two ranks within 1e-3 (its G differs by the training's own
    summation order)."""
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_sngan
    from gan_lib_tensorflow_tpu_torch.models import sngan
    for mod, names in ((sngan, ("cifar_generator", "cifar_discriminator")),
                       (train_sngan, ("InceptionV3Features",)),
                       (evaluate, ("InceptionV3Features",))):
        for name in names:  # undone after the test
            monkeypatch.setattr(mod, name, getattr(mod, name))
    _tiny_clis()
    train_sngan.main(TRAIN_EVAL + ["--out-dir", str(tmp_path / "one")])
    evaluate.main(EVALUATE + ["--ckpt-dir", str(tmp_path / "one" / "ckpt"),
                              "--out-json", str(tmp_path / "eval_one.json")])
    _run("_eval_clis_rank", 2, tmp_path)
    got, ref = (json.loads((tmp_path / f"eval_{w}.json").read_text()) for w in ("ranks", "one"))
    assert got["samples_evaluated"] == ref["samples_evaluated"] == 200
    for k in ("fid", "inception_score", "inception_score_std"):
        _close(got[k], ref[k], 1e-5, 1.01e-4, k)  # the record rounds to 4 decimals
    scores = lambda d: [r for r in _logs(d)["."] if "fid" in r]
    ranks, one = scores(tmp_path / "ranks"), scores(tmp_path / "one")
    assert [r["step"] for r in ranks] == [r["step"] for r in one] == [2, 4]
    for a, b in zip(ranks, one):
        for k in ("fid", "inception_score"):
            _close(a[k], b[k], 1e-3, 1e-3, k)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    """The port of ``__graft_entry__.dryrun_multichip``: every family's step
    on n CPU ranks (DP x TP 2 x 2 for SNGAN at 4; PGGAN under DP x SP n/2 x
    2, S2D top level), all metrics finite."""
    from gan_lib_tensorflow_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(n, timeout=240)
    out = capsys.readouterr().out
    for name in ("sngan", "device-cached-input", "sharded-eval", "acgan-dp",
                 "pix2pix-dp", "imagenet-dp", "pggan-spatial"):
        assert f"dryrun {name} ok" in out, out
    assert ("'model': 2" in out) == (n == 4)
