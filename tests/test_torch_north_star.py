"""The port's ``cli.north_star`` asset gating, as the reference's
``tests/test_north_star.py`` holds its own: the graded path refuses to run
without real assets (nothing degrades to synthetic), the resolvers find what
is on disk, and raw InceptionV3 weights are converted in process by the
port's converter (a file it refuses is listed as missing, return code 2)."""

import os

from gan_lib_tensorflow_tpu_torch.cli import north_star


def test_find_cifar_locates_batches_dir(tmp_path):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    (d / "data_batch_1").write_bytes(b"x")
    # both the parent and the dir itself resolve, to the dir of the pickles
    assert north_star.find_cifar(str(tmp_path)) == str(d)
    assert north_star.find_cifar(str(d)) == str(d)
    assert north_star.find_cifar(str(tmp_path / "nope")) is None


def test_resolve_inception_passthrough_and_missing(tmp_path):
    npz = tmp_path / "w.npz"
    npz.write_bytes(b"x")
    assert north_star.resolve_inception(str(npz)) == str(npz)
    assert north_star.resolve_inception(str(tmp_path / "gone.npz")) is None
    assert north_star.resolve_inception(None) is None


def test_graded_run_refuses_without_assets(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the fallback dirs "data", ~/data must not resolve
    monkeypatch.setenv("HOME", str(tmp_path))
    rc = north_star.main(["--out-dir", str(tmp_path / "ns"), "--device", "cpu",
                          "--data-dir", str(tmp_path / "missing")])
    assert rc == 2
    out = capsys.readouterr().out
    assert "CIFAR-10" in out and "InceptionV3 weights" in out
    assert "nothing trained" in out
    assert not os.path.exists(tmp_path / "ns" / "ckpt")


def test_resolve_inception_never_converts_raw_weights(tmp_path, monkeypatch):
    """The reference converts raw weights in a subprocess; the port never
    starts one: it converts in process, and a raw file its converter refuses
    raises, with nothing written."""
    import subprocess

    import pytest

    try:  # importing h5py runs a subprocess of its own: before the patch
        import h5py  # noqa: F401
    except ImportError:
        pass
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: calls.append(a))
    raw = tmp_path / "weights.h5"
    raw.write_bytes(b"v1")
    with pytest.raises((SystemExit, OSError)):
        north_star.resolve_inception(str(raw), str(tmp_path))
    assert calls == [] and os.listdir(tmp_path) == ["weights.h5"]


def test_raw_weights_are_refused_with_rc_2(tmp_path, capsys, monkeypatch):
    """Raw weights that do not convert (here: not weights at all) are
    listed as missing with the converter's reason, and nothing trains."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    cifar = tmp_path / "cifar-10-batches-py"
    cifar.mkdir()
    (cifar / "data_batch_1").write_bytes(b"x")
    for raw in ("inception.h5", "inception.pth"):
        (tmp_path / raw).write_bytes(b"raw")
        rc = north_star.main(["--out-dir", str(tmp_path / "ns"), "--device", "cpu",
                              "--data-dir", str(tmp_path),
                              "--inception-weights", str(tmp_path / raw)])
        assert rc == 2
        out = capsys.readouterr().out
        assert "could not be converted" in out and raw in out
        assert "CIFAR-10:" not in out  # the data was found; only the weights are missing
    assert not os.path.exists(tmp_path / "ns" / "ckpt")


def test_skip_train_without_checkpoint_fails(tmp_path, capsys):
    rc = north_star.main(["--smoke", "--skip-train", "--device", "cpu",
                          "--out-dir", str(tmp_path / "ns")])
    assert rc == 2
    out = capsys.readouterr().out
    assert "--skip-train: no checkpoint" in out
    assert "python -m gan_lib_tensorflow_tpu_torch.cli.north_star --smoke" in out
