"""The reference's logging flags in the port, on the CPU.

- ``ScalarLogger``: the reference's and the port's, fed the same metrics,
  write the same ``log.jsonl`` (every value but the wall-clock
  ``sec_per_step``, which both write at the same steps) and, with
  ``curves``, the same set of curve file names; the port's curves (drawn in
  numpy, written by its zlib PNG writer) decode with Pillow.
- ``tensorboard`` with the import made to fail prints the reference's note
  and goes on; with a stand-in ``SummaryWriter`` both packages make the same
  scalar and image calls (``log_images``: NHWC in [-1, 1] -> [0, 1]).
- ``--curves``, ``--tensorboard`` and ``--compile-cache DIR`` parse on every
  training CLI (a reference command line with them no longer exits 2);
  ``--compile-cache`` prints one note. ``train_sngan --curves`` writes its
  curves; ``train_pix2pix --tensorboard`` logs the inputs, outputs and
  targets of its sample grid.
- ``tools/report_run.py`` (unchanged) reads a port run directory.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from gan_lib_tensorflow_tpu_torch.cli import (common, train_acgan, train_pggan, train_pix2pix,
                                              train_sngan, train_sngan_imagenet)
from gan_lib_tensorflow_tpu_torch.utils.logging import ScalarLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs here are tiny, and in a parallel test
    run several workers' thread pools on the same cores slow them many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
METRICS = [{"d_loss": 1.5 - 0.1 * i, "g_loss": 0.3 * i, "eval/fid": 40.0 - i}
           for i in range(6)]


def _feed(logger, extra_at=3):
    for i, m in enumerate(METRICS):
        logger.log(i + 1, m)
        if i % 2 == 1:
            logger.flush(i + 1, extra={"is": 2.0} if i == extra_at else None)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_log_jsonl_and_curve_names_are_the_references(tmp_path):
    from gan_lib_tensorflow_tpu.utils.logging import ScalarLogger as JScalarLogger
    ours, ref = tmp_path / "port", tmp_path / "ref"
    _feed(ScalarLogger(str(ours), curves=True))
    _feed(JScalarLogger(str(ref), curves=True))
    got, want = _lines(ours / "log.jsonl"), _lines(ref / "log.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "sec_per_step"} == \
               {k: v for k, v in w.items() if k != "sec_per_step"}
    pngs = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".png"))
    assert pngs(ours) == pngs(ref) == ["d_loss.png", "eval_fid.png", "g_loss.png",
                                       "sec_per_step.png"]
    for name in pngs(ours):
        with Image.open(ours / name) as im:
            px = np.asarray(im.convert("RGB"))
        assert px.shape == (300, 600, 3)
        assert (px == 255).mean() > 0.9 and (px[..., 2] > px[..., 0] + 60).any()  # a blue line


def test_tensorboard_unavailable_prints_the_references_note(tmp_path, monkeypatch, capsys):
    from gan_lib_tensorflow_tpu.utils.logging import ScalarLogger as JScalarLogger
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    for cls, sub in ((ScalarLogger, "port"), (JScalarLogger, "ref")):
        logger = cls(str(tmp_path / sub), tensorboard=True)
        out = capsys.readouterr().out
        assert out.startswith("tensorboard logging unavailable: ") and out.count("\n") == 1
        logger.log_images(1, "inputs", np.zeros((1, 4, 4, 3), np.float32))  # a no-op
        logger.log(1, {"d_loss": 1.0})
        logger.flush(1)
        assert capsys.readouterr().out == "step 1  d_loss 1\n"
        assert _lines(tmp_path / sub / "log.jsonl") == [{"step": 1, "d_loss": 1.0}]


class _Writer:
    """A stand-in ``SummaryWriter`` recording its calls."""

    calls = []

    def __init__(self, log_dir):
        self.calls.append(("init", os.path.basename(log_dir)))

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), step))

    def add_images(self, tag, arr, step, dataformats):
        self.calls.append(("images", tag, np.asarray(arr).round(6).tolist(), step, dataformats))

    def flush(self):
        self.calls.append(("flush",))


@pytest.fixture
def stand_in_writer(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    _Writer.calls = []
    return _Writer


def test_tensorboard_calls_are_the_references(tmp_path, stand_in_writer):
    from gan_lib_tensorflow_tpu.utils.logging import ScalarLogger as JScalarLogger
    images = np.linspace(-1.5, 1.5, 2 * 3 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 3)
    calls = []
    for cls, sub in ((ScalarLogger, "port"), (JScalarLogger, "ref")):
        stand_in_writer.calls = []
        logger = cls(str(tmp_path / sub), tensorboard=True)
        _feed(logger)
        logger.log_images(7, "outputs", images)
        calls.append([c for c in stand_in_writer.calls if "sec_per_step" not in c])
    assert calls[0] == calls[1]
    assert ("images", "outputs", np.clip((images + 1) / 2, 0, 1).round(6).tolist(), 7,
            "NHWC") in calls[0]


@pytest.mark.parametrize("cli", [train_sngan, train_acgan, train_sngan_imagenet,
                                 train_pix2pix, train_pggan])
def test_every_training_cli_takes_the_logging_flags(cli, capsys):
    args = cli.parse_args(["--curves", "--tensorboard", "--compile-cache", "/cache/xla"])
    assert args.curves and args.tensorboard and args.compile_cache == "/cache/xla"
    common.configure(args)
    assert capsys.readouterr().out.count("--compile-cache /cache/xla") == 1
    plain = cli.parse_args([])
    assert (plain.curves, plain.tensorboard, plain.compile_cache) == (False, False, None)
    common.configure(plain)
    assert capsys.readouterr().out == ""


SNGAN_CPU = ["--device", "cpu", "--data", "device-fake", "--n-critic", "1", "--batch-size",
             "2", "--log-every", "1", "--sample-every", "1000"]


def test_train_sngan_curves_and_report_run(tmp_path, capsys):
    """Three logged steps draw a curve per metric; ``tools/report_run.py``
    reads the run directory (the port's checkpoints are ``step_*.pt``
    files, which it does not count: it looks for step directories)."""
    out = tmp_path / "run"
    train_sngan.main(SNGAN_CPU + ["--steps", "3", "--curves", "--out-dir", str(out)])
    curves = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert curves == ["d_fake.png", "d_loss.png", "d_real.png", "g_loss.png",
                      "sec_per_step.png"]
    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(REPO, "tools", "report_run.py"))
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    capsys.readouterr()
    rc = report_run.main([str(out), "--json", str(tmp_path / "report.json")])
    printed = capsys.readouterr().out
    assert rc == 0 and "steps 1..3 (3 log rows)" in printed and "flags: none" in printed
    rep = json.loads((tmp_path / "report.json").read_text())
    assert set(rep["losses"]) == {"d_loss", "d_real", "d_fake", "g_loss"}
    assert rep["throughput"]["sec_per_step"]["n"] == 1 and rep["sample_grids"] == 1
    assert rep["checkpoints"] == []


def test_train_pix2pix_logs_its_sample_triple(tmp_path, stand_in_writer):
    train_pix2pix.main(["--device", "cpu", "--image-size", "32", "--scale-size", "36",
                        "--ngf", "4", "--ndf", "4", "--compute-dtype", "fp32",
                        "--data", "fake", "--steps", "2", "--sample-every", "1",
                        "--log-every", "1", "--tensorboard", "--out-dir", str(tmp_path)])
    images = [(c[1], c[3], np.asarray(c[2]).shape) for c in stand_in_writer.calls
              if c[0] == "images"]
    assert images == [(tag, step, (1, 32, 32, 3)) for step in (1, 2)
                      for tag in ("inputs", "outputs", "targets")]
    assert ("init", "tb") in stand_in_writer.calls
