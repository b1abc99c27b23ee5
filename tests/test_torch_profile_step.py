"""``profile_torch_step.py``'s PGGAN step on the CPU, at a small width: the
batches it builds for each ``--data`` that ``train_pggan`` takes are the
train step's own stacks, and one step on them gives finite metrics, so a
change to the meaning of ``--data`` cannot break the profiler unnoticed."""

import importlib.util
import math
import os

import pytest

from gan_lib_tensorflow_tpu_torch.train import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--final-resolution", "8", "--width-mul", "0.015625", "--z-dim", "8",
         "--batch-by-res", "8:3", "--compute-dtype", "fp32"]


def _profiler():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_step", os.path.join(REPO, "profile_torch_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("data", ["fake", "fake-rich", "device-fake", "device-rich"])
def test_pggan_step_runs_on_each_data_choice(data):
    spec, state, batches = _profiler().build_step("pggan", data=data, device="cpu",
                                                  extra=SMALL)
    try:
        batch = next(batches)
        assert tuple(batch["image"].shape) == (spec.n_critic, 3, 8, 8, 3)
        assert state.alpha == 0.5
        metrics = make_train_step(spec)(state, batch)
        assert metrics and all(math.isfinite(float(v)) for v in metrics.values())
    finally:
        batches.close()  # stops a host renderer's worker threads


@pytest.mark.parametrize("s2d_from,top", [(8, "_GenBlockS2D"), (0, "_GenBlock")])
def test_pggan_step_takes_s2d_from(s2d_from, top):
    """``--s2d-from`` reaches the step: the top level on the space-to-depth
    grid at 8 (this test's final resolution), composed at 0; one step on it
    gives finite metrics."""
    spec, state, batches = _profiler().build_step("pggan", device="cpu", extra=SMALL,
                                                  s2d_from=s2d_from)
    assert type(state.g.block_8).__name__ == top
    assert type(state.d.block_8).__name__ == top.replace("Gen", "Disc")
    metrics = make_train_step(spec)(state, next(batches))
    assert all(math.isfinite(float(v)) for v in metrics.values())
