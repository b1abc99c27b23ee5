"""``utils/profiler.py`` (``StepTimer``, the ``torch.profiler`` trace),
the train loop's ``--trace-steps`` window and ``--debug-nans``
(``utils/debug_nans.py``).

The trace window copies the reference's (``train/loop.py:160-170,
196-198``): it opens before the step at index ``start + 10`` and closes
after the step at index ``start + 10 + n``, so it holds n + 1 steps.
"""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.cli import common
from gan_lib_tensorflow_tpu_torch.train import LoopConfig, train_loop
from gan_lib_tensorflow_tpu_torch.utils import debug_nans
from gan_lib_tensorflow_tpu_torch.utils.profiler import StepTimer, start_trace, stop_trace


def test_step_timer_divides_by_distinct_cards():
    t = StepTimer(images_per_step=64, n_cards=1, device="cpu")
    t.start()
    for _ in range(3):
        time.sleep(0.01)
        t.tick()
    r = t.stop()
    assert r["steps"] == 3 and r["seconds"] >= 0.03
    assert r["images_per_sec"] == pytest.approx(3 * 64 / r["seconds"])
    assert r["images_per_sec_per_card"] == r["images_per_sec"]
    assert r["sec_per_step"] == pytest.approx(r["seconds"] / 3)
    two = StepTimer(images_per_step=64, n_cards=2, device="cpu")
    two.start()
    two.tick(2)
    r2 = two.stop()
    assert r2["images_per_sec_per_card"] == pytest.approx(r2["images_per_sec"] / 2)


class _Stacks:
    yields_stacks = True
    mesh = None

    def __iter__(self):
        while True:
            yield {"image": torch.zeros(1, 2, 4, 4, 3)}


def _loop(tmp_path, start, total, n):
    state = SimpleNamespace(step=start, g=torch.nn.Linear(2, 2), mesh=None, alpha=1.0)
    seen = []

    def step_fn(st, batch):
        st.step += 1
        seen.append(st.step)
        return {"loss": torch.tensor(1.0)}

    cfg = LoopConfig(total_steps=total, log_every=1000, sample_every=1000,
                     checkpoint_every=1000, out_dir=str(tmp_path), trace_steps=n)
    train_loop(state, step_fn, _Stacks(), cfg)
    path = tmp_path / "trace" / "trace_rank0.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"].split()[1]) for e in events
                  if e.get("name", "").startswith("train_step ")
                  and e.get("cat") == "user_annotation")


@pytest.mark.parametrize("start,n", [(0, 2), (5, 3), (0, 0)])
def test_trace_window_holds_n_plus_one_steps(tmp_path, start, n):
    if n == 0:  # no flag, no trace
        state = SimpleNamespace(step=0, g=torch.nn.Linear(2, 2), mesh=None, alpha=1.0)
        train_loop(state, lambda st, b: {"loss": torch.tensor(1.0)}, _Stacks(),
                   LoopConfig(total_steps=12, log_every=100, out_dir=str(tmp_path)))
        assert not os.path.exists(tmp_path / "trace")
        return
    # step index start + 10 is the loop's (start + 11)-th; the window ends
    # after index start + 10 + n: steps numbered start+11 .. start+11+n
    assert _loop(tmp_path, start, start + 30, n) == list(range(start + 11, start + 12 + n))


def test_trace_window_that_outlives_the_loop_is_kept(tmp_path):
    assert _loop(tmp_path, 0, 12, 5) == [11, 12]


def test_start_stop_trace_writes_a_trace(tmp_path):
    prof = start_trace()
    (torch.ones(4) * 2).sum()
    path = stop_trace(prof, str(tmp_path / "t"), device="cpu")
    assert path == str(tmp_path / "t" / "trace_rank0.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mul", "aten::sum"} <= names


@pytest.fixture
def nans_on():
    debug_nans.enable()
    try:
        yield
    finally:
        debug_nans.disable()


def test_debug_nans_names_the_forward_op(nans_on):
    x = torch.zeros(3)
    with pytest.raises(FloatingPointError, match="aten.div"):
        x / x
    torch.ones(3) / 2  # finite outputs pass


def test_debug_nans_catches_a_nan_made_in_backward(nans_on):
    """sqrt at 0 has an infinite slope; times the zero of x * 0 it is NaN,
    made in backward only."""
    x = torch.ones(3, requires_grad=True)
    y = (x * 0).sqrt().sum()
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)mul"):
        y.backward()


def test_kernel_outputs_are_checked_only_under_debug_nans():
    bad = torch.tensor([float("nan")])
    debug_nans.check_kernel_output("power-iteration kernel", bad)  # off: no check
    debug_nans.enable()
    try:
        with pytest.raises(FloatingPointError, match="power-iteration kernel"):
            debug_nans.check_kernel_output("power-iteration kernel", torch.ones(2), bad)
        debug_nans.check_kernel_output("power-iteration kernel", torch.ones(2))
    finally:
        debug_nans.disable()
    assert not debug_nans.enabled() and not torch.is_anomaly_enabled()


def test_debug_nans_flag_turns_the_checks_on():
    args = common.base_parser("t").parse_args(["--device", "cpu", "--debug-nans"])
    common.configure(args)
    try:
        assert debug_nans.enabled() and torch.is_anomaly_enabled()
    finally:
        debug_nans.disable()
    common.configure(common.base_parser("t").parse_args(["--device", "cpu"]))
    assert not debug_nans.enabled()


def test_debug_nans_in_a_train_step_names_the_op():
    """A NaN weight in D: the first NaN is the power iteration's sigma (the
    plain version on the CPU: a matmul)."""
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step
    g = sngan.ResNetGenerator(channels=(8,), bottom_ch=8, z_dim=4)
    d = sngan.ResNetDiscriminator(channels=(8, 8), downsample=(True, False))
    state = create_state(g, d, device="cpu")
    with torch.no_grad():
        d.block1.conv1.weight[0, 0, 0, 0] = float("nan")
    step = make_train_step(sngan.make_sngan_spec(g, d, n_critic=1))
    debug_nans.enable()
    try:
        with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
            step(state, {"image": torch.zeros(1, 2, 8, 8, 3)})
    finally:
        debug_nans.disable()
