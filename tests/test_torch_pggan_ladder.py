"""The port's PGGAN ladder 4 -> 8 on the CPU at a tiny width, mirroring
tests/test_pggan_ladder.py: phases run in order, alpha reaches 1.0, every
tensor shared between the end of a phase and the start of the next is
carried bit-exact through the ladder's own wiring (``phase_hook``), the
fade-in blend runs 6 times per transition step and never in a stabilize
step; ``parse_batch_by_res``; and the CLI end to end with ``--device cpu``.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.cli.train_pggan import parse_batch_by_res
from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages
from gan_lib_tensorflow_tpu_torch.models import pggan
from gan_lib_tensorflow_tpu_torch.train.pggan_loop import (DEFAULT_BATCH_BY_RES,
                                                           LadderConfig, build_phase,
                                                           train_pggan_ladder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(start_resolution=4, final_resolution=8, batch_by_res={4: 4, 8: 4},
                width_mul=1 / 64, z_dim=8, steps_per_phase=2, log_every=1,
                device="cpu")
    return LadderConfig(**{**base, **kw})


def _source(res, batch):
    return DeviceFakeImages(batch_size=batch, image_size=res, num_classes=1,
                            seed=0, device="cpu")


def _tensors(st):
    return {"g": {n: p.detach().clone() for n, p in st.g.named_parameters()},
            "d": {n: p.detach().clone() for n, p in st.d.named_parameters()},
            "ema": {n: t.clone() for n, t in st.ema_params.items()}}


def test_tiny_ladder_runs_and_grows(capsys):
    snapshots, alphas, logs = {}, {}, []

    def phase_hook(when, res, phase, st):
        snapshots[(when, res, phase)] = _tensors(st)
        alphas[(when, res, phase)] = st.alpha

    state = train_pggan_ladder(_cfg(), _source, phase_hook=phase_hook,
                               log_fn=lambda it, m: logs.append(m))
    assert state.step == 2 and state.alpha == 1.0
    assert "block_8.conv1.weight" in dict(state.g.named_parameters())
    assert "dense_4.weight" in dict(state.g.named_parameters())
    for p in list(state.g.parameters()) + list(state.d.parameters()):
        assert torch.isfinite(p).all()
    assert len(logs) == 6
    assert all(math.isfinite(v) for m in logs for v in m.values())
    assert set(logs[0]) == {"d_loss", "wdist", "gp", "g_loss"}
    assert alphas[("end", 8, "transition")] == 1.0
    out = capsys.readouterr().out
    assert "[pggan] 8x8 transition: migrated" in out
    assert "[pggan] 8x8 stabilize: migrated" in out

    order = [("start", 4, "stabilize"), ("end", 4, "stabilize"),
             ("start", 8, "transition"), ("end", 8, "transition"),
             ("start", 8, "stabilize"), ("end", 8, "stabilize")]
    assert list(snapshots) == order
    for prev_key, next_key in [(order[1], order[2]), (order[3], order[4])]:
        for net in ("g", "d", "ema"):
            prev, nxt = snapshots[prev_key][net], snapshots[next_key][net]
            shared = [n for n in prev if n in nxt and prev[n].shape == nxt[n].shape]
            assert shared, f"no shared trunk {prev_key}->{next_key}"
            for n in shared:
                assert torch.equal(prev[n], nxt[n]), f"{net}:{n} {prev_key}->{next_key}"


def test_alpha_ramp_and_phase_build():
    ph = build_phase(_cfg(steps_per_phase=4), 8, "transition")
    assert [ph.alpha_fn(i) for i in range(4)] == [0.25, 0.5, 0.75, 1.0]
    assert ph.state.g.fade_in and ph.state.d.fade_in and ph.steps == 4 and ph.batch == 4
    st = build_phase(_cfg(), 8, "stabilize")
    assert not st.state.g.fade_in and st.alpha_fn(0) == 1.0
    assert build_phase(_cfg(steps_per_phase=None, images_per_phase=10), 8,
                       "stabilize").steps == 2  # images_per_phase // batch


@pytest.mark.parametrize("phase,per_step", [("transition", 6), ("stabilize", 0)])
def test_blend_calls_per_step(phase, per_step, monkeypatch):
    """G twice (the critic's fake, the G loss's fake) and D four times (real,
    fake, the penalty's interpolates, the G loss) in a transition step; on
    the card each call is one kernel launch."""
    calls = []
    blend = pggan.fadein_blend
    monkeypatch.setattr(pggan, "fadein_blend",
                        lambda a, b, alpha: calls.append(alpha) or blend(a, b, alpha))
    cfg = _cfg(steps_per_phase=3)
    ph = build_phase(cfg, 8, phase)
    from gan_lib_tensorflow_tpu_torch.train import LoopConfig, make_train_step, train_loop
    train_loop(ph.state, make_train_step(ph.spec), _source(8, 4),
               LoopConfig(total_steps=3, log_every=3), lambda it, m: None,
               alpha_fn=ph.alpha_fn)
    assert len(calls) == 3 * per_step
    if per_step:
        assert calls == [a for a in (1 / 3, 2 / 3, 1.0) for _ in range(per_step)]


def test_fused_from_reaches_the_d_blocks():
    ph = build_phase(_cfg(fused_from_resolution=8), 8, "transition")
    assert ph.state.d.block_8.fused_scale
    assert not build_phase(_cfg(), 8, "transition").state.d.block_8.fused_scale


def test_batch_by_res_cli_override():
    assert parse_batch_by_res("") == {}
    got = parse_batch_by_res("512:16,1024:8")
    assert got == {512: 16, 1024: 8}
    merged = dict(DEFAULT_BATCH_BY_RES)
    merged.update(got)
    assert merged[1024] == 8 and merged[256] == DEFAULT_BATCH_BY_RES[256]
    with pytest.raises(SystemExit):
        parse_batch_by_res("512x16")


def test_cli_on_cpu(tmp_path):
    """The module entry point, bf16 compute (the default), a tiny width; one
    directory per phase under --out-dir with its log, samples and checkpoint."""
    cmd = [sys.executable, "-m", "gan_lib_tensorflow_tpu_torch.cli.train_pggan",
           "--device", "cpu", "--data", "fake", "--final-resolution", "8",
           "--width-mul", "0.015625", "--z-dim", "8", "--steps-per-phase", "1",
           "--batch-by-res", "4:4,8:4", "--log-every", "1", "--out-dir", str(tmp_path)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout.splitlines()
    assert [line.split(":")[0] for line in out if line.startswith("[pggan]")] == [
        "[pggan] 8x8 transition", "[pggan] 8x8 stabilize"]
    metrics = []
    for phase in ("4x4_stabilize", "8x8_transition", "8x8_stabilize"):
        with open(tmp_path / phase / "log.jsonl") as f:
            metrics += [json.loads(line) for line in f]
        assert os.path.exists(tmp_path / phase / "ckpt" / "step_000001.pt")
        assert os.path.exists(tmp_path / phase / "sample_000001.png")
    assert len(metrics) == 3
    assert all(math.isfinite(v) for m in metrics for v in m.values())


def test_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the test checks the CUDA-less policy")
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pggan.main(["--final-resolution", "8", "--steps-per-phase", "1"])
