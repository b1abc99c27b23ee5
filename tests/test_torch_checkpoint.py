"""The port's checkpoint, auto-resume and aux-callback policy, mirroring
tests/test_loop_resume.py at tiny SNGAN widths on the CPU, plus the PGGAN
ladder's per-phase resume.

A faulted run resumed from its checkpoint must equal an uninterrupted run
bit for bit in every tensor: G, D (SN ``u``, BN running stats), the EMA,
both Adams' slots and step counts, both lr schedules, and both noise
generators. This file imports no JAX, so its card test runs on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_checkpoint.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages
from gan_lib_tensorflow_tpu_torch.models import sngan
from gan_lib_tensorflow_tpu_torch.train import (CheckpointManager, LoopConfig,
                                                create_state, eval_state_from_raw,
                                                make_train_step, train_loop)
from gan_lib_tensorflow_tpu_torch.train import loop as loop_mod
from gan_lib_tensorflow_tpu_torch.train.pggan_loop import LadderConfig, train_pggan_ladder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(device="cpu"):
    """Tiny SNGAN: 2 critic substeps, EMA, a linear lr decay on both Adams."""
    g = sngan.ResNetGenerator(channels=(8,), bottom_ch=8, z_dim=4)
    d = sngan.ResNetDiscriminator(channels=(8, 8), downsample=(True, False))
    spec = sngan.make_sngan_spec(g, d, n_critic=2, ema_decay=0.9)
    state = create_state(g, d, lr=1e-3, ema_decay=0.9, seed=0,
                         lr_lambda=lambda c: 1.0 - min(c, 40) / 40, device=device)
    src = DeviceFakeImages(batch_size=4, image_size=8, n_micro=2, seed=0, device=device)
    return spec, state, src


def _everything(st):
    """Every tensor and number that decides the next step, flattened."""
    out = {("step",): st.step, ("alpha",): st.alpha,
           ("g_noise",): st.g_noise.get_state(), ("d_noise",): st.d_noise.get_state()}
    out.update({("g", k): v for k, v in st.g.state_dict().items()})
    out.update({("d", k): v for k, v in st.d.state_dict().items()})
    out.update({("ema", k): v for k, v in st.ema_params.items()})
    for name in ("g_opt", "d_opt"):
        sd = getattr(st, name).state_dict()
        for i, slots in sd["state"].items():
            out.update({(name, i, k): v for k, v in slots.items()})
        out[(name, "lr")] = sd["param_groups"][0]["lr"]
    for name in ("g_sched", "d_sched"):
        sched = getattr(st, name)
        out[(name,)] = sched and (sched.last_epoch, tuple(sched.get_last_lr()))
    return out


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _cfg(**kw):
    base = dict(total_steps=10, log_every=100, sample_every=10**9, checkpoint_every=3)
    return LoopConfig(**{**base, **kw})


def test_fault_injection_then_auto_resume_is_bit_equal(tmp_path, capsys):
    ckpt_dir = str(tmp_path / "ckpt")
    spec, state, src = _setup()
    ckpt = CheckpointManager(ckpt_dir)
    with pytest.raises(RuntimeError, match="fault injected at step 5"):
        train_loop(state, make_train_step(spec), src, _cfg(fault_inject_step=5), ckpt=ckpt)
    assert ckpt.latest_step() == 3  # the step-3 checkpoint survived the fault
    ckpt.close()

    # a fresh state and loop resume from it and finish
    spec2, state2, src2 = _setup()
    ckpt2 = CheckpointManager(ckpt_dir)
    resumed = train_loop(state2, make_train_step(spec2), src2, _cfg(), ckpt=ckpt2)
    ckpt2.close()
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed.step == 10 and ckpt2.steps() == [6, 9, 10]  # max_to_keep 3

    spec3, state3, src3 = _setup()
    straight = train_loop(state3, make_train_step(spec3), src3, _cfg())
    _assert_bit_equal(_everything(resumed), _everything(straight))


def test_prune_tmp_files_and_weights_only(tmp_path):
    _, state, _ = _setup()
    cm = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in range(1, 5):
        state.step = step
        cm.save(step, state, wait=True)
    assert cm.steps() == [3, 4]
    # a write cut short leaves only its temporary file, which is not a checkpoint
    with open(cm.path(9) + ".tmp", "wb") as f:
        f.write(b"half a checkpoint")
    assert cm.latest_step() == 4
    raw = torch.load(cm.path(4), weights_only=True)  # tensors, numbers, lists, dicts
    assert raw["step"] == 4 and raw["g_sched"]["last_epoch"] == 0
    assert set(raw) == {"step", "alpha", "g", "d", "g_opt", "d_opt", "g_sched",
                        "d_sched", "ema_params", "g_noise", "d_noise"}
    assert any(k.endswith(".u") for k in raw["d"])
    assert any(k.endswith("running_mean") for k in raw["g"])
    cm.close()


def test_restore_latest_raw_onto_another_device(tmp_path):
    """The inference view: every tensor lands on ``map_location``, whatever
    device wrote it, and the noise generators' states are left out."""
    _, state, _ = _setup()
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    state.step, state.alpha = 7, 0.25
    cm.save(7, state, wait=True)
    raw = cm.restore_latest_raw(map_location="meta")
    assert "g_noise" not in raw and "d_noise" not in raw
    ev = eval_state_from_raw(raw)
    assert ev.step == 7 and ev.alpha == 0.25
    assert ev.g.keys() == state.g.state_dict().keys()
    assert all(t.device.type == "meta" for t in [*ev.g.values(), *ev.ema_params.values()])
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest_raw() is None
    cm.close()


def test_device_fake_images_stream_is_counter_based():
    a = DeviceFakeImages(batch_size=2, image_size=8, seed=3, device="cpu")
    first = [next(iter(a))["image"] for _ in range(4)]  # iter() continues the stream
    b = DeviceFakeImages(batch_size=2, image_size=8, seed=3, device="cpu")
    b.set_stream_position(2)
    assert torch.equal(next(iter(b))["image"], first[2])
    assert not torch.equal(first[0], first[1])
    c = DeviceFakeImages(batch_size=2, image_size=8, seed=4, device="cpu")
    assert not torch.equal(next(iter(c))["image"], first[0])


# --- the aux-callback policy (tests/test_loop_resume.py:88-150) ---

def test_aux_retry_transient_then_success(monkeypatch):
    monkeypatch.setattr(loop_mod, "_AUX_BACKOFF_S", 0.0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("INTERNAL: http://127.0.0.1:8113/remote_compile: read "
                               "body: response body closed before all bytes were read")
        return {"fid": 1.0}

    assert loop_mod._run_aux("eval@100", flaky) == {"fid": 1.0}
    assert calls["n"] == 3


def test_aux_skips_after_persistent_transient(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(loop_mod, "_AUX_BACKOFF_S", 0.0)
    from gan_lib_tensorflow_tpu_torch.utils import ScalarLogger

    def always_down():
        raise RuntimeError("UNAVAILABLE: backend unreachable")

    logger = ScalarLogger(str(tmp_path))
    assert loop_mod._run_aux("eval@200", always_down, logger=logger, step=200) is None
    assert "SKIPPED" in capsys.readouterr().out
    with open(tmp_path / "log.jsonl") as f:
        assert '"aux_skip/eval": 1.0' in f.read()


def test_aux_reraises_real_errors():
    def broken():
        raise RuntimeError("an unrelated shape error")

    with pytest.raises(RuntimeError, match="unrelated"):
        loop_mod._run_aux("eval@300", broken)


def test_aux_status_prefix_not_substring():
    def misleading():
        raise RuntimeError("INVALID_ARGUMENT: op INTERNAL_GATHER has mismatched shapes")

    with pytest.raises(RuntimeError):
        loop_mod._run_aux("eval@400", misleading)
    assert loop_mod._is_transient("INTERNAL: tunnel dropped")
    assert loop_mod._is_transient("Some wrapper line\nUNAVAILABLE: backend unreachable")
    assert not loop_mod._is_transient("ValueError mentioning INTERNAL stuff")


def test_aux_escalates_after_consecutive_skips(monkeypatch):
    monkeypatch.setattr(loop_mod, "_AUX_BACKOFF_S", 0.0)
    skips = {}

    def always_down():
        raise RuntimeError("UNAVAILABLE: backend unreachable")

    for _ in range(loop_mod._AUX_MAX_CONSECUTIVE_SKIPS - 1):
        assert loop_mod._run_aux("eval@500", always_down, skip_counts=skips) is None
    with pytest.raises(RuntimeError):
        loop_mod._run_aux("eval@600", always_down, skip_counts=skips)
    skips2 = {}  # a success in between resets the count
    loop_mod._run_aux("eval@1", always_down, skip_counts=skips2)
    loop_mod._run_aux("eval@2", lambda: {"ok": 1.0}, skip_counts=skips2)
    assert skips2["eval"] == 0


def test_aux_cuda_sticky_error_reraises_at_once(monkeypatch):
    """A sticky CUDA error leaves the context unusable: no retry, no skip."""
    monkeypatch.setattr(loop_mod, "_AUX_BACKOFF_S", 0.0)
    calls = {"n": 0}

    def illegal_access():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered\n"
                           "CUDA kernel errors might be asynchronously reported at "
                           "some other API call")

    with pytest.raises(RuntimeError, match="CUDA error"):
        loop_mod._run_aux("eval@700", illegal_access, skip_counts={})
    assert calls["n"] == 1


# --- PGGAN: per-phase checkpoints and resume (pggan_loop.py:150-176) ---

class _Interrupted(Exception):
    pass


class _RaiseAfter:
    """A source that raises after ``k`` batches (the stream's own positions)."""

    yields_stacks = True

    def __init__(self, inner, k):
        self.inner, self.k = inner, k

    def set_stream_position(self, pos):
        self.inner.set_stream_position(pos)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == self.k:
                raise _Interrupted()
            yield batch


def _ladder_cfg(out_dir):
    return LadderConfig(start_resolution=4, final_resolution=8, batch_by_res={4: 4, 8: 4},
                        width_mul=1 / 64, z_dim=8, steps_per_phase=4, log_every=1,
                        sample_every=2, checkpoint_every=2, out_dir=str(out_dir),
                        device="cpu")


def _source(res, batch):
    return DeviceFakeImages(batch_size=batch, image_size=res, num_classes=1, seed=0,
                            device="cpu")


def test_pggan_ladder_resumes_every_phase(tmp_path, capsys):
    def interrupting(res, batch):  # 3 batches into the 8x8 transition
        src = _source(res, batch)
        return _RaiseAfter(src, 3) if (res, phases[-1]) == (8, "transition") else src

    phases = []
    hook = lambda when, res, phase, st: phases.append(phase) if when == "start" else None
    with pytest.raises(_Interrupted):
        train_pggan_ladder(_ladder_cfg(tmp_path / "run"), interrupting, phase_hook=hook)
    trans = tmp_path / "run" / "8x8_transition"
    assert CheckpointManager(str(trans / "ckpt")).steps() == [2]
    capsys.readouterr()

    resumed = train_pggan_ladder(_ladder_cfg(tmp_path / "run"), _source)
    out = capsys.readouterr().out
    assert out.count("resumed from step 4") == 1   # 4x4 stabilize: done, nothing to train
    assert out.count("resumed from step 2") == 1   # 8x8 transition: from its checkpoint
    straight = train_pggan_ladder(_ladder_cfg(tmp_path / "straight"), _source)
    assert resumed.step == straight.step == 4 and resumed.alpha == 1.0
    _assert_bit_equal(_everything(resumed), _everything(straight))
    for phase in ("4x4_stabilize", "8x8_transition", "8x8_stabilize"):
        d = tmp_path / "run" / phase
        assert sorted(os.listdir(d / "ckpt")) == ["step_000002.pt", "step_000004.pt"]
        assert {"sample_000002.png", "sample_000004.png"} <= set(os.listdir(d))
        assert (d / "log.jsonl").exists()


@pytest.mark.cuda
def test_card_checkpoint_restores_in_a_cpu_only_process(tmp_path):
    """A checkpoint written from card tensors loads in a process that sees no
    card (the reference's cross-platform promise, checkpoint.py:47-58)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, state, _ = _setup("cuda")
    state.step = 1
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    cm.save(1, state, wait=True)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from gan_lib_tensorflow_tpu_torch.train import CheckpointManager\n"
            "assert not torch.cuda.is_available()\n"
            "raw = CheckpointManager(%r).restore_latest_raw()\n"
            "assert raw['step'] == 1 and raw['g']['dense.weight'].device.type == 'cpu'\n"
            % (REPO, str(tmp_path / "ckpt")))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
    cm.close()
