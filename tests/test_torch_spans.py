"""The span recorder (``utils/profiler.py``): off it records nothing and
hands back one shared context; on it records nesting, parents, threads and
counts, the fused step's and the data layer's spans, and writes them into a
``torch.profiler`` trace on its clock. CPU only, tiny tensors."""

import json
import threading

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.utils import profiler
from gan_lib_tensorflow_tpu_torch.utils.profiler import count, drain, enable, span


@pytest.fixture
def recorder():
    enable()
    try:
        yield
    finally:
        drain()


def _tree(spans):
    """``[(name, parent name or None)]`` in opening order."""
    return [(s.name, None if s.parent < 0 else spans[s.parent].name) for s in spans]


def test_off_records_nothing_and_shares_one_context():
    assert not profiler.enabled()
    assert span("a") is span("b", i=1)
    with span("a"):
        count("c")
    enable()
    assert profiler.enabled()
    rec = drain()
    assert rec.spans == [] and rec.counts == {} and not profiler.enabled()


def test_nesting_parents_threads_counts_and_drain(recorder):
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with span("bwd"):
                count("calls")
                return 2 * g

    seen = {}

    def worker():
        with span("thread", step=7):
            seen["tid"] = threading.get_native_id()

    with span("outer", step=3):
        with span("inner", i=2):
            count("calls", 2)
        x = torch.ones(3, requires_grad=True)
        with span("outer.backward"):
            Twice.apply(x).sum().backward()
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rec = drain()
    assert _tree(rec.spans) == [("outer", None), ("inner", "outer"),
                                ("outer.backward", "outer"), ("bwd", "outer.backward"),
                                ("thread", None)]
    outer, inner, bwd, thread = (rec.spans[i] for i in (0, 1, 3, 4))
    assert inner.attrs == {"i": 2} and inner.counts == {"calls": 2}
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert [s.step for s in rec.spans] == [3, 3, 3, 3, 7]
    assert bwd.tid == outer.tid == threading.get_native_id() and bwd.counts == {"calls": 1}
    assert thread.tid == seen["tid"] != outer.tid
    assert rec.counts == {"calls": 3}
    assert drain().spans == []  # drained: empty


def test_fused_step_spans(recorder):
    from gan_lib_tensorflow_tpu_torch.losses import gradient_penalty
    from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step
    from gan_lib_tensorflow_tpu_torch.train.step import GANSpec

    g, d = torch.nn.Linear(4, 6), torch.nn.Linear(6, 1)
    state = create_state(g, d, ema_decay=0.5, device="cpu")

    def d_loss(real, fake, alpha, noise, u_gp, labels, masks):
        u = torch.rand(real.shape[0], 1, generator=noise)
        loss = d(fake).mean() - d(real).mean() + gradient_penalty(d, real, fake, u)
        return loss, {"d_loss": loss.detach()}

    def g_loss(z, alpha, labels, noise, masks):
        loss = -d(g(z)).mean()
        return loss, {}

    spec = GANSpec(prepare_fakes=lambda z, alpha, labels: g(z).detach(), d_loss=d_loss,
                   g_loss=g_loss, n_critic=2, ema_decay=0.5, z_dim=4)
    make_train_step(spec)(state, {"image": torch.zeros(2, 3, 6)})
    rec = drain()
    d_update = [("step.d_update", "step"), ("d.loss", "step.d_update"),
                ("d.penalty", "d.loss"), ("d.backward", "step.d_update"),
                ("d.optimizer", "step.d_update")]
    assert _tree(rec.spans) == [("step", None), ("step.fakes", "step"), *d_update, *d_update,
                                ("step.g_update", "step"), ("g.loss", "step.g_update"),
                                ("g.backward", "step.g_update"),
                                ("g.optimizer", "step.g_update"), ("step.ema", "step")]
    assert [s.attrs["i"] for s in rec.spans if s.name == "step.d_update"] == [0, 1]
    assert {s.step for s in rec.spans} == {1} and state.step == 1


def test_data_layer_spans(recorder):
    from gan_lib_tensorflow_tpu_torch.data import DeviceCachedStore
    from gan_lib_tensorflow_tpu_torch.parallel import prefetch_to_device

    images = np.arange(6 * 4 * 4 * 3, dtype=np.uint8).reshape(6, 4, 4, 3)
    store = DeviceCachedStore(images=images, labels=np.arange(6), num_classes=6,
                              batch_size=2, n_micro=2, device="cpu")
    batch = next(iter(store))
    rec = drain()
    assert batch["image"].shape == (2, 2, 4, 4, 3)
    assert _tree(rec.spans) == [("data.batch", None), ("data.indices", "data.batch"),
                                ("data.upload", "data.batch"), ("data.gather", "data.batch")]
    enable()
    assert len(list(prefetch_to_device(iter([{"x": images[:2]}]), "cpu"))) == 1
    assert _tree(drain().spans) == [("data.queue_wait", None)] * 2  # the batch, the end


def test_trace_holds_the_spans_on_its_clock(tmp_path):
    prof = profiler.start_trace()
    with span("probe", step=1):
        torch.ones(4) * 2
    path = profiler.stop_trace(prof, str(tmp_path), device="cpu")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    probe = next(e for e in events if e.get("name") == "probe")
    mul = next(e for e in events if e.get("name") == "aten::mul")
    assert probe["cat"] == "user_annotation" and probe["args"]["step"] == 1
    assert probe["ts"] <= mul["ts"] and mul["ts"] + mul["dur"] <= probe["ts"] + probe["dur"]
    assert not profiler.enabled()


@pytest.mark.cuda
def test_train_sngan_trace_puts_each_kernel_launch_in_its_span(tmp_path):
    """``train_sngan --trace-steps 2`` on the card: the trace holds the
    recorder's spans, each power-iteration launch inside a
    ``kernel.power_iteration`` span (6 a step, 3 steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan

    train_sngan.main(["--data", "device-fake", "--steps", "14", "--trace-steps", "2",
                      "--out-dir", str(tmp_path)])
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events if e.get("name", "").startswith("train_step "))
    assert steps == ["train_step 11", "train_step 12", "train_step 13"]
    spans = [e for e in events if e.get("name") == "kernel.power_iteration"]
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel" and "power_iteration" in e["name"]}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    assert len(spans) == len(launches) == 18
    for launch in launches:
        assert any(s["ts"] <= launch["ts"] and launch["ts"] + launch["dur"] <= s["ts"] + s["dur"]
                   for s in spans), launch
