"""The trace's arithmetic and the metric readers, on hand-made operations;
the traffic generator and the weights from the seed."""

import numpy as np
import pytest
import torch

from gan_bench import run, traffic, weights
from gan_bench import trace as tracing
from gan_bench.trace import Op

MS = 1_000_000  # ns


def _ctx(ops, steps=2, counts=None, wall_s=1.0):
    return run.Context(steps=steps, images_per_step=4, wall_s=wall_s,
                       step_ms=[float(i) for i in range(1, 21)], peak_bytes=3 * 2**30,
                       setup_s=12.5, counts=counts or {}, ops=ops, busy_s=0.6, window_s=1.0,
                       kind=tracing.kind_of)


def test_union_clips_to_the_window_and_merges_overlaps():
    assert tracing._union([(5, 10), (0, 3), (8, 14), (20, 30)], 1, 25) == [
        (1, 3), (5, 14), (20, 25)]


def test_breakdown_names_the_longest_ops_and_gaps():
    ops = [Op("gemm_a", 0, 4 * MS, "bench.step"), Op("elementwise_b", 6 * MS, 7 * MS, None),
           Op("gemm_a", 8 * MS, 9 * MS, "bench.step")]
    busy = tracing._union([(o.start, o.end) for o in ops], 0, 10 * MS)
    spans = [(4 * MS, 6 * MS, "bench.data"), (7 * MS, 8 * MS + MS // 2, "bench.step")]
    out = tracing._breakdown(ops, busy, 0, 10 * MS, tracing._SpanIndex(spans))
    assert out["device_ops"] == [["gemm_a", 0.005], ["elementwise_b", 0.001]]
    assert out["idle_gaps"][0] == ["bench.data", 0.002]
    assert [g[0] for g in out["idle_gaps"]] == ["bench.data", "bench.step", "bench.window"]


def test_kinds_are_the_frozen_table():
    assert tracing.kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv/matmul"
    assert tracing.kind_of("multi_tensor_apply_kernel<Adam>") == "adam/ema (foreach)"
    assert tracing.kind_of("power_iteration_kernel_streamed") == "hand-written"
    assert tracing.kind_of("direct_copy_kernel_cuda") == "cast/copy"
    assert tracing.kind_of("Memcpy HtoD (Pageable -> Device)") == "other"
    assert tracing.kind_of("something_else") == "other"


def _read(name, ctx):
    return run.module("metrics", name).read(ctx)


def test_end_to_end_readers():
    ctx = _ctx([], steps=10, wall_s=2.0)
    assert _read("images_per_s", ctx) == 20.0
    assert _read("step_ms_p90", ctx) == pytest.approx(18.1)
    assert _read("peak_mem_gib", ctx) == 3.0
    assert _read("setup_s", ctx) == 12.5


def test_layer_readers_sum_their_ops_per_step():
    ops = [Op("gather_elementwise_kernel", 0, 1 * MS, "bench.data"),
           Op("cudnn_conv", 1 * MS, 5 * MS, "bench.step"),
           Op("reduce_kernel", 5 * MS, 6 * MS, "bench.step"),
           Op("multi_tensor_apply_kernel", 6 * MS, 8 * MS, "bench.step")]
    ctx = _ctx(ops)
    assert _read("data_ms", ctx) == 0.5
    assert _read("conv_ms", ctx) == 2.0
    assert _read("elementwise_ms", ctx) == 1.0
    assert _read("optimizer_ms", ctx) == 1.0
    assert _read("device_idle", ctx) == pytest.approx(40.0)
    assert _read("mfu", ctx) is None
    assert _read("power_iteration_roofline", ctx) is None


def test_rooflines_and_mfu_from_the_counts():
    b = 3.35e12 * 1e-3  # bytes the card moves in 1 ms
    ops = [Op("power_iteration_kernel_streamed", 0, 2 * MS, "bench.step")]
    ctx = _ctx(ops, counts={"power_iteration_bytes_per_launch": b})
    assert _read("power_iteration_roofline", ctx) == pytest.approx(50.0)
    fade = [Op("fadein_blend_vec4", 0, MS, "bench.step")] * 6
    counts = {"fadein_bytes_per_step": 3 * b, "fadein_launches_per_step": 3}
    assert _read("fadein_roofline", _ctx(fade, steps=2, counts=counts)) == pytest.approx(100.0)
    # a launch missing from a step silences it
    assert _read("fadein_roofline", _ctx(fade[:5], steps=2, counts=counts)) is None
    ctx = _ctx([], steps=2, counts={"flops_per_step": 989e12 / 4}, wall_s=1.0)
    assert _read("mfu", ctx) == pytest.approx(50.0)


def test_the_store_stream_is_the_programs():
    from gan_lib_tensorflow_tpu_torch.data import DeviceCachedStore

    seeds = traffic.Seeds(2**33 + 9)
    t = {"store_images": 12, "image_size": 8, "num_classes": 3, "batch": 2, "grid": 4}
    images = traffic.store_images(t, seeds, "cpu")
    labels = traffic.store_labels(t, seeds, "cpu")
    store = DeviceCachedStore(images=images.numpy(), labels=labels.numpy(), num_classes=3,
                              batch_size=2, n_micro=2, seed=seeds.store, device="cpu")
    stream = traffic.StoreStream(images, labels, 2, 2, seeds.store)
    for k, batch in zip(range(7), iter(store)):  # past an epoch's end
        mine = stream(k)
        assert torch.equal(batch["image"], mine["image"])
        assert torch.equal(batch["label"].long(), mine["label"])


def test_seeds_and_weights_repeat():
    a, b = traffic.Seeds(2**31 + 5), traffic.Seeds(2**31 + 5)
    assert vars(a) == vars(b) and vars(a) != vars(traffic.Seeds(2**31 + 6))
    assert all(0 <= v < 2**62 for k, v in vars(a).items() if k != "seed")
    leaves = [("w", (3, 4), ("normal", 2.0)), ("t", (5,), ("uniform", 0.5)),
              ("b", (3,), ("const", 1.0))]
    w1, w2 = weights.make(leaves, 7, "cpu"), weights.make(leaves, 7, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["t"].abs().max()) <= 0.5 and torch.equal(w1["b"], torch.ones(3))
    assert np.isclose(float(weights.make([("w", (200, 200), ("normal", 2.0))], 1, "cpu")["w"]
                            .std()), 2.0, rtol=0.02)


def test_host_spans_come_from_the_window_marks():
    marks = [0, 2, 10, 13, 20]
    assert tracing.host_spans(marks, 2) == [(0, 2, "bench.data"), (2, 10, "bench.step"),
                                            (10, 13, "bench.data"), (13, 20, "bench.step")]
    assert tracing.host_spans(marks[:4], 2) == []
