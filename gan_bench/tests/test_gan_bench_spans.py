"""The program's spans in a traced window (``spans.py``) and the four readers
of them, on hand-made spans, operations and gaps."""

from types import SimpleNamespace

import pytest

from gan_bench import run, spans
from gan_bench import trace as tracing

MS = 1_000_000  # ns


def _span(name, start, end, parent=-1, tid=1, counts=None):
    return SimpleNamespace(name=name, start=start * MS, end=end * MS, parent=parent, tid=tid,
                           counts=counts)


# two steps on thread 1: data.batch > data.upload, then step > d.backward; the
# autograd thread (2) opens nothing
SPANS = [_span("data.batch", 0, 2), _span("data.upload", 0, 1, 0, counts={"host_syncs": 1}),
         _span("step", 2, 10), _span("d.backward", 2.5, 8, 2),
         _span("data.batch", 10, 11), _span("data.upload", 10, 10.5, 4,
                                            counts={"host_syncs": 1}),
         _span("step", 11, 20), _span("d.backward", 12, 18, 6)]
# device busy [1, 3], [5, 9], [12, 20]: idle [0, 1], [3, 5], [9, 12] in [0, 20]
BUSY = [(1 * MS, 3 * MS), (5 * MS, 9 * MS), (12 * MS, 20 * MS)]


def _program():
    return spans.ProgramTrace(SPANS, spans.idle_intervals(BUSY, 0, 20 * MS))


def _ctx(program, steps=2):
    ctx = run.Context(steps=steps, images_per_step=4, wall_s=1.0, step_ms=[], peak_bytes=0,
                      setup_s=1.0, counts={})
    if program is not None:
        ctx.program = program
    return ctx


def test_innermost_span_on_the_thread_then_on_any():
    index = spans.SpanIndex(SPANS)
    assert index.at(5 * MS, tid=1) == 3 and index.path(3) == "step/d.backward"
    assert index.at(9 * MS, tid=1) == 2            # d.backward has closed: its parent
    assert index.at(5 * MS, tid=2) == 3            # no span on thread 2: any thread's
    assert index.at(10.7 * MS) == 4 and index.at(25 * MS) is None


def test_idle_and_overlap_arithmetic():
    prog = _program()
    assert prog.idle == [(0, 1 * MS), (3 * MS, 5 * MS), (9 * MS, 12 * MS)]
    # inside the step spans [2, 10] and [11, 20]: 2 + 1 + 1 ms
    assert spans.overlap(prog.idle, spans.step_spans(prog)) == 4 * MS
    assert spans.idle_by_span(prog) == pytest.approx(
        {"data.batch/data.upload": 0.001, "step/d.backward": 0.002, "step": 0.003})


def test_the_four_readers():
    ctx = _ctx(_program())

    def read(name):
        return run.module("metrics", name).read(ctx)

    assert read("data_wait_ms") == pytest.approx(0.75)     # (1 + 0.5) / 2
    assert read("step_launch_ms") == pytest.approx(8.5)    # (8 + 9) / 2
    assert read("step_idle_ms") == pytest.approx(2.0)      # 4 ms / 2
    assert read("host_syncs") == 1.0
    # the decomposition: idle in the steps + idle outside = the window's idle
    outside = 1e-6 * (sum(e - s for s, e in ctx.program.idle)) - 2 * read("step_idle_ms")
    assert outside == pytest.approx(2.0)  # [0, 1] and [10, 11] of [9, 12]


@pytest.mark.parametrize("name", ["data_wait_ms", "step_launch_ms", "step_idle_ms",
                                  "host_syncs"])
def test_readers_are_silent_without_program_spans(name):
    reader = run.module("metrics", name).read
    assert reader(_ctx(None)) is None
    assert reader(_ctx(spans.ProgramTrace([], []))) is None


def test_gap_names_join_the_harness_span_and_the_program_path():
    harness = tracing._SpanIndex(tracing.host_spans([0, 2 * MS, 10 * MS, 11 * MS, 20 * MS], 2))
    names = spans.gap_names(_program(), lambda t: harness.at(t) or tracing.WINDOW)
    assert names == [["bench.step/step", 0.003], ["bench.step/step/d.backward", 0.002],
                     ["bench.data/data.batch/data.upload", 0.001]]


def test_without_program_spans_the_harness_breakdown_is_unchanged():
    """No recorder: the harness's own names and readers, as before."""
    ops = [tracing.Op("gemm_a", 1 * MS, 3 * MS, "bench.step")]
    busy = tracing._union([(o.start, o.end) for o in ops], 0, 4 * MS)
    index = tracing._SpanIndex(tracing.host_spans([0, 1 * MS, 4 * MS], 1))
    out = tracing._breakdown(ops, busy, 0, 4 * MS, index)
    assert out["idle_gaps"] == [["bench.data", 0.001], ["bench.step", 0.001]]
    empty = spans.ProgramTrace([], spans.idle_intervals(busy, 0, 4 * MS))
    assert spans.gap_names(empty, lambda t: index.at(t)) == [["bench.data", 0.001],
                                                             ["bench.step", 0.001]]
