"""Host milliseconds per step inside the program's ``step`` span (around
``train_step``, from the program's span recorder, ``spans.py``): the time
the host takes to enqueue one fused step, waits included (``host_syncs``
counts them)."""

from gan_bench.spans import STEP


def read(ctx):
    prog = getattr(ctx, "program", None)
    ns = [s.end - s.start for s in getattr(prog, "spans", ()) if s.name == STEP]
    return 1e-6 * sum(ns) / ctx.steps if ns and ctx.steps else None
