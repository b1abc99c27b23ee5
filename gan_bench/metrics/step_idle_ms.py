"""Device milliseconds per step in which no operation ran while the host was
inside the program's ``step`` span, on the clock the trace and the span
recorder share (``spans.py``): the card waiting for the step's own
launches. The idle outside the ``step`` spans is the rest of
``device_idle``."""

from gan_bench.spans import overlap, step_spans


def read(ctx):
    prog = getattr(ctx, "program", None)
    steps = step_spans(prog) if prog is not None else []
    return 1e-6 * overlap(prog.idle, steps) / ctx.steps if steps and ctx.steps else None
