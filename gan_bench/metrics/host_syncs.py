"""The host's waits for the device per step inside the program's spans: the
span recorder's ``host_syncs`` counter (CUDA's sync debug mode, each
warning counted; ``spans.py``)."""

from gan_bench.spans import HOST_SYNCS


def read(ctx):
    prog = getattr(ctx, "program", None)
    if prog is None or not prog.spans or not ctx.steps:
        return None
    return sum((s.counts or {}).get(HOST_SYNCS, 0) for s in prog.spans) / ctx.steps
