"""Host milliseconds per step the data layer held the host waiting: the
program's ``data.upload`` spans (the store's index copy from pageable
memory, which waits for the card) and ``data.queue_wait`` spans (a host
source's queue), from the program's span recorder (``spans.py``)."""

from gan_bench.spans import WAITS


def read(ctx):
    prog = getattr(ctx, "program", None)
    if prog is None or not prog.spans or not ctx.steps:
        return None
    return 1e-6 * sum(s.end - s.start for s in prog.spans if s.name in WAITS) / ctx.steps
