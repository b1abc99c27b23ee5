"""Device milliseconds per step of the operations the data layer launches:
those the host launched inside the benchmark's ``bench.data`` span, around
``next(batches)`` (the store's index upload, gather and normalize)."""


def read(ctx):
    ops = [o for o in ctx.ops if o.span == "bench.data"]
    return 1e3 * sum(o.seconds for o in ops) / ctx.steps if ops and ctx.steps else None
