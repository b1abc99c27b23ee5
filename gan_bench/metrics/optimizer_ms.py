"""Device milliseconds per step of Adam's and the EMA's multi-tensor
(foreach) kernels."""


def read(ctx):
    ops = [o for o in ctx.ops if ctx.kind(o.name) == "adam/ema (foreach)"]
    return 1e3 * sum(o.seconds for o in ops) / ctx.steps if ops and ctx.steps else None
