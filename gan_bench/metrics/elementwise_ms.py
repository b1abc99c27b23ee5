"""Device milliseconds per step of the elementwise, reduction and
cast/copy kernels: the float32 batch norms, pixel norm, activations,
casts and the losses' reductions."""

KINDS = ("elementwise", "reduction", "cast/copy")


def read(ctx):
    ops = [o for o in ctx.ops if ctx.kind(o.name) in KINDS]
    return 1e3 * sum(o.seconds for o in ops) / ctx.steps if ops and ctx.steps else None
