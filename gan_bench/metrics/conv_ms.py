"""Device milliseconds per step of the convolution and matrix-product
kernels (cuDNN, cuBLAS, their GEMMs)."""


def read(ctx):
    ops = [o for o in ctx.ops if ctx.kind(o.name) == "conv/matmul"]
    return 1e3 * sum(o.seconds for o in ops) / ctx.steps if ops and ctx.steps else None
