"""Seconds from the process's start to the window's: imports, the builds of
the program's kernels (served from the checkout after its first run), the
networks, the weights, the store, and the first steps."""


def read(ctx):
    return ctx.setup_s
