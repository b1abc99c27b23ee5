"""The share of the traced window in which no operation ran on the device:
one minus the union of the device operations' intervals over the window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s) if ctx.window_s else None
