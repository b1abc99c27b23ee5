"""The 90th percentile of the step's period on the device: the time between
consecutive CUDA events recorded on the step's stream at each step boundary
(recording one makes the host wait for nothing), over every step of the
window."""

import statistics


def read(ctx):
    if len(ctx.step_ms) < 10:
        return None
    return statistics.quantiles(ctx.step_ms, n=10, method="inclusive")[-1]
