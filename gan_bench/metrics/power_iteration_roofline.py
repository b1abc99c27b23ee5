"""The power-iteration kernel's share of its roofline: the bytes one launch
must move (``counts/<config>.py``: every spectral-norm W read once, u read,
sigma, u' and v written; memory-bound) over the card's bandwidth
(``peaks.py``), against its mean device time per launch."""

from gan_bench import peaks


def read(ctx):
    per_launch = ctx.counts.get("power_iteration_bytes_per_launch")
    ops = [o for o in ctx.ops if "power_iteration" in o.name]
    if not per_launch or not ops:
        return None
    least = per_launch * len(ops) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / sum(o.seconds for o in ops)
