"""The fade-in kernel's share of its roofline: the bytes a step's blends
must move (``counts/<config>.py``: 12 per element, G's two and D's four
launches; memory-bound) over the card's bandwidth (``peaks.py``), against
their summed device time. Silent unless the trace holds the step's count of
launches for every step."""

from gan_bench import peaks


def read(ctx):
    per_step = ctx.counts.get("fadein_bytes_per_step")
    ops = [o for o in ctx.ops if "fadein" in o.name]
    if not per_step or not ops or len(ops) != ctx.counts["fadein_launches_per_step"] * ctx.steps:
        return None
    least = per_step * ctx.steps / peaks.HBM_BYTES_PER_S
    return 100.0 * least / sum(o.seconds for o in ops)
