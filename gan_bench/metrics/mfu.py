"""The whole step's share of the card's bf16 peak: the configuration's model
FLOPs per step (``counts/<config>.py``, from the published shapes) times the
steps of the traced window, over its seconds and the peak (``peaks.py``)."""

from gan_bench import peaks


def read(ctx):
    flops = ctx.counts.get("flops_per_step")
    if not flops or not ctx.steps:
        return None
    return 100.0 * flops * ctx.steps / ctx.wall_s / peaks.BF16_FLOPS
