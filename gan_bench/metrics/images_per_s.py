"""Real images the critic consumed per second: the window's steps times the
images a step takes (batch x n_critic), over the window's seconds on the
host's clock, the window closed by a synchronise of the device."""


def read(ctx):
    return ctx.steps * ctx.images_per_step / ctx.wall_s if ctx.steps else None
