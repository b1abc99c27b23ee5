"""The most device memory the window held allocated at once
(``torch.cuda.max_memory_allocated`` after a reset at its start): the
resident store, the weights, Adam's slots, the EMA and the step's
activations."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
