"""The work of one SNGAN-projection 128x128 training step, from the
configuration's published shapes alone (not from what the program
dispatches): the model FLOPs and the power iteration's bytes.

FLOPs count the multiply-adds (2 FLOPs each) of every convolution and
linear layer as the architecture defines it: the up-blocks' convolutions on
the 2x-upsampled input, the down-blocks' before their pooling (the input
block's 1x1 skip after it, as published), the projection's dot product.
A forward without gradients counts once, a network differentiated only
through (D in the G update) twice, a network updated three times (forward,
input and weight gradients). One power-iteration step per D forward counts
two matrix-vector products per weight. Normalization, activations, pooling,
the optimizer and the EMA count nothing.
"""

from __future__ import annotations

from typing import List, Tuple


def _g_forward(cfg, n: int) -> int:
    ch, z = cfg["g_channels"], cfg["z_dim"]
    flops = 2 * n * z * 16 * ch[0]
    cin, side = ch[0], 4
    for cout in ch:
        side *= 2
        flops += 2 * n * side * side * cout * (9 * cin + 9 * cout + cin)
        cin = cout
    return flops + 2 * n * side * side * 3 * 9 * cin


def _d_weights(cfg) -> List[Tuple[int, int]]:
    """``(out, fan_in)`` of the spectrally normalized weights."""
    ch, down = cfg["d_channels"], cfg["d_downsample"]
    dims = [(ch[0], 27), (ch[0], 9 * ch[0]), (ch[0], 3)]
    for i in range(1, len(ch)):
        dims += [(ch[i], 9 * ch[i - 1]), (ch[i], 9 * ch[i])]
        if down[i] or ch[i - 1] != ch[i]:
            dims.append((ch[i], ch[i - 1]))
    return dims + [(1, ch[-1]), (ch[-1], cfg["num_classes"])]


def _d_forward(cfg, n: int) -> int:
    ch, down = cfg["d_channels"], cfg["d_downsample"]
    side = cfg["image_size"]
    flops = 2 * n * side * side * ch[0] * (27 + 9 * ch[0])
    side //= 2
    flops += 2 * n * side * side * ch[0] * 3
    for i in range(1, len(ch)):
        skip = ch[i - 1] if (down[i] or ch[i - 1] != ch[i]) else 0
        flops += 2 * n * side * side * ch[i] * (9 * ch[i - 1] + 9 * ch[i] + skip)
        if down[i]:
            side //= 2
    return flops + 2 * n * ch[-1] * 2


def power_iteration_flops(cfg) -> int:
    return sum(4 * out * fan_in for out, fan_in in _d_weights(cfg))


def power_iteration_bytes(cfg) -> int:
    """float32 bytes one launch must move: every W read once, u read, sigma,
    u' and v written."""
    dims = _d_weights(cfg)
    return 4 * (sum(o * f for o, f in dims) + 2 * sum(o for o, _ in dims) + len(dims)
                + sum(f for _, f in dims))


def counts(cfg, traffic) -> dict:
    b, nc = traffic["batch"], cfg["n_critic"]
    critic = nc * 3 * _d_forward(cfg, 2 * b)
    g_update = 3 * _g_forward(cfg, b) + 2 * _d_forward(cfg, b)
    launches = nc + 1
    return {"flops_per_step": _g_forward(cfg, nc * b) + critic + g_update
            + launches * power_iteration_flops(cfg),
            "power_iteration_bytes_per_launch": power_iteration_bytes(cfg),
            "power_iteration_launches_per_step": launches}
