"""The initial weights of a run, made on the device from one seed in a few
large calls: one normal draw for every ``("normal", std)`` leaf, one
uniform draw for every ``("uniform", limit)`` leaf, constants filled. The
leaves and their rules are the reference's (``reference/<config>.py``
``leaves``); the same seed gives the same tensors."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def make(leaves: List[Tuple[str, tuple, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        group = [(n, s, r) for n, s, r in leaves if r[0] == kind]
        sizes = [torch.Size(s).numel() for _, s, _ in group]
        if not group:
            continue
        flat = draw(sum(sizes), device=device, generator=gen)
        for (name, shape, rule), part in zip(group, flat.split(sizes)):
            t = part.view(shape)
            out[name] = t * rule[1] if kind == "normal" else (t * 2.0 - 1.0) * rule[1]
    for name, shape, rule in leaves:
        if rule[0] == "const":
            out[name] = torch.full(shape, float(rule[1]), device=device)
        elif rule[0] not in ("normal", "uniform"):
            raise ValueError(f"{name}: unknown rule {rule!r}")
    return {name: out[name] for name, _, _ in leaves}
