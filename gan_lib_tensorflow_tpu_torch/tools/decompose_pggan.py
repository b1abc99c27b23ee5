"""Decompose the PGGAN high-resolution step (port of
``tools/decompose_pggan.py``): G forward, D forward, G's loss gradient, the
gradient penalty's gradient alone and D's full loss gradient (the penalty's
double backward included), each timed alone, bf16, fused_scale D blocks
from 128. Compare ``--s2d-from 0`` with ``--s2d-from <res>``.

One JSON line: ``s2d_from, res, batch, g_fwd_ms, d_fwd_ms, g_grad_ms,
gp_grad_ms, d_grad_full_ms`` and the card. Each time: two warm-up calls,
then ``--reps`` calls between two device syncs.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.decompose_pggan --res 1024 \\
           --batch 4 --s2d-from 512
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..losses import drift_penalty, gradient_penalty, wgan_d_loss
from ..models import pggan
from ..ops.layers import init_weights
from . import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--s2d-from", type=int, default=0)
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--width-mul", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    res, n = args.res, args.batch
    g = pggan.PGGANGenerator(resolution=res, width_mul=args.width_mul,
                             s2d_from=args.s2d_from, compute_dtype=torch.bfloat16)
    d = pggan.PGGANDiscriminator(resolution=res, width_mul=args.width_mul, fused_from=128,
                                 s2d_from=args.s2d_from, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    init_weights(g, gen)
    init_weights(d, gen)
    g.to(dev)
    d.to(dev)
    z = torch.randn(n, g.z_dim, generator=gen).to(dev)
    x = torch.randn(n, res, res, 3, generator=gen).to(dev)
    u = torch.rand(n, 1, 1, 1, generator=gen).to(dev)
    d_params, g_params = list(d.parameters()), list(g.parameters())
    critic = lambda y: d(y, 1.0)
    with torch.no_grad():
        fake = g(z, 1.0)

    def g_fwd():
        with torch.no_grad():
            return g(z, 1.0)

    def d_fwd():
        with torch.no_grad():
            return d(x, 1.0)

    def g_grad():
        return torch.autograd.grad(-d(g(z, 1.0), 1.0).mean(), g_params)

    def gp_grad():  # the output bias does not reach the penalty: a zero gradient
        return torch.autograd.grad(gradient_penalty(critic, x, fake, u), d_params,
                                   materialize_grads=True)

    def d_grad_full():
        rl, fl = d(x, 1.0), d(fake, 1.0)
        loss = (wgan_d_loss(rl, fl) + 10.0 * gradient_penalty(critic, x, fake, u)
                + 1e-3 * drift_penalty(rl))
        return torch.autograd.grad(loss, d_params)

    row = {"s2d_from": args.s2d_from, "res": res, "batch": n}
    for name, fn in (("g_fwd_ms", g_fwd), ("d_fwd_ms", d_fwd), ("g_grad_ms", g_grad),
                     ("gp_grad_ms", gp_grad), ("d_grad_full_ms", d_grad_full)):
        row[name] = harness.timed_ms(fn, args.reps, dev)
    row["card"] = harness.card(dev)
    harness.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
