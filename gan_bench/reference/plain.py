"""Plain float32 pieces shared by the references: convolutions and linear
layers (with the fp8 control's operand rounding), spectral norm's power
iteration, Adam as ``torch.optim.Adam`` computes it, the EMA, and the
readings a training cell compares.

Imports nothing of the program. Tensors are NCHW inside, as the published
code's are; images cross the boundary NHWC.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

KINK_CAP = 8      # hinge terms counted both ways at most (2**8 alternatives)
# how each precision rounds a tensor that a convolution or linear layer
# reads or writes, and the gradient that flows back through it
ROUNDING = {"fp8": (torch.float8_e4m3fn, torch.float8_e5m2),
            "bf16": (torch.bfloat16, torch.bfloat16)}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back; a float8 type takes one scale
    per tensor, its largest magnitude at the type's largest finite value."""
    if dtype == torch.bfloat16:
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    """Rounds in the forward pass to one type and the gradient to another;
    the gradient's rounding is itself differentiable (a double backward
    rounds again)."""

    @staticmethod
    def forward(ctx, x, forward_dtype, backward_dtype):
        ctx.backward_dtype = backward_dtype
        return _round(x, forward_dtype)

    @staticmethod
    def backward(ctx, grad):
        return _Rounded.apply(grad, ctx.backward_dtype, ctx.backward_dtype), None, None


class Numerics:
    """How the reference computes its convolutions and matrix products:
    ``"fp32"`` (the reference); ``"fp8"`` (the control: each convolution's
    and linear layer's input, weight and output rounded to float8 e4m3
    with one scale per tensor, and the gradients through them to e5m2, the
    usual float8 training recipe; products in float32); ``"bf16"`` (the
    same rounding to bfloat16: what rounding alone does at the program's
    precision)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32",) + tuple(ROUNDING):
            raise ValueError(f"precision must be fp32, fp8 or bf16, got {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return x
        return _Rounded.apply(x, *ROUNDING[self.precision])

    def conv(self, x, w, b=None, padding: int = 0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, padding=padding))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 box (mean) downsampling of NCHW."""
    return F.avg_pool2d(x, 2)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


def spectral_sigma(w: torch.Tensor, u: torch.Tensor):
    """One power-iteration step on ``w`` read as ``[out, fan_in]`` from
    ``u`` ``[1, out]`` (Miyato et al. 2018, Algorithm 1 with one
    iteration): ``(sigma, u_new)``; sigma is differentiable in ``w`` only
    (u and v are held constant)."""
    mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = l2_normalize(u.reshape(1, -1) @ mat)
        u_new = l2_normalize(v @ mat.t())
    sigma = (u_new @ mat @ v.t()).reshape(())
    return sigma, u_new


class Adam:
    """``torch.optim.Adam`` (eps outside the root, bias corrections) as its
    multi-tensor path computes it, on a list of tensors; ``lr_at(count)``
    gives the rate of the update after ``count`` updates (a LambdaLR
    schedule)."""

    def __init__(self, params: List[torch.Tensor], lr_at, beta1: float, beta2: float,
                 eps: float = 1e-8):
        self.params, self.lr_at = params, lr_at
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.first: List[torch.Tensor] = []  # the gradients of the first update

    @torch.no_grad()
    def step(self, grads: Iterable[torch.Tensor]) -> None:
        grads = list(grads)
        if not self.count:
            self.first = [g.clone() for g in grads]
        lr = self.lr_at(self.count)
        self.count += 1
        b1, b2 = self.beta1, self.beta2
        bc1 = 1 - b1 ** self.count
        bc2_sqrt = math.sqrt(1 - b2 ** self.count)
        for p, g, m, v in zip(self.params, grads, self.exp_avg, self.exp_avg_sq):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / bc1)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    for e, p in zip(ema, params):
        e.mul_(decay).add_(p, alpha=1 - decay)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm, in float64 on the host (one copy)."""
    names = list(tensors)
    if not names:
        return {}
    stacked = torch.stack([tensors[n].detach().double().norm() for n in names])
    return dict(zip(names, stacked.cpu().tolist()))


def kink_alternatives(logits: torch.Tensor, kinks: torch.Tensor, slopes: torch.Tensor,
                      grads: List[torch.Tensor], params: List[torch.Tensor],
                      names: List[str], margin: float) -> List[Dict[str, float]]:
    """The norms of a gradient ``grads`` of ``params`` with each hinge term
    whose logit lies within ``margin`` of its kink counted on either side:
    one ``{name: norm}`` per way of counting them (the reference's own
    among them). ``logits``, ``kinks`` and ``slopes`` are flat: the logit,
    where its hinge bends, and the loss's derivative in it where the hinge
    is not flat; the graph from ``params`` to ``logits`` must still be
    held. At most the ``KINK_CAP`` nearest terms are counted both ways."""
    with torch.no_grad():
        dist = (logits.detach() - kinks).abs()
        near = [j for j in torch.argsort(dist)[:KINK_CAP].tolist() if dist[j] < margin]
        counted = (logits.detach() - kinks) * slopes > 0  # the hinge is not flat there
    parts = [torch.autograd.grad(logits[j] * slopes[j], params, retain_graph=True)
             for j in near]
    with torch.no_grad():
        base = list(grads)
        for j, part in zip(near, parts):
            if counted[j]:
                base = [b - p for b, p in zip(base, part)]
        out = []
        for ways in itertools.product((False, True), repeat=len(near)):
            total = list(base)
            for on, part in zip(ways, parts):
                if on:
                    total = [t + p for t, p in zip(total, part)]
            out.append(norms(dict(zip(names, total))))
    return out


@torch.no_grad()
def readings(losses: List[Dict[str, tuple]], grads: Dict[str, torch.Tensor],
             start: Dict[str, torch.Tensor], end: Dict[str, torch.Tensor],
             alternatives: Optional[List[Dict[str, float]]] = None,
             first_logits: Optional[torch.Tensor] = None) -> dict:
    """What a training cell compares (``gan_bench/correct.py``): each step's
    losses ``{name: (value, scale)}``, every logit the critic gave in its
    first update, in call order, the norm of each leaf's first gradient as
    the optimizer holds it, the norm of each leaf's change from ``start`` to
    ``end``, and any ``kink_alternatives`` of D's first gradient."""
    out = {"losses": losses,
           "first_logits": [] if first_logits is None else first_logits.cpu().tolist(),
           "grad": norms(grads),
           "change": norms({n: end[n] - start[n] for n in start})}
    if alternatives:
        out["grad_alternatives"] = alternatives
    return out
