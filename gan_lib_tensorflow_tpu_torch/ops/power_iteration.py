"""Batched spectral-norm power iteration: the wrapper of the hand-written CUDA
kernel ``csrc/power_iteration.cu`` and its plain PyTorch version.

Port of ``gan_lib_tensorflow_tpu/ops/pallas_kernels.py:batched_power_iteration``.
One call runs one power-iteration step for every spectral-norm weight of a
discriminator. Weights are taken ragged in the port's layout (``[out, ...]``,
read as the row-major ``[K=out, M=fan_in]`` matrix ``W^T``); ``u`` buffers
hold ``K`` floats each.

On CPU tensors the wrapper runs the plain version (a loop over
``ops/sn.py:power_iteration``). On CUDA tensors it launches the kernel, or
raises: there is no fallback. The kernel is built at first use by
``ops/cuda_lib.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .cuda_lib import KernelLibrary
from .sn import power_iteration

# Launches of the CUDA kernel in this process (the plain version does not
# count). Callers reset it to 0 to count the launches of one run.
launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.gl_power_iteration.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.gl_power_iteration.restype = ctypes.c_int


library = KernelLibrary("power_iteration", _declare)


def _dims(weights: Sequence[torch.Tensor]) -> Tuple[List[int], List[int]]:
    ks = [int(w.shape[0]) for w in weights]
    return [w.numel() // k for w, k in zip(weights, ks)], ks


class PowerIterationTable:
    """Device table of ``(w_ptr, u_ptr, M, K, v_offset, u_offset)`` rows for a
    fixed list of weights. Owned by one discriminator and rebuilt only when a
    pointer or shape changes: the optimizer updates parameters in place, so
    in training it is built once."""

    def __init__(self):
        self._key = None
        self.table: Optional[torch.Tensor] = None
        self.ms: List[int] = []
        self.ks: List[int] = []

    def get(self, weights: Sequence[torch.Tensor],
            us: Sequence[torch.Tensor]) -> "PowerIterationTable":
        key = (tuple(w.data_ptr() for w in weights),
               tuple(u.data_ptr() for u in us),
               tuple(tuple(w.shape) for w in weights))
        if key != self._key:
            self.ms, self.ks = _dims(weights)
            rows, v_off, u_off = [], 0, 0
            for w, u, m, k in zip(weights, us, self.ms, self.ks):
                rows.append([w.data_ptr(), u.data_ptr(), m, k, v_off, u_off])
                v_off += m
                u_off += k
            self.table = torch.tensor(rows, dtype=torch.int64).to(weights[0].device)
            self._key = key
        return self


def _check(weights: Sequence[torch.Tensor], us: Sequence[torch.Tensor]) -> None:
    if not weights or len(weights) != len(us):
        raise ValueError(f"need one u per weight, got {len(weights)} weights "
                         f"and {len(us)} u buffers")
    dev = weights[0].device
    for i, (w, u) in enumerate(zip(weights, us)):
        for name, t in (("weight", w), ("u", u)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    f"{name} {i}: the kernel takes contiguous float32 tensors "
                    f"on {dev}, got {t.dtype} on {t.device} "
                    f"(contiguous={t.is_contiguous()})")
        if w.dim() < 2 or u.numel() != w.shape[0]:
            raise ValueError(f"weight {i} of shape {tuple(w.shape)} needs a u "
                             f"of {w.shape[0]} values, got {tuple(u.shape)}")
        if w.numel() >= 2**31:
            raise ValueError(f"weight {i} has {w.numel()} values; the kernel "
                             "indexes with 32-bit ints")


def launch(weights: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
           write_u: bool = False, table: Optional[PowerIterationTable] = None):
    """Launch the CUDA kernel once. Returns ``(sigma [N], u_new flat [sum K],
    v flat [sum M])``; when ``write_u`` the kernel also writes u' into ``us``."""
    global launches
    _check(weights, us)
    dev = weights[0].device
    if dev.type != "cuda":
        raise ValueError(f"the power-iteration kernel runs on CUDA tensors, "
                         f"got {dev}")
    t = (table or PowerIterationTable()).get(weights, us)
    sigma = torch.empty(len(weights), device=dev, dtype=torch.float32)
    u_out = torch.empty(sum(t.ks), device=dev, dtype=torch.float32)
    v_out = torch.empty(sum(t.ms), device=dev, dtype=torch.float32)
    lib = library.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gl_power_iteration(
            t.table.data_ptr(), len(weights), sigma.data_ptr(),
            u_out.data_ptr(), v_out.data_ptr(), int(write_u), stream)
    library.check(err, "power-iteration kernel")
    launches += 1
    return sigma, u_out, v_out


class _KernelSigma(torch.autograd.Function):
    """sigma of each weight from the kernel; backward d(sigma_i)/dW_i =
    u'_i v_i^T (u and v are constants, as in the reference)."""

    @staticmethod
    def forward(ctx, us, write_u, table, *weights):
        sigma, u_out, v_out = launch(weights, us, write_u, table)
        ctx.save_for_backward(u_out, v_out)
        ctx.ms, ctx.ks = _dims(weights)
        ctx.shapes = [w.shape for w in weights]
        return sigma

    @staticmethod
    def backward(ctx, grad_sigma):
        u_out, v_out = ctx.saved_tensors
        grads = [(g * torch.outer(u, v)).view(shape) for g, u, v, shape in zip(
            grad_sigma, u_out.split(ctx.ks), v_out.split(ctx.ms), ctx.shapes)]
        return (None, None, None, *grads)


def plain_power_iteration(weights: Sequence[torch.Tensor],
                          us: Sequence[torch.Tensor]):
    """The plain version: ``(sigma [N], [u_new [K]], [v [M]])``, sigma
    differentiable in the weights."""
    sig, u_new, v = [], [], []
    for w, u in zip(weights, us):
        s, un, vv = power_iteration(w.reshape(w.shape[0], -1).T, u.reshape(1, -1))
        sig.append(s)
        u_new.append(un.reshape(-1))
        v.append(vv.reshape(-1))
    return torch.stack(sig), u_new, v


def batched_power_iteration(weights: Sequence[torch.Tensor],
                            us: Sequence[torch.Tensor], update: bool = False,
                            table: Optional[PowerIterationTable] = None
                            ) -> torch.Tensor:
    """sigma ``[N]`` of every weight (differentiable in the weights); the
    ``u`` buffers advance to u' in place only when ``update``."""
    dev = weights[0].device
    if dev.type == "cpu":
        sigma, u_new, _ = plain_power_iteration(weights, us)
        if update:
            with torch.no_grad():
                for u, un in zip(us, u_new):
                    u.copy_(un.reshape(u.shape))
        return sigma
    if dev.type != "cuda":
        raise ValueError(f"batched_power_iteration runs on cpu or cuda, got {dev}")
    return _KernelSigma.apply(list(us), bool(update), table, *weights)
