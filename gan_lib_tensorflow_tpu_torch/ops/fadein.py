"""PGGAN fade-in blend ``alpha * a + (1 - alpha) * b``: the wrapper of the
hand-written CUDA kernel ``csrc/fadein_blend.cu`` and its plain PyTorch
version.

Port of ``gan_lib_tensorflow_tpu/ops/pallas_kernels.py:fadein_blend``. alpha
is a host float (the train state's fade-in weight). On CPU tensors the
wrapper runs the plain version. On CUDA tensors it launches the kernel through
``FadeinBlend``, or raises: there is no fallback. The kernel takes float32
tensors of one shape on one device that are dense (contiguous or
channels-last) with the same strides, and writes ``torch.empty_like(a)``;
the wrapper copies nothing, so callers make the layouts match themselves.
The kernel is built at first use by ``ops/cuda_lib.py``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from ..utils.debug_nans import check_kernel_output
from ..utils.profiler import span
from .cuda_lib import KernelLibrary

# Launches of the CUDA kernel in this process (the plain version does not
# count). Callers reset it to 0 to count the launches of one run.
launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.gl_fadein_blend.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    lib.gl_fadein_blend.restype = ctypes.c_int


library = KernelLibrary("fadein_blend", _declare)


def plain_fadein_blend(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """The plain version, as the reference models write it."""
    return alpha * a + (1.0 - alpha) * b


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"the fade-in kernel takes float32, got {a.dtype} and {b.dtype}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b {tuple(b.shape)} "
                         f"on {b.device} must have one shape on one device")
    # element i of a, b and out must be one logical element: a dense layout,
    # the same strides (a dimension of size 1 has no stride that matters)
    same = all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)
    if not (_dense(a) and same):
        raise ValueError(f"the fade-in kernel takes dense tensors with equal strides, "
                         f"got strides {a.stride()} and {b.stride()} for shape "
                         f"{tuple(a.shape)}")


def launch(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch the CUDA kernel once; returns a new tensor laid out like ``a``."""
    global launches
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the fade-in kernel runs on CUDA tensors, got {a.device}")
    with span("kernel.fadein"):
        out = torch.empty_like(a)
        lib = library.load()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.gl_fadein_blend(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      alpha, 1.0 - alpha, a.numel(), stream)
    library.check(err, "fade-in blend kernel")
    launches += 1
    check_kernel_output("fade-in blend kernel", out)
    return out


class FadeinBlend(torch.autograd.Function):
    """``forward(a, b, alpha)`` computes the blend (the kernel's ``launch``
    on the card; the tests hand it the plain version to check this backward
    on the CPU). The backward is plain torch, ``alpha * g`` and
    ``(1 - alpha) * g`` and nothing for alpha, so it is differentiable again:
    the gradient penalty differentiates D's blend twice."""

    @staticmethod
    def forward(ctx, a, b, alpha: float, forward: Callable):
        ctx.alpha = alpha
        return forward(a, b, alpha)

    @staticmethod
    def backward(ctx, grad):
        return ctx.alpha * grad, (1.0 - ctx.alpha) * grad, None, None


def fadein_blend(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """``alpha * a + (1 - alpha) * b``, differentiable in a and b."""
    alpha = float(alpha)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_fadein_blend(a, b, alpha)
    if a.device.type != "cuda":
        raise ValueError(f"fadein_blend runs on cpu or cuda, got {a.device}")
    return FadeinBlend.apply(a, b, alpha, launch)
