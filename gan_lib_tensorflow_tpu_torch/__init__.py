"""PyTorch/CUDA port of ``gan_lib_tensorflow_tpu``.

The JAX package beside this one is the reference; every module here mirrors
the JAX module of the same name and is held against it by the CPU parity
tests in ``tests/test_torch_*.py``. This package never imports JAX or the
JAX package.

Layout at public boundaries stays the JAX package's NHWC (generator output
``[N, 32, 32, 3]``, discriminator input NHWC); inside, tensors are NCHW views
with channels-last strides, the layout cuDNN prefers.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
card they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Turn a device argument into a ``torch.device``; raise on CUDA without
    a card (nothing here falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
