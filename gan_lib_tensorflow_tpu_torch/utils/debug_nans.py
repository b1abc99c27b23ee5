"""``--debug-nans`` (the reference's ``jax_debug_nans``, ``cli/common.py:
104-108``): raise ``FloatingPointError`` at the first operation that makes a
NaN, naming it.

In forward a ``TorchDispatchMode`` checks every floating output of every
operator; in backward ``torch.autograd.set_detect_anomaly(True)`` also
names the forward operation whose gradient went wrong. The hand-written
kernels are launched through ``ctypes``, past the dispatcher, so their
wrappers check their own outputs (``check_kernel_output``). Every check
waits for the device: slow by design, as the reference's is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_MODE: Optional["NaNCheckMode"] = None
# operators whose outputs are uninitialized memory, not results
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
                  "new_empty_strided"}


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() > 0
            and bool(torch.isnan(t).any()))


class NaNCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an operator returns a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func._overloadpacket.__name__ not in _UNINITIALIZED
                and any(_has_nan(t) for t in tree_flatten(out)[0])):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


def enable() -> None:
    """Turn the checks on for the rest of the process."""
    global _MODE
    if _MODE is None:
        torch.autograd.set_detect_anomaly(True)
        _MODE = NaNCheckMode()
        _MODE.__enter__()


def disable() -> None:
    global _MODE
    if _MODE is not None:
        _MODE.__exit__(None, None, None)
        _MODE = None
        torch.autograd.set_detect_anomaly(False)


def enabled() -> bool:
    return _MODE is not None


def check_kernel_output(name: str, *outputs: torch.Tensor) -> None:
    """Under ``--debug-nans``: raise if a kernel's output holds a NaN."""
    if _MODE is not None and any(_has_nan(t) for t in outputs):
        raise FloatingPointError(f"NaN in the output of the {name}")
