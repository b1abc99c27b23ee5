"""Spectral normalization (port of ``gan_lib_tensorflow_tpu/ops/sn.py``).

``power_iteration`` is the plain version of one power-iteration step, and the
reference the hand-written kernel in ``ops/power_iteration.py`` is held
against. The port keeps weights as ``[out, fan_in]`` (a conv weight in OIHW
reshaped, or a Dense weight ``[out, in]``): that is ``W^T`` of the JAX
package's ``[fan_in, out]`` matrix. The arithmetic below is written on
``w_mat = W`` so it reads like the reference.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor):
    """One power-iteration step on ``w_mat`` (``[fan_in, out]``), the only
    count the port's models use (the reference's ``n_iters=1``).

    Returns ``(sigma, u_new, v)``: u and v are detached, so
    d(sigma)/dW = v^T u_new only (reference ``sn.py:47-49``).
    """
    w_const = w_mat.detach()
    v = _l2_normalize(u.detach() @ w_const.T)  # [1, fan_in]
    u = _l2_normalize(v @ w_const)             # [1, out]
    sigma = (v @ w_mat @ u.T).reshape(())
    return sigma, u, v
