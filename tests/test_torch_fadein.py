"""The port's fade-in blend (``ops/fadein.py``): its plain version against the
JAX Pallas kernel run in interpret mode (as tests/test_pallas.py runs it),
the kernel's ``autograd.Function`` (driven here by the plain forward, the
same Function the card runs with the kernel's launch) under ``gradcheck`` and
``gradgradcheck``, and the CUDA wrapper's input checks.

Tolerance rtol 1e-5 / atol 1e-6, as tests/test_pallas.py: float32 on both
sides, one multiply-add per element. gradcheck runs in float64 at its
default tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.ops.pallas_kernels import fadein_blend as jax_fadein_blend
from gan_lib_tensorflow_tpu_torch.ops import fadein

SHAPE = (3, 17, 9, 4)  # tests/test_pallas.py:37


def _ab(shape=SHAPE, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_plain_matches_pallas_interpret(alpha):
    a, b = _ab()
    ref = np.asarray(jax_fadein_blend(jnp.asarray(a), jnp.asarray(b), alpha))
    got = fadein.fadein_blend(torch.tensor(a), torch.tensor(b), alpha)
    assert got.shape == SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), alpha * a + (1 - alpha) * b,
                               rtol=1e-5, atol=1e-6)


def test_plain_on_cpu_does_not_count_launches():
    a, b = (torch.tensor(x) for x in _ab())
    before = fadein.launches
    fadein.fadein_blend(a, b, 0.5)
    assert fadein.launches == before


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_function_gradcheck_and_gradgradcheck(alpha):
    a, b = (torch.tensor(x, requires_grad=True) for x in _ab((2, 3, 4, 5), 2, np.float64))

    def fn(a, b):
        return fadein.FadeinBlend.apply(a, b, alpha, fadein.plain_fadein_blend)

    assert torch.autograd.gradcheck(fn, (a, b))
    assert torch.autograd.gradgradcheck(fn, (a, b))


def test_function_backward_is_differentiable_inside_a_penalty():
    """The second derivative through the blend, as the gradient penalty takes
    it: d/dw of |d(sum(blend(w x, x^2)^2))/dx|^2, Function vs plain."""
    x0 = torch.tensor(_ab((4, 6), 3, np.float64)[0])
    grads = []
    for blend in (lambda a, b: fadein.FadeinBlend.apply(a, b, 0.3, fadein.plain_fadein_blend),
                  lambda a, b: fadein.plain_fadein_blend(a, b, 0.3)):
        w = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
        x = x0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((blend(w * x, x * x) ** 2).sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad((gx ** 2).sum(), w)
        grads.append(gw)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=0.0)


def _meta(shape, **kw):
    return torch.empty(shape, device="meta", **kw)


_REJECTED = {
    "dtype": lambda: (_meta((2, 3, 4, 5)), _meta((2, 3, 4, 5), dtype=torch.bfloat16)),
    "shape": lambda: (_meta((2, 3, 4, 5)), _meta((2, 3, 4, 6))),
    "strides": lambda: (_meta((2, 3, 4, 5)), _meta((2, 3, 4, 5)).contiguous(
        memory_format=torch.channels_last)),
    "not_dense": lambda: (_meta((2, 3, 4, 10))[..., ::2], _meta((2, 3, 4, 10))[..., ::2]),
}


@pytest.mark.parametrize("case", sorted(_REJECTED))
def test_launch_rejects_what_the_kernel_does_not_take(case):
    """The wrapper's checks run before any device work, so they are tested
    on meta tensors (no card needed): mismatched dtype, shape or strides and
    non-dense inputs raise instead of being copied."""
    a, b = _REJECTED[case]()
    with pytest.raises(ValueError):
        fadein.launch(a, b, 0.5)


def test_launch_accepts_matching_channels_last_then_needs_cuda():
    a = _meta((2, 3, 4, 5)).contiguous(memory_format=torch.channels_last)
    b = _meta((2, 3, 4, 5)).contiguous(memory_format=torch.channels_last)
    fadein._check(a, b)  # dense with equal strides: accepted
    with pytest.raises(ValueError, match="CUDA"):
        fadein.launch(a, b, 0.5)


def test_cpu_tensors_never_reach_the_kernel_and_other_devices_raise():
    with pytest.raises(ValueError, match="cpu or cuda"):
        fadein.fadein_blend(_meta((2, 3)), _meta((2, 3)), 0.5)
