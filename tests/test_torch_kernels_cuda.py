"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a card (a CUDA
kernel has no CPU mode). This file imports no JAX, so on the machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

float32 with TF32 off; rtol 1e-4 (atol 1e-5 on vector entries near 0).
"""

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.models import sngan
from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128), (1152, 128), (1152, 128),
                   (128, 128)] + [(1152, 128)] * 4 + [(128, 1)])
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shapes, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = [torch.randn(k, m, device=dev, generator=g) for m, k in shapes]
    us = [torch.randn(1, k, device=dev, generator=g) for _, k in shapes]
    return ws, us


@pytest.mark.parametrize("shapes", [CIFAR_D_SHAPES, PALLAS_SHAPES],
                         ids=["cifar_d_shapes", "pallas_shapes"])
def test_kernel_matches_plain(card, shapes):
    ws, us = _inputs(shapes, card)
    before = pi.launches
    sigma, u_out, v_out = pi.launch(ws, us)
    assert pi.launches == before + 1
    s_ref, u_ref, v_ref = pi.plain_power_iteration(ws, us)
    torch.testing.assert_close(sigma, s_ref, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(u_out, torch.cat(u_ref), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_out, torch.cat(v_ref), rtol=1e-4, atol=1e-5)


def test_gradient_and_update_through_the_wrapper(card):
    ws, us = _inputs(CIFAR_D_SHAPES, card, seed=1)
    c = torch.randn(len(ws), device=card)
    grads, u_after = [], []
    for fn in (pi.batched_power_iteration,
               lambda w, u, update: pi.plain_power_iteration(w, u)[0]):
        wg = [w.clone().requires_grad_(True) for w in ws]
        uc = [u.clone() for u in us]
        (fn(wg, uc, update=True) * c).sum().backward()
        grads.append([w.grad for w in wg])
        u_after.append(uc)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    _, u_new, _ = pi.plain_power_iteration(ws, us)
    for u, un in zip(u_after[0], u_new):  # the kernel wrote u' back
        torch.testing.assert_close(u.reshape(-1), un, rtol=1e-4, atol=1e-5)


def test_discriminator_on_card_matches_cpu(card):
    d = sngan.cifar_discriminator()
    x = torch.tanh(torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0)))
    with torch.no_grad():
        ref = d(x)
        before = pi.launches
        got = d.to(card)(x.to(card))
    assert pi.launches == before + 1  # one launch for all 11 SN weights
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-3, atol=1e-3)
