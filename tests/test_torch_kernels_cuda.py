"""The hand-written CUDA kernels (the batched power iteration and the PGGAN
fade-in blend) against their plain PyTorch versions, on the card. Every test here is marked ``cuda`` and skips without a card (a CUDA
kernel has no CPU mode). This file imports no JAX, so on the machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

float32 with TF32 off. Power iteration rtol 1e-4 (atol 1e-5 on vector
entries near 0); fade-in rtol 1e-5 / atol 1e-6 (one multiply-add per
element); networks on the card against the CPU rtol 1e-3 / atol 1e-3.
"""

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.models import pggan, sngan
from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
from gan_lib_tensorflow_tpu_torch.ops import init_weights
from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128), (1152, 128), (1152, 128),
                   (128, 128)] + [(1152, 128)] * 4 + [(128, 1)])
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]
# the SNGAN-projection ImageNet-128 D's widest 3x3 convs: slabs streamed
IMAGENET_WIDE_SHAPES = [(4608, 1024), (9216, 1024)]
# [fan_in, out] of the SNGAN-projection ImageNet-128 D's 19 SN weights, in
# registration order: block0 (3), blocks 1-4 (3 each), block5 (2), dense_out,
# proj_embed (the [1000 classes, 1024] table); 39,435,136 values, 9 streamed
IMAGENET_D_SHAPES = ([(27, 64), (576, 64), (3, 64),
                      (576, 128), (1152, 128), (64, 128),
                      (1152, 256), (2304, 256), (128, 256),
                      (2304, 512), (4608, 512), (256, 512),
                      (4608, 1024), (9216, 1024), (512, 1024),
                      (9216, 1024), (9216, 1024), (1024, 1), (1000, 1024)])
# ragged splits: M not a multiple of 4 (4-byte copies), a last rank narrower
# than the others, K larger than a CTA's threads
RAGGED_SHAPES = [(1153, 130), (64, 3000), (2000, 40)]


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


@pytest.mark.parametrize("shapes", [CIFAR_D_SHAPES, PALLAS_SHAPES, IMAGENET_WIDE_SHAPES,
                                    RAGGED_SHAPES, IMAGENET_D_SHAPES],
                         ids=["cifar_d_shapes", "pallas_shapes", "imagenet_wide_shapes",
                              "ragged_shapes", "imagenet_d_shapes"])
def test_kernel_matches_plain(card, shapes):
    ws, us = _inputs(shapes, card)
    before = pi.launches
    sigma, u_out, v_out = pi.launch(ws, us)
    assert pi.launches == before + 1
    s_ref, u_ref, v_ref = pi.plain_power_iteration(ws, us)
    torch.testing.assert_close(sigma, s_ref, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(u_out, torch.cat(u_ref), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_out, torch.cat(v_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shapes", [CIFAR_D_SHAPES, IMAGENET_WIDE_SHAPES, IMAGENET_D_SHAPES],
                         ids=["cifar_d_shapes", "imagenet_wide_shapes", "imagenet_d_shapes"])
def test_two_launches_are_bit_identical(card, shapes):
    """No atomics and a fixed order of every sum: the same inputs give the
    same sigma, u' and v, bit for bit."""
    ws, us = _inputs(shapes, card, seed=2)
    table = pi.PowerIterationTable()
    first = pi.launch(ws, us, table=table)
    second = pi.launch(ws, us, table=table)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_refused_launch_raises(card):
    """A launch the card refuses (here more shared memory than a CTA may
    have) comes back from the C function as an error and the wrapper raises."""
    ws, us = _inputs(CIFAR_D_SHAPES, card)
    table = pi.PowerIterationTable().get(ws, us)
    table.plan = table.plan._replace(smem_bytes=400_000)
    before = pi.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        pi.launch(ws, us, table=table)
    assert pi.launches == before


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


def test_imagenet_discriminator_on_card_matches_cpu(card):
    """The projection D at full width: its 19 SN weights (the embedding
    among them, read in place as [1024, 1000]) in one launch."""
    gen = torch.Generator().manual_seed(1)
    d = sngan.imagenet128_discriminator()
    init_weights(d, gen)
    x = torch.tanh(torch.randn(2, 128, 128, 3, generator=gen))
    labels = torch.tensor([7, 998])
    with torch.no_grad():
        ref = d(x, labels)
        before = pi.launches
        got = d.to(card)(x.to(card), labels.to(card))
    assert pi.launches == before + 1 and len(d.sn_layers) == 19
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-3, atol=1e-3)


# the tests/test_pallas.py shape, and the PGGAN 1024^2 transition step's two
# blends at batch 4 (G's RGB, D's first block) in channels-last layout
FADEIN_CASES = ([((3, 17, 9, 4), a, False) for a in (0.0, 0.37, 1.0)]
                + [((4, 3, 1024, 1024), 0.37, True), ((4, 32, 512, 512), 0.37, True)])


@pytest.mark.parametrize("shape,alpha,channels_last", FADEIN_CASES,
                         ids=lambda v: str(v))
def test_fadein_matches_plain(card, shape, alpha, channels_last):
    g = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(shape, device=card, generator=g)
    b = torch.randn(shape, device=card, generator=g)
    if channels_last:
        a = a.contiguous(memory_format=torch.channels_last)
        b = b.contiguous(memory_format=torch.channels_last)
    before = fd.launches
    out = fd.fadein_blend(a, b, alpha)
    assert fd.launches == before + 1
    assert out.stride() == a.stride()
    torch.testing.assert_close(out, fd.plain_fadein_blend(a, b, alpha),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,offset", [(1001, 0), (1001, 1), (3, 0), (4096 * 1024 + 3, 2)])
def test_fadein_ragged_and_unaligned(card, n, offset):
    """The scalar tail (n % 4) and the unaligned path (a view off a 16-byte
    boundary)."""
    a = torch.randn(n + offset, device=card)[offset:]
    b = torch.randn(n + offset, device=card)[offset:]
    torch.testing.assert_close(fd.fadein_blend(a, b, 0.37),
                               fd.plain_fadein_blend(a, b, 0.37), rtol=1e-5, atol=1e-6)


BLOCK = 1024 * 4  # elements one block of csrc/fadein_blend.cu covers


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [BLOCK - 1, BLOCK + 1, 3 * BLOCK - 1, 3 * BLOCK + 1])
def test_fadein_bit_equal_around_block_boundaries(card, n, offset):
    """Either side of a whole number of blocks, aligned and off a 16-byte
    boundary: equal to the plain version bit for bit."""
    a = torch.randn(n + offset, device=card)[offset:]
    b = torch.randn(n + offset, device=card)[offset:]
    assert torch.equal(fd.fadein_blend(a, b, 0.37), fd.plain_fadein_blend(a, b, 0.37))


def test_fadein_rejects_mismatched_strides(card):
    a = torch.randn(2, 8, 4, 4, device=card)
    with pytest.raises(ValueError):
        fd.fadein_blend(a, a.contiguous(memory_format=torch.channels_last), 0.5)
    with pytest.raises(ValueError):
        fd.fadein_blend(a, a.to(torch.bfloat16), 0.5)


def test_fadein_gradients_and_double_backward(card):
    x0 = torch.randn(4, 32, 16, 16, device=card).contiguous(memory_format=torch.channels_last)
    results = []
    for fn in (fd.fadein_blend, fd.plain_fadein_blend):
        w = torch.tensor(1.7, device=card, requires_grad=True)
        x = x0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((fn(w * x, x * x, 0.3) ** 2).sum(), x,
                                    create_graph=True)
        (gw,) = torch.autograd.grad((gx ** 2).sum(), w)
        results.append((gx.detach(), gw))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pggan_discriminator_64_on_card_matches_cpu(card):
    """Full width, fade-in at alpha 0.37: the card's kernel launches once."""
    d = pggan.PGGANDiscriminator(resolution=64, fade_in=True, fused_from=128)
    init_weights(d, torch.Generator().manual_seed(0))
    x = torch.tanh(torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        ref = d(x, 0.37)
        before = fd.launches
        got = d.to(card)(x.to(card), 0.37)
    assert fd.launches == before + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-3, atol=1e-3)
