"""The batch-norm kernels (``csrc/batch_norm.cu``) against the plain version
of ``ops/norms.py``, on the card. Every test here is marked ``cuda`` and
skips without a card (a CUDA kernel has no CPU mode). This file imports no
JAX, so on the machine with the card it runs without the JAX package's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm_cuda.py

Tolerances, and why:
- y: one rounding step of the output type (rtol 2^-7 in bf16, 1e-5 in
  float32) plus atol 1e-5: both versions sum the float32 statistics in
  another order (about 1e-6 relative apart), which can move y across a
  rounding boundary of the output type;
- dy is zeroed where the plain version's float32 y lies within 1e-3 of the
  ReLU's 0, so that the same 1e-6 cannot flip the recomputed mask between
  the two versions;
- dx: one rounding step of x's type (rtol 2^-7 in bf16, 1e-4 in float32),
  plus atol 1e-4 of the largest |dx|: the kernel computes rstd * (gamma dy'
  - mean - xhat * mean) in one expression where autograd adds five terms;
- the gamma/beta rows' and the affine weight's and bias's gradients (float32
  sums over H*W, and over N): rtol 1e-4, atol 1e-4 of the largest value;
- running statistics: rtol 1e-5, atol 1e-6 (the summation order).
"""

import copy

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.ops import norms

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (channels, spatial size) of the SNGAN-projection ImageNet-128 G's 11 norms
# in forward order: block0-4 bn1, bn2 (conditional), then bn_out (plain BN)
G_SHAPES = [(1024, 4), (1024, 8), (1024, 8), (512, 16), (512, 16), (256, 32), (256, 32),
            (128, 64), (128, 64), (64, 128), (64, 128)]
G_NAMES = ["block0.bn1", "block0.bn2", "block1.bn1", "block1.bn2", "block2.bn1",
           "block2.bn2", "block3.bn1", "block3.bn2", "block4.bn1", "block4.bn2", "bn_out"]
NUM_CLASSES = 1000
RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
DX_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _module(kind: str, c: int, out_dtype, dev, gen):
    if kind == "cbn":
        m = norms.ConditionalBatchNorm(NUM_CLASSES, c, compute_dtype=out_dtype)
        with torch.no_grad():
            m.gamma.weight.copy_(1 + 0.2 * torch.randn(c, NUM_CLASSES, generator=gen))
            m.beta.weight.copy_(0.2 * torch.randn(c, NUM_CLASSES, generator=gen))
    else:
        m = norms.BatchNorm(c, compute_dtype=out_dtype, affine=kind == "bn")
        if kind == "bn":
            with torch.no_grad():
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
    with torch.no_grad():
        bn = m.bn if kind == "cbn" else m
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_var.copy_(1 + 0.1 * torch.rand(c, generator=gen))
    return m.to(dev)


def _stats(m):
    bn = m.bn if isinstance(m, norms.ConditionalBatchNorm) else m
    return bn.running_mean, bn.running_var


def _params(m, labels):
    if labels is not None:
        return m.gamma(labels), m.beta(labels)
    return (m.weight, m.bias) if m.affine else (None, None)


def _run(m, x, labels, kw, plain: bool):
    """Forward through the module (the kernels) or through the plain version
    with the same parameters; returns y."""
    if not plain:
        return m(x, labels, **kw) if labels is not None else m(x, **kw)
    return norms.plain_batch_norm(x, *_params(m, labels), *_stats(m),
                                  m.compute_dtype or x.dtype, **kw)


def _pre_relu_f32(m, x, labels, kw):
    """The plain version's float32 y before the cast and the ReLU (no
    running-stat update)."""
    k = dict(kw, relu=False, update_stats=False)
    rm, rv = (t.clone() for t in _stats(m))
    return norms.plain_batch_norm(x, *_params(m, labels), rm, rv, torch.float32, **k)


def _close_scaled(got, want, rtol, scale_tol, what):
    atol = scale_tol * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol, msg=what)


def compare(m, x, labels, kw, dy_contiguous: bool = False):
    """Kernel against plain version on copies of the same module: y (dtype
    and layout too), the running statistics, dx and every parameter's
    gradient, dy laid out as y (or NCHW-contiguous). Returns the kernel's
    dx."""
    plain_m = copy.deepcopy(m)
    xk = x.detach().clone().requires_grad_()
    xp = x.detach().clone().requires_grad_()
    before, before_bw = norms.launches, norms.backward_launches
    y = _run(m, xk, labels, kw, plain=False)
    assert norms.launches == before + 1
    y_ref = _run(plain_m, xp, labels, kw, plain=True)
    assert y.dtype == y_ref.dtype and y.shape == x.shape
    assert all(a == b for a, b, n in zip(y.stride(), x.stride(), x.shape) if n > 1)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=RTOL[y.dtype], atol=1e-5)
    for got, want in zip(_stats(m), _stats(plain_m)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        far = _pre_relu_f32(plain_m, xp.detach(), labels, kw).abs() > 1e-3
    g = torch.Generator(device=x.device).manual_seed(7)
    dy = (torch.empty_like(y, dtype=torch.float32).normal_(generator=g) * far).to(y.dtype)
    y.backward(dy.contiguous() if dy_contiguous else dy)
    assert norms.backward_launches == before_bw + 1 and norms.launches == before + 2
    y_ref.backward(dy)
    _close_scaled(xk.grad, xp.grad, DX_RTOL[x.dtype], 1e-4, "dx")
    for (name, p), (_, q) in zip(m.named_parameters(), plain_m.named_parameters()):
        assert p.grad is not None, name
        _close_scaled(p.grad, q.grad, 1e-4, 1e-4, name)
    return xk.grad


@pytest.mark.parametrize("batch,groups", [(64, 1), (320, 5)], ids=["g_update", "fakes"])
@pytest.mark.parametrize("index", range(len(G_SHAPES)), ids=G_NAMES)
def test_generator_shapes_match_plain(card, index, batch, groups):
    """The ImageNet-128 G's 11 norms, bf16 channels-last with the ReLU: the
    G update (batch 64, one group, running stats advance) and the fakes
    (5 x 64, 5 groups)."""
    c, s = G_SHAPES[index]
    gen = torch.Generator().manual_seed(index)
    kind = "bn" if G_NAMES[index] == "bn_out" else "cbn"
    m = _module(kind, c, torch.bfloat16, card, gen)
    x = (torch.randn(batch, c, s, s, generator=gen) * 1.5 + 0.3).to(card, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, NUM_CLASSES, (batch,), generator=gen).to(card) \
        if kind == "cbn" else None
    compare(m, x, labels, dict(groups=groups, update_stats=groups == 1, relu=True))


LAYOUTS = ["channels_last", "nchw", "2d"]


def _input(layout, n, c, s, dtype, dev, gen):
    if layout == "2d":
        return (torch.randn(n, c, generator=gen) * 2 - 0.5).to(dev, dtype)
    x = (torch.randn(n, c, s, s, generator=gen) * 2 - 0.5).to(dev, dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


@pytest.mark.parametrize("running", [False, True], ids=["batch_stats", "running_stats"])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["bn", "bn_noaffine", "cbn"])
def test_layouts_dtypes_relu_and_running_stats(card, kind, layout, dtype, relu, running):
    """Every layout, both dtypes, the ReLU on and off, batch and running
    statistics, BN (with and without scale and bias) and CBN; C 32 (16-byte
    loads) at 6 x 6 and 8 x 8."""
    gen = torch.Generator().manual_seed(3)
    for s in (6, 8):
        m = _module(kind, 32, None, card, gen)
        x = _input(layout, 12, 32, s, dtype, card, gen)
        labels = torch.randint(0, NUM_CLASSES, (12,), generator=gen).to(card) \
            if kind == "cbn" else None
        compare(m, x, labels, dict(use_running_average=running, relu=relu))


@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.float32, torch.bfloat16),
                                               (torch.bfloat16, torch.float32)],
                         ids=["f32_to_bf16", "bf16_to_f32"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_output_dtype_other_than_the_input(card, layout, x_dtype, out_dtype):
    gen = torch.Generator().manual_seed(4)
    m = _module("bn", 40, out_dtype, card, gen)
    compare(m, _input(layout, 10, 40, 5, x_dtype, card, gen), None,
            dict(relu=True, groups=2, update_stats=False), dy_contiguous=True)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_ragged_and_unaligned_take_one_element_loads(card, layout):
    """C 20 (channels-last) and H*W 49 (NCHW) are no multiple of 8, and an
    x that starts 2 bytes off a 16-byte boundary: the kernels load one
    element at a time there."""
    gen = torch.Generator().manual_seed(5)
    m = _module("cbn", 20, torch.bfloat16, card, gen)
    labels = torch.randint(0, NUM_CLASSES, (9,), generator=gen).to(card)
    x = _input(layout, 9, 20, 7, torch.bfloat16, card, gen)
    assert norms._plan_for(x, *norms.layout_of(x)).vec == 1
    compare(m, x, labels, dict(relu=True))
    m = _module("bn", 64, torch.bfloat16, card, gen)
    flat = torch.randn(9 * 64 * 16 + 1, generator=gen).to(card, torch.bfloat16)
    x = flat[1:].view(9, 16, 64).permute(0, 2, 1).view(9, 64, 4, 4)  # channels-last, off by 2 B
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 == 2
    assert norms._plan_for(x, *norms.layout_of(x)).vec == 1
    compare(m, x, None, dict(relu=True))


def test_pix2pix_bottleneck_batch_one_clamps_the_variance(card):
    """pix2pix's 1x1 bottleneck at batch 1: one element a channel, so the
    variance is 0 (clamped where rounding makes it negative), y = beta, and
    dx is 0 as autograd gives it."""
    gen = torch.Generator().manual_seed(6)
    for layout in ("channels_last", "nchw"):
        m = _module("bn", 512, torch.bfloat16, card, gen)
        x = _input(layout, 1, 512, 1, torch.bfloat16, card, gen)
        dx = compare(m, x, None, dict(relu=False))
        assert float(dx.abs().max()) == 0.0


def test_two_launches_are_bit_identical(card):
    gen = torch.Generator().manual_seed(8)
    m = _module("cbn", 128, torch.bfloat16, card, gen)
    x = _input("channels_last", 64, 128, 64, torch.bfloat16, card, gen).requires_grad_()
    labels = torch.randint(0, NUM_CLASSES, (64,), generator=gen).to(card)
    outs = []
    for _ in range(2):
        x.grad = None
        m.zero_grad()
        y = m(x, labels, relu=True, update_stats=False)
        y.backward(torch.ones_like(y))
        outs.append((y, x.grad, m.gamma.weight.grad, m.beta.weight.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_strided_or_unsupported_input_raises(card):
    """No fallback: a strided CUDA x, a float16 x, or gamma rows of another
    shape raise before any launch."""
    m = norms.BatchNorm(16).to(card)
    before = norms.launches
    x = torch.randn(4, 16, 8, 8, device=card)
    with pytest.raises(ValueError, match="dense channels-last or NCHW"):
        m(x[:, :, ::2])
    with pytest.raises(ValueError, match="float32 or bf16"):
        m(x.half())
    with pytest.raises(ValueError, match="gamma must be"):
        norms.batch_norm(x, torch.ones(8, device=card), None, m.running_mean, m.running_var,
                         torch.float32)
    assert norms.launches == before


def test_export_on_the_card_traces_the_plain_version(card, tmp_path):
    """``train/export.py``'s serving bundle of a conditional G block on the
    card records the plain version (no launch while tracing); the exported
    module matches the eager kernels within the tolerances above."""
    from gan_lib_tensorflow_tpu_torch.ops.blocks import GenResBlock
    from gan_lib_tensorflow_tpu_torch.train.export import write_serving_bundle

    class Serve(torch.nn.Module):
        def __init__(self, block, labels):
            super().__init__()
            self.block = block
            self.register_buffer("labels", labels)

        def forward(self, x):
            return self.block(x, self.labels, train=False)

    gen = torch.Generator().manual_seed(9)
    block = GenResBlock(64, 64, torch.bfloat16, num_classes=NUM_CLASSES).to(card)
    x = torch.randn(4, 64, 8, 8, generator=gen).to(card, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    serve = Serve(block, torch.randint(0, NUM_CLASSES, (4,), generator=gen).to(card))
    before = norms.launches
    path = write_serving_bundle(str(tmp_path), 1, {}, serve, x)
    assert norms.launches == before
    with torch.no_grad():
        got = torch.export.load(path).module()(x)
        want = serve(x)
    assert norms.launches == before + 2
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6, atol=0.05)


def test_export_outside_plain_version_raises(card):
    """No second route to the plain version on the card: a trace that does
    not ask for it through ``norms.plain_version()`` fails."""
    m = norms.BatchNorm(16).to(card)
    x = torch.randn(4, 16, 8, 8, device=card)
    before = norms.launches
    with torch.no_grad(), pytest.raises(Exception, match="plain_version"):
        torch.export.export(m, (x,))
    assert norms.launches == before


def test_imagenet_step_launches_22_forward_and_11_backward(card):
    """One SNGAN-projection ImageNet-128 step of ``make_train_step`` (G at
    1/8 width: the count does not depend on it): 11 norms in the fakes'
    forward and 11 in the G update's, and 11 backward calls."""
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
    from gan_lib_tensorflow_tpu_torch.train import make_train_step

    args = train_sngan_imagenet.parse_args([
        "--device", "cuda", "--batch-size", "8", "--n-critic", "5", "--width-mul", "0.125",
        "--compute-dtype", "bf16", "--steps", "10"])
    g, d, spec, state = train_sngan_imagenet.build(args)
    step = make_train_step(spec)
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(5, 8, 128, 128, 3, generator=gen).to(card) * 2 - 1,
             "label": torch.randint(0, 1000, (5, 8), generator=gen).to(card)}
    norms.launches = norms.backward_launches = 0
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (norms.launches - norms.backward_launches, norms.backward_launches) == (22, 11)
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
