"""The batch norms' CPU path and the CUDA wrapper's checks (``ops/norms.py``).

On CPU tensors ``BatchNorm`` and ``ConditionalBatchNorm`` run the plain
version; these tests hold it, with the fused ``relu`` flag and in every
layout, bit for bit to the composed code the modules ran before the kernels
(copied below), outputs, running statistics and gradients. The kernels
themselves run only on the card (``tests/test_torch_batch_norm_cuda.py``);
here their planner, layout and argument checks, and the launch counter.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from gan_lib_tensorflow_tpu_torch.models import sngan
from gan_lib_tensorflow_tpu_torch.ops import norms

MOMENTUM, EPSILON = 0.9, 1e-5


def composed_bn(m, x, use_running_average=False, groups=1, update_stats=True):
    """``BatchNorm.forward`` as the module computed it before the kernels."""
    out_dtype = x.dtype if m.compute_dtype is None else m.compute_dtype
    xf = x.float()
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if use_running_average:
        mean = m.running_mean.view(shape)
        var = m.running_var.view(shape)
    else:
        xg = xf.reshape(groups, x.shape[0] // groups, *x.shape[1:])
        dims = (1,) + tuple(range(3, xg.dim()))
        gshape = (groups, 1, -1) + (1,) * (x.dim() - 2)
        count = xg[0].numel() // xg.shape[2]
        sums = torch.stack([xg.sum(dim=dims), (xg * xg).sum(dim=dims)])
        mean, mean2 = (sums / count).view(2, *gshape).unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if update_stats:
            with torch.no_grad():
                m.running_mean.mul_(MOMENTUM).add_(mean.view(-1), alpha=1 - MOMENTUM)
                m.running_var.mul_(MOMENTUM).add_(var.view(-1), alpha=1 - MOMENTUM)
        xf = xg
    y = ((xf - mean) * torch.rsqrt(var + EPSILON)).reshape(x.shape)
    if m.affine:
        y = y * m.weight.view(shape) + m.bias.view(shape)
    return y.to(out_dtype)


def composed_cbn(m, x, labels, use_running_average=False, groups=1, update_stats=True):
    """``ConditionalBatchNorm.forward`` as it was before the kernels."""
    normed = composed_bn(m.bn, x, use_running_average, groups, update_stats)
    shape = (x.shape[0], -1) + (1,) * (x.dim() - 2)
    y = normed * m.gamma(labels).view(shape) + m.beta(labels).view(shape)
    return y.to(x.dtype if m.compute_dtype is None else m.compute_dtype)


def _module(kind, c, dtype, gen):
    if kind == "cbn":
        m = norms.ConditionalBatchNorm(7, c, compute_dtype=dtype)
        params = [m.gamma.weight, m.beta.weight]
    else:
        m = norms.BatchNorm(c, compute_dtype=dtype, affine=kind == "bn")
        params = [m.weight, m.bias] if kind == "bn" else []
    with torch.no_grad():
        for p in params:
            p.copy_(torch.randn(p.shape, generator=gen))
    return m


def _input(layout, dtype, gen):
    if layout == "2d":
        return torch.randn(4, 6, generator=gen).to(dtype)
    x = torch.randn(4, 6, 3, 5, generator=gen).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


MODES = {"batch": dict(), "groups": dict(groups=2, update_stats=False),
         "running": dict(use_running_average=True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last", "2d"])
@pytest.mark.parametrize("kind", ["bn", "bn_noaffine", "cbn"])
def test_cpu_path_is_the_composed_code_bit_for_bit(kind, layout, relu, mode, dtype):
    """Outputs, running statistics and every gradient equal the composed code
    followed by ``F.relu`` (where ``relu``), in each layout; no launch."""
    gen = torch.Generator().manual_seed(0)
    m = _module(kind, 6, dtype, gen)
    ref_m = copy.deepcopy(m)
    x = _input(layout, dtype, gen)
    labels = torch.tensor([0, 3, 6, 3])
    before = norms.launches
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    kw = MODES[mode]
    if kind == "cbn":
        y = m(xa, labels, relu=relu, **kw)
        y_ref = composed_cbn(ref_m, xb, labels, **kw)
    else:
        y = m(xa, relu=relu, **kw)
        y_ref = composed_bn(ref_m, xb, **kw)
    y_ref = F.relu(y_ref) if relu else y_ref
    assert torch.equal(y, y_ref) and y.dtype == y_ref.dtype and y.stride() == y_ref.stride()
    for a, b in zip(m.buffers(), ref_m.buffers()):
        assert torch.equal(a, b)
    dy = torch.randn(y.shape, generator=gen).to(y.dtype)
    y.backward(dy)
    y_ref.backward(dy)
    assert torch.equal(xa.grad, xb.grad)
    for (name, p), (_, q) in zip(m.named_parameters(), ref_m.named_parameters()):
        assert torch.equal(p.grad, q.grad), name
    assert norms.launches == before


def test_generator_on_cpu_launches_nothing():
    """A conditional G's forward and backward on the CPU: the plain version
    throughout, the counters untouched."""
    norms.launches = norms.backward_launches = 0
    g = sngan.ResNetGenerator(channels=(8, 8), bottom_ch=8, z_dim=4, num_classes=3)
    out = g(torch.randn(2, 4), torch.tensor([0, 2]))
    out.sum().backward()
    assert (norms.launches, norms.backward_launches) == (0, 0)


@pytest.mark.parametrize("layout,n,c,hw", [
    (norms.CHANNELS_LAST, 64, 1024, 16), (norms.CHANNELS_LAST, 320, 64, 16384),
    (norms.CHANNELS_LAST, 64, 64, 16384), (norms.CHANNELS_LAST, 1, 512, 1),
    (norms.CHANNELS_LAST, 9, 20, 49), (norms.CHANNELS_LAST, 2, 4096, 1),
    (norms.NCHW, 64, 64, 16384), (norms.NCHW, 9, 20, 49), (norms.NCHW, 1, 3, 7),
    (norms.NCHW, 2, 8, 1 << 20)])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_row_once(layout, n, c, hw, aligned):
    """The chunks tile H*W exactly; 16-byte loads only where the contiguous
    axis is a multiple of 8 and the pointers are aligned; NCHW chunks whole
    vectors; no more chunks than leave each thread its minimum of work."""
    p = norms.plan(layout, n, c, hw, aligned, 132)
    inner = c if layout == norms.CHANNELS_LAST else hw
    assert p.vec == (8 if aligned and inner % 8 == 0 else 1)
    assert p.k >= 1 and (p.k - 1) * p.chunk < hw <= p.k * p.chunk
    if layout == norms.NCHW:
        assert p.chunk % p.vec == 0
    if p.k > 1:
        ct = min(c // p.vec, norms.THREADS)
        lanes = norms.THREADS // ct if layout == norms.CHANNELS_LAST else 32 * p.vec
        assert p.chunk >= lanes * norms.MIN_VECTORS // 2
    assert p.args == (layout, p.vec, n, c, hw, p.k, p.chunk)


def test_plan_fills_the_card_at_the_largest_generator_shapes():
    """bn_out's G-update shape gets at least a few blocks a SM, and the
    fakes' shape no fewer."""
    for n in (64, 320):
        p = norms.plan(norms.CHANNELS_LAST, n, 64, 128 * 128, True, 132)
        assert n * p.k >= norms.WAVE_BLOCKS * 132


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(4, 6, 3, 5)[:, :, ::2],
    lambda: torch.zeros(4, 6, 3, 5).transpose(2, 3),
    lambda: torch.zeros(6, 4).t(),
    lambda: torch.zeros(4, 6, 3),
    lambda: torch.zeros(2, 4, 6, 3, 5)], ids=["strided", "transposed_hw", "transposed_2d",
                                              "3d", "5d"])
def test_layout_of_refuses_what_the_kernels_do_not_index(make):
    with pytest.raises(ValueError, match="dense channels-last or NCHW"):
        norms.layout_of(make())


def test_layout_of_takes_both_dense_layouts_and_2d():
    x = torch.zeros(4, 6, 3, 5)
    assert norms.layout_of(x) == (norms.NCHW, 15)
    assert norms.layout_of(x.contiguous(memory_format=torch.channels_last)) == \
        (norms.CHANNELS_LAST, 15)
    assert norms.layout_of(torch.zeros(4, 6)) == (norms.CHANNELS_LAST, 1)
    # 1x1 spatial is both: taken as channels-last, whose offsets NCHW's equal
    assert norms.layout_of(torch.zeros(1, 512, 1, 1)) == (norms.CHANNELS_LAST, 1)


@pytest.mark.parametrize("x_dtype,out_dtype,groups,match", [
    (torch.float16, torch.float16, 1, "float32 or bf16"),
    (torch.float32, torch.float16, 1, "float32 or bf16"),
    (torch.float64, torch.float32, 1, "float32 or bf16"),
    (torch.float32, torch.float32, 3, "not divisible"),
])
def test_check_inputs_refuses_other_dtypes_and_groups(x_dtype, out_dtype, groups, match):
    with pytest.raises(ValueError, match=match):
        norms.check_inputs(torch.zeros(4, 6, 3, 5, dtype=x_dtype), out_dtype, groups)


def test_gamma_rows_must_be_float32_c_or_n_by_c():
    x = torch.zeros(4, 6, 3, 5)
    assert norms._row_param(None, x, "gamma") == (None, 0)
    assert norms._row_param(torch.ones(6), x, "gamma")[1] == 0
    assert norms._row_param(torch.ones(4, 6), x, "gamma")[1] == 6
    for bad in (torch.ones(5), torch.ones(4, 6, dtype=torch.float64), torch.ones(6, 4).t(),
                torch.ones(3, 6)):
        with pytest.raises(ValueError, match="gamma must be"):
            norms._row_param(bad, x, "gamma")


def test_the_kernels_refuse_cpu_tensors_and_count_nothing():
    x = torch.zeros(4, 6, 3, 5)
    call = norms._Call(1, True, 60, False, torch.float32)
    before = norms.launches
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        norms.launch_forward(x, None, None, torch.zeros(6), torch.ones(6), call, False)
    assert norms.launches == before


def test_export_traces_the_plain_version():
    """``torch.export`` of a conditional G block (the serving bundle's path)
    records the composed ops, which run with no model code and equal the
    eager module; nothing is launched."""
    from gan_lib_tensorflow_tpu_torch.ops.blocks import GenResBlock

    block = GenResBlock(8, 8, num_classes=3).eval()
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([0, 2])
    before = norms.launches
    with torch.no_grad():
        program = torch.export.export(block, (x, labels), kwargs={"train": False})
        want = block(x, labels, train=False)
    assert torch.equal(program.module()(x, labels, train=False), want)
    assert norms.launches == before


def test_plain_batch_norm_takes_per_sample_rows():
    """``[N, C]`` weight and bias rows (a conditional BN's) scale each sample
    as the composed conditional code does, bit for bit."""
    gen = torch.Generator().manual_seed(2)
    m = _module("cbn", 6, torch.bfloat16, gen)
    x = _input("channels_last", torch.bfloat16, gen)
    labels = torch.tensor([1, 1, 5, 0])
    ref_m = copy.deepcopy(m)
    y = norms.plain_batch_norm(x, m.gamma(labels), m.beta(labels), m.bn.running_mean,
                               m.bn.running_var, torch.bfloat16)
    assert torch.equal(y, composed_cbn(ref_m, x, labels))
    assert torch.equal(m.bn.running_mean, ref_m.bn.running_mean)


def test_the_plain_version_runs_inside_plain_version_on_any_device():
    """Inside ``plain_version()`` a meta tensor (as a tracer holds) takes the
    plain version; outside it the module refuses the device."""
    m = norms.ConditionalBatchNorm(3, 6).to("meta")
    x, labels = torch.zeros(4, 6, 3, 5, device="meta"), torch.zeros(4, dtype=torch.long,
                                                                     device="meta")
    with norms.plain_version():
        assert m(x, labels, relu=True).shape == x.shape
    assert not norms._plain
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        m(x, labels)


def test_a_trace_outside_plain_version_raises(monkeypatch):
    """No second route to the plain version: a trace of a non-CPU tensor
    outside ``plain_version()`` raises; CPU tensors and the context still
    take the plain version."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    m = norms.BatchNorm(6)
    assert m(torch.ones(4, 6)).shape == (4, 6)
    meta = copy.deepcopy(m).to("meta")
    x = torch.zeros(4, 6, 3, 5, device="meta")
    with pytest.raises(ValueError, match="cannot be traced"):
        meta(x)
    with norms.plain_version():
        assert meta(x).shape == x.shape


def test_the_serving_bundle_is_traced_inside_plain_version(monkeypatch, tmp_path):
    """``train/export.py`` makes the decision: its ``torch.export`` runs
    inside ``plain_version()``, and the bundle equals the eager module."""
    from gan_lib_tensorflow_tpu_torch.train import export

    seen = []
    real = torch.export.export

    def spy(*args, **kwargs):
        seen.append(norms._plain)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.export, "export", spy)
    m = norms.BatchNorm(6).eval()
    x = torch.randn(2, 6, 3, 5, generator=torch.Generator().manual_seed(3))
    path = export.write_serving_bundle(str(tmp_path), 1, {}, m, x)
    assert seen == [True] and not norms._plain
    with torch.no_grad():
        assert torch.equal(torch.export.load(path).module()(x), m(x))


def test_other_devices_raise():
    m = norms.BatchNorm(6)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        m(torch.zeros(4, 6, 3, 5, device="meta"))
