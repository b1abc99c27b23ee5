"""Normalizations (port of ``gan_lib_tensorflow_tpu/ops/norms.py``): the
SNGAN path's ``BatchNorm``, SNGAN-projection's ``ConditionalBatchNorm``, and
PGGAN's ``pixel_norm`` and ``minibatch_stddev`` (stateless functions).

Not torch's ``BatchNorm2d``: ``momentum`` is the fraction of the running
stats kept (0.9), the variance is the biased ``max(E[x^2] - E[x]^2, 0)``,
every statistic is float32, and the output is cast to ``compute_dtype``.

``groups`` splits the batch into equal microbatches with their own batch
statistics: the reference's vmap over the n_critic fake microbatches
(``models/sngan.py:160-181``), run as one batched forward here.

Inside a ``parallel.sharded_step`` the batch statistics are the global
batch's, as the reference's are under GSPMD: batch norm all-reduces its
``[sum x, sum x^2]`` over the 'data' ranks, and minibatch stddev its
group sums, both differentiably, so the gradients carry the terms that
cross ranks and the running statistics stay equal on every rank.

Both batch norms take ``relu=True`` for the ReLU that follows them. On CPU
tensors they run the plain version (``plain_batch_norm``: composed PyTorch,
the ReLU after the cast), and so they do inside ``plain_version()`` on any
device: ``train/export.py`` traces the serving bundle's G there, so the
exported G runs the plain version's ATen ops, not the kernels (traced
tensors hold no data for a kernel launched through ``ctypes``, and the
bundle runs with no model code). Any other trace (``torch.export`` or
``torch.compile`` outside ``plain_version()``) raises. On CUDA tensors they
run the hand-written kernels of ``csrc/batch_norm.cu`` (forward: a
statistics pass, a fixed-order combine of its partial sums, an apply pass;
backward the same, through ``KernelBatchNorm``), or raise: there is no
fallback. The kernels take float32 or bf16 x, a float32 or bf16 output, and
x dense in channels-last (``[N, C]`` included) or NCHW-contiguous layout.
They are built at first use by ``ops/cuda_lib.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..parallel.mesh import active
from ..parallel.sharding import global_batch, sum_over_data
from ..utils.debug_nans import check_kernel_output
from ..utils.profiler import span
from .cuda_lib import KernelLibrary
from .layers import Embedding


MOMENTUM = 0.9   # fraction of the running stats kept per update
EPSILON = 1e-5

# Calls of the CUDA kernels in this process, forward and backward (the plain
# version does not count), and of those the backward ones. Callers reset
# them to 0 to count the calls of one run.
launches = 0
backward_launches = 0


def plain_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                     running_var: torch.Tensor, out_dtype: torch.dtype,
                     use_running_average: bool = False, groups: int = 1,
                     update_stats: bool = True, relu: bool = False) -> torch.Tensor:
    """The plain version: BN of x (NCHW or ``[N, C]``) in float32 ATen ops,
    ``weight``/``bias`` applied (``[C]``, ``[N, C]`` rows as a conditional
    BN's, or None), cast to ``out_dtype``, then ReLU when asked. Running
    stats advance in place only in training mode with ``update_stats`` and
    one group."""
    xf = x.float()
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if use_running_average:
        mean = running_mean.view(shape)
        var = running_var.view(shape)
    else:
        xg = xf.reshape(groups, x.shape[0] // groups, *x.shape[1:])
        dims = (1,) + tuple(range(3, xg.dim()))
        gshape = (groups, 1, -1) + (1,) * (x.dim() - 2)
        # the global batch's moments: one all-reduce of both sums
        count = global_batch(xg[0].numel() // xg.shape[2])
        sums = sum_over_data(torch.stack([xg.sum(dim=dims), (xg * xg).sum(dim=dims)]))
        mean, mean2 = (sums / count).view(2, *gshape).unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if update_stats:
            if groups != 1:
                raise ValueError("running stats advance only for one group")
            with torch.no_grad():
                m = MOMENTUM
                running_mean.mul_(m).add_(mean.view(-1), alpha=1 - m)
                running_var.mul_(m).add_(var.view(-1), alpha=1 - m)
        xf = xg
    y = ((xf - mean) * torch.rsqrt(var + EPSILON)).reshape(x.shape)
    if weight is not None:
        pshape = (weight.shape[0] if weight.dim() == 2 else 1,) + shape[1:]
        y = y * weight.view(pshape) + bias.view(pshape)
    y = y.to(out_dtype)
    return F.relu(y) if relu else y


# --- the CUDA kernels ---------------------------------------------------------

THREADS = 256      # a block's threads (the kernels' kThreads)
WARPS = THREADS // 32
WAVE_BLOCKS = 4    # blocks of a pass per SM that the chunks aim for
MIN_VECTORS = 4    # vectors a thread walks at least, before a chunk is split
CHANNELS_LAST, NCHW = 0, 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_f, _i, _p, _ll = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_SHAPE = [_i] * 7   # layout, vec, n, c, hw, k, chunk (+ groups after)


def _declare(lib: ctypes.CDLL) -> None:
    lib.gl_bn_forward_sums.argtypes = [_p, _i, *_SHAPE, _i, _p, _p, _p]
    lib.gl_bn_forward_apply.argtypes = [_p, _i, _p, _i, *_SHAPE, _i, _p, _ll, _p, _ll, _p, _f,
                                        _p, _p, _p, _p, _f, _f, _f, _i, _p]
    lib.gl_bn_backward_sums.argtypes = [_p, _i, _p, _i, *_SHAPE, _i, _p, _ll, _p, _ll, _p, _f,
                                        _p, _p, _f, _i, _p, _p, _p, _p]
    lib.gl_bn_backward_apply.argtypes = [_p, _i, _p, _i, _p, *_SHAPE, _i, _p, _ll, _p, _ll,
                                         _p, _f, _p, _p, _p, _f, _i, _p]
    for fn in (lib.gl_bn_forward_sums, lib.gl_bn_forward_apply, lib.gl_bn_backward_sums,
               lib.gl_bn_backward_apply):
        fn.restype = ctypes.c_int


library = KernelLibrary("batch_norm", _declare)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels walk x: ``layout`` (``CHANNELS_LAST`` or ``NCHW``),
    ``vec`` elements a load (8, or 1), ``n`` samples, ``c`` channels, ``hw``
    positions a sample, split into ``k`` chunks of ``chunk`` (rows in
    channels-last, elements in NCHW)."""
    layout: int
    vec: int
    n: int
    c: int
    hw: int
    k: int
    chunk: int

    @property
    def args(self) -> tuple:
        return (self.layout, self.vec, self.n, self.c, self.hw, self.k, self.chunk)


@functools.lru_cache(maxsize=1024)
def plan(layout: int, n: int, c: int, hw: int, aligned: bool, sms: int) -> Plan:
    """Chunks of H*W so that a pass covers ``sms`` SMs with ``WAVE_BLOCKS``
    blocks each (channels-last: a block per (sample, chunk, channel tile);
    NCHW: a warp per (sample, channel, chunk)), and no thread walks fewer
    than ``MIN_VECTORS`` vectors. 16-byte loads (8 elements) where the
    contiguous axis is a multiple of 8 and the pointers are ``aligned``."""
    inner = c if layout == CHANNELS_LAST else hw
    vec = 8 if aligned and inner % 8 == 0 else 1
    target = WAVE_BLOCKS * sms
    if layout == CHANNELS_LAST:
        ct = min(c // vec, THREADS)    # vector columns a block takes
        tiles = _cdiv(c // vec, ct)
        rows = THREADS // ct           # rows a block takes at a time
        k = min(_cdiv(target, n * tiles), _cdiv(hw, rows * MIN_VECTORS))
        chunk = _cdiv(hw, k)
    else:
        k = min(_cdiv(target * WARPS, n * c), _cdiv(hw, 32 * vec * MIN_VECTORS))
        chunk = _cdiv(_cdiv(hw, k), vec) * vec
    return Plan(layout, vec, n, c, hw, _cdiv(hw, chunk), chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def layout_of(x: torch.Tensor) -> Tuple[int, int]:
    """``(layout, hw)`` of a tensor the kernels take, or ValueError: ``[N, C]``
    contiguous, or 4-D channels-last dense (preferred where both hold) or
    contiguous."""
    if x.dim() == 2 and x.is_contiguous():
        return CHANNELS_LAST, 1
    if x.dim() == 4:
        if x.is_contiguous(memory_format=torch.channels_last):
            return CHANNELS_LAST, x.shape[2] * x.shape[3]
        if x.is_contiguous():
            return NCHW, x.shape[2] * x.shape[3]
    raise ValueError(f"the batch-norm kernels take [N, C] or dense channels-last or NCHW "
                     f"4-D tensors, got shape {tuple(x.shape)} strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class _Call:
    """One call's settings: batch statistics over ``groups`` (else the
    running ones), ``count`` elements a group over every rank, the fused
    ReLU, the output dtype."""
    groups: int
    batch_stats: bool
    count: int
    relu: bool
    out_dtype: torch.dtype


def _row_param(t: Optional[torch.Tensor], x: torch.Tensor, what: str):
    """(pointer, row stride) of a gamma/beta: ``[C]`` for every sample,
    ``[N, C]`` one row a sample, or None."""
    if t is None:
        return None, 0
    n, c = x.shape[0], x.shape[1]
    if (t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
            or t.shape not in ((c,), (n, c))):
        raise ValueError(f"{what} must be a contiguous float32 [{c}] or [{n}, {c}] tensor on "
                         f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr(), (c if t.dim() == 2 else 0)


def check_inputs(x: torch.Tensor, out_dtype: torch.dtype, groups: int) -> Tuple[int, int]:
    """Raise on what the kernels do not take; ``(layout, hw)``."""
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"the batch-norm kernels take float32 or bf16, got x {x.dtype} and "
                         f"output {out_dtype}")
    if x.shape[0] % groups:
        raise ValueError(f"batch {x.shape[0]} is not divisible into {groups} groups")
    if x.numel() == 0:
        raise ValueError("the batch-norm kernels take a non-empty x")
    return layout_of(x)


def _plan_for(x: torch.Tensor, layout: int, hw: int, *others) -> Plan:
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return plan(layout, x.shape[0], x.shape[1], hw, aligned, _sm_count(x.get_device()))


def launch_forward(x: torch.Tensor, gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                   running_mean: torch.Tensor, running_var: torch.Tensor, call: _Call,
                   update_stats: bool, save: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernels: ``(y, stats)``, stats the ``[2, groups, C]`` sums
    (batch statistics, all-reduced in a sharded step) or, with ``save``, a
    copy of the running ``[2, C]`` mean and var, for the backward."""
    global launches
    layout, hw = check_inputs(x, call.out_dtype, call.groups)
    if x.device.type != "cuda":
        raise ValueError(f"the batch-norm kernels run on CUDA tensors, got {x.device}")
    update = update_stats and call.batch_stats
    if update and call.groups != 1:
        raise ValueError("running stats advance only for one group")
    with span("kernel.batch_norm"):
        y = torch.empty_like(x, dtype=call.out_dtype)
        pl = _plan_for(x, layout, hw, y)
        lib = library.load()
        g_ptr, g_stride = _row_param(gamma, x, "gamma")
        b_ptr, b_stride = _row_param(beta, x, "beta")
        dx_code, dy_code = _DTYPE_CODES[x.dtype], _DTYPE_CODES[call.out_dtype]
        dev = x.get_device()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if call.batch_stats:
                c = x.shape[1]
                partial = torch.empty(pl.n * pl.k * 2 * c, device=x.device, dtype=torch.float32)
                sums = torch.empty(2, call.groups, c, device=x.device, dtype=torch.float32)
                library.check(lib.gl_bn_forward_sums(
                    x.data_ptr(), dx_code, *pl.args, call.groups, partial.data_ptr(),
                    sums.data_ptr(), stream), "batch-norm statistics kernel")
                stats = sums = sum_over_data(sums)
                rm = rv = None
            else:
                sums = None
                rm, rv = running_mean.data_ptr(), running_var.data_ptr()
                stats = torch.stack([running_mean, running_var]) if save else None
            out_rm = running_mean.data_ptr() if update else None
            out_rv = running_var.data_ptr() if update else None
            library.check(lib.gl_bn_forward_apply(
                x.data_ptr(), dx_code, y.data_ptr(), dy_code, *pl.args, call.groups,
                g_ptr, g_stride, b_ptr, b_stride, None if sums is None else sums.data_ptr(),
                float(call.count), rm, rv, out_rm, out_rv, MOMENTUM, 1.0 - MOMENTUM,
                EPSILON, int(call.relu), stream), "batch-norm apply kernel")
    launches += 1
    check_kernel_output("batch-norm kernel", y)
    return y, stats


def launch_backward(x: torch.Tensor, dy: torch.Tensor, gamma: Optional[torch.Tensor],
                    beta: Optional[torch.Tensor], stats: torch.Tensor, call: _Call
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels: ``(dx, rows)``, rows ``[2, N, C]`` the
    per-sample sums of dy' and dy' * xhat (the gradients of beta's and
    gamma's rows)."""
    global launches, backward_launches
    layout, hw = layout_of(x)
    if dy.dtype != call.out_dtype or dy.shape != x.shape:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match the output "
                         f"{call.out_dtype} {tuple(x.shape)}")
    if any(a != b for a, b, m in zip(dy.stride(), x.stride(), x.shape) if m > 1):
        dy = torch.empty_like(x, dtype=dy.dtype).copy_(dy)  # the kernels index x and dy alike
    dx = torch.empty_like(x)
    pl = _plan_for(x, layout, hw, dy, dx)
    lib = library.load()
    g_ptr, g_stride = _row_param(gamma, x, "gamma")
    b_ptr, b_stride = _row_param(beta, x, "beta")
    dx_code, dy_code = _DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype]
    n, c = x.shape[0], x.shape[1]
    if call.batch_stats:
        sums, rm, rv = stats.data_ptr(), None, None
    else:
        sums, rm, rv = None, stats[0].data_ptr(), stats[1].data_ptr()
    dev = x.get_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        f32 = dict(device=x.device, dtype=torch.float32)
        partial = torch.empty(pl.n * pl.k * 2 * c, **f32)
        rows = torch.empty(2, n, c, **f32)
        grad_sums = torch.empty(2, call.groups, c, **f32)
        library.check(lib.gl_bn_backward_sums(
            x.data_ptr(), dx_code, dy.data_ptr(), dy_code, *pl.args, call.groups, g_ptr,
            g_stride, b_ptr, b_stride, sums, float(call.count), rm, rv, EPSILON,
            int(call.relu), partial.data_ptr(), rows.data_ptr(), grad_sums.data_ptr(), stream),
            "batch-norm gradient reduction kernel")
        if call.batch_stats:
            grad_sums = sum_over_data(grad_sums)
        library.check(lib.gl_bn_backward_apply(
            x.data_ptr(), dx_code, dy.data_ptr(), dy_code, dx.data_ptr(), *pl.args,
            call.groups, g_ptr, g_stride, b_ptr, b_stride, sums, float(call.count), rm, rv,
            grad_sums.data_ptr() if call.batch_stats else None, EPSILON, int(call.relu),
            stream), "batch-norm gradient kernel")
    launches += 1
    backward_launches += 1
    check_kernel_output("batch-norm gradient kernel", dx)
    return dx, rows


class KernelBatchNorm(torch.autograd.Function):
    """``forward(x, gamma, beta, running_mean, running_var, call,
    update_stats)`` through the forward kernels; the backward is the
    backward kernels, giving x, gamma's and beta's gradients (``[C]``
    gamma/beta: summed over the samples). Saves x, the statistics and the
    gamma/beta rows, not y. Not differentiable twice."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, call: _Call,
                update_stats: bool):
        y, stats = launch_forward(x, gamma, beta, running_mean, running_var, call,
                                  update_stats, save=True)
        ctx.call = call
        ctx.save_for_backward(x, gamma, beta, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, rows = launch_backward(x, dy, gamma, beta, stats, ctx.call)

        def param_grad(t, g):
            return None if t is None else (g if t.dim() == 2 else g.sum(0))
        return dx, param_grad(gamma, rows[1]), param_grad(beta, rows[0]), None, None, None, None


def batch_norm(x: torch.Tensor, gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
               running_mean: torch.Tensor, running_var: torch.Tensor,
               out_dtype: torch.dtype, use_running_average: bool = False, groups: int = 1,
               update_stats: bool = True, relu: bool = False) -> torch.Tensor:
    """Batch norm of x through the CUDA kernels (see the module's note):
    ``gamma``/``beta`` are ``[C]`` (BN's scale and bias), ``[N, C]`` rows (a
    conditional BN's), or None; the running stats advance in place with
    batch statistics and ``update_stats``."""
    if use_running_average:
        groups, count = 1, 0
    else:
        count = global_batch(x.shape[0] // groups) * (x.numel() // (x.shape[0] * x.shape[1]))
    call = _Call(groups, not use_running_average, count, relu, out_dtype)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, gamma, beta)):
        return KernelBatchNorm.apply(x, gamma, beta, running_mean, running_var, call,
                                     update_stats)
    return launch_forward(x, gamma, beta, running_mean, running_var, call, update_stats)[0]


_plain = False   # inside plain_version()


@contextlib.contextmanager
def plain_version() -> Iterator[None]:
    """Inside it the batch norms run the plain version on every device: for
    tracing them (``train/export.py``)."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _kernel_device(x: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernels), False for CPU ones and inside
    ``plain_version()`` (the plain version); a trace outside it and other
    devices raise."""
    if x.device.type == "cpu" or _plain:
        return False
    if torch.compiler.is_compiling():
        raise ValueError("the batch-norm kernels cannot be traced: trace inside "
                         "norms.plain_version() to record the plain version")
    if x.device.type != "cuda":
        raise ValueError(f"batch norm runs on cpu or cuda, got {x.device}")
    return True


class BatchNorm(nn.Module):
    """``affine=False`` drops the scale and bias (the reference's
    ``use_scale=False, use_bias=False``, as conditional BN uses it)."""

    def __init__(self, features: int,
                 compute_dtype: Optional[torch.dtype] = None, affine: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(features))   # flax 'scale'
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: bool = False,
                groups: int = 1, update_stats: bool = True,
                relu: bool = False) -> torch.Tensor:
        """x: NCHW (or ``[N, C]``). Running stats advance only in training
        mode with ``update_stats`` and one group. ``relu``: the ReLU that
        follows, fused."""
        out_dtype = x.dtype if self.compute_dtype is None else self.compute_dtype
        weight, bias = (self.weight, self.bias) if self.affine else (None, None)
        norm = batch_norm if _kernel_device(x) else plain_batch_norm
        return norm(x, weight, bias, self.running_mean, self.running_var, out_dtype,
                    use_running_average, groups, update_stats, relu)


class ConditionalBatchNorm(nn.Module):
    """BN whose gamma and beta are per-class embeddings picked by label
    (reference ``norms.py:83-125``): BN without scale or bias in float32
    (``bn``, which owns the running stats), then ``gamma[label]`` (init 1)
    and ``beta[label]`` (init 0) per sample and channel, then the cast to
    ``compute_dtype``. ``groups`` and ``update_stats`` are ``BatchNorm``'s."""

    def __init__(self, num_classes: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.bn = BatchNorm(features, compute_dtype=torch.float32, affine=False)
        self.gamma = Embedding(num_classes, features, init="ones")
        self.beta = Embedding(num_classes, features, init="zeros")

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                use_running_average: bool = False, groups: int = 1,
                update_stats: bool = True, relu: bool = False) -> torch.Tensor:
        """x NCHW (or ``[N, C]``), labels ``[N]``. ``relu``: the ReLU that
        follows, fused."""
        out_dtype = x.dtype if self.compute_dtype is None else self.compute_dtype
        norm = batch_norm if _kernel_device(x) else plain_batch_norm
        return norm(x, self.gamma(labels), self.beta(labels), self.bn.running_mean,
                    self.bn.running_var, out_dtype, use_running_average, groups, update_stats,
                    relu)


def pixel_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """PGGAN PixelNorm: each pixel's feature vector to unit RMS, in float32,
    cast back. Normalizes dim 1: the channels of NCHW, the features of
    ``[N, F]`` (reference ``norms.py:155-161`` normalizes NHWC's last axis)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + epsilon)
    return y.to(x.dtype)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     epsilon: float = 1e-8) -> torch.Tensor:
    """PGGAN minibatch stddev (reference ``norms.py:164-182``): the batch
    splits as ``reshape(g, n // g, ...)``, so sample i is in group i % (n//g);
    per group the float32 stddev over its g members, averaged over C, H, W,
    is appended as one constant channel, last. x: NCHW.

    In a sharded step n is the global batch, and a group's members lie on
    several ranks: each rank adds its contiguous rows into the ``[n//g,
    ...]`` group slots, the slot sums are all-reduced, and the centred
    squares take a second pass, as the reference computes the mean first
    and the squares after. Outside one the rank holds every row, and the
    slot sums are the group sums. Its mean over C, H, W needs the whole
    height: under spatial partitioning PGGAN's D gathers the height before
    it (``models/pggan.py``), so ``x`` is never an 'sp' shard."""
    n_loc, c, h, w = x.shape
    n = global_batch(n_loc)
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"batch {n} not divisible by group size {g}")
    m = n // g
    # this rank's rows fill slots first, first + 1, ... (mod m) in turn: pad
    # them to whole rounds of m and add the rounds; a fixed order everywhere
    mesh = active()
    first = 0 if mesh is None else mesh.coord("data") * n_loc % m
    rounds = -(-(first + n_loc) // m)

    def slot_sums(t: torch.Tensor) -> torch.Tensor:
        padded = F.pad(t, (0, 0, 0, 0, 0, 0, first, rounds * m - first - n_loc))
        return sum_over_data(padded.reshape(rounds, m, *t.shape[1:]).sum(dim=0))

    def per_row(t: torch.Tensor) -> torch.Tensor:  # slot values back to the rows
        return t.repeat(rounds, 1, 1, 1)[first:first + n_loc]

    xf = x.float()
    mean = slot_sums(xf) / g
    var = slot_sums((xf - per_row(mean)) ** 2) / g
    avg = torch.sqrt(var + epsilon).mean(dim=(1, 2, 3), keepdim=True)  # [m, 1, 1, 1]
    feat = per_row(avg).expand(n_loc, 1, h, w)
    return torch.cat([x, feat.to(x.dtype)], dim=1)
