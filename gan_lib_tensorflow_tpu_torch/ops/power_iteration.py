"""Batched spectral-norm power iteration: the wrapper of the hand-written CUDA
kernel ``csrc/power_iteration.cu``, its host-side work plan and its plain
PyTorch version.

Port of ``gan_lib_tensorflow_tpu/ops/pallas_kernels.py:batched_power_iteration``.
One call runs one power-iteration step for every spectral-norm weight of a
discriminator. Weights are taken ragged in the port's layout (``[out, ...]``,
read as the row-major ``[K=out, M=fan_in]`` matrix ``W^T``); ``u`` buffers
hold ``K`` floats each.

The kernel runs in thread-block clusters. ``plan_power_iteration`` splits
the work from the shapes alone: a large weight gets a whole cluster, each CTA
a slab of its columns in shared memory (or streamed from device memory when
the slab does not fit); small weights take one CTA each, packed into shared
clusters. ``PowerIterationTable`` writes that plan, with the pointers, into
the device table the kernel reads.

On CPU tensors the wrapper runs the plain version (a loop over
``ops/sn.py:power_iteration``). On CUDA tensors it launches the kernel, or
raises: there is no fallback. The kernel is built at first use by
``ops/cuda_lib.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.debug_nans import check_kernel_output
from .cuda_lib import KernelLibrary
from .sn import power_iteration

# Launches of the CUDA kernel in this process (the plain version does not
# count). Callers reset it to 0 to count the launches of one run.
launches = 0

CLUSTER = 8             # CTAs per cluster, kCluster in csrc/power_iteration.cu
WARPS = 8               # warps per CTA, kThreads / 32 in csrc/power_iteration.cu
CHUNK = 256             # columns per chunk of the v pass, kChunk there
SMEM_LIMIT = 232_448    # bytes of shared memory one CTA may use on sm_90 (227 KB)
SOLO_BYTES = 64 * 1024  # a weight of at most this many bytes takes one CTA
IDLE, SOLO, SPLIT = 0, 1, 2  # kinds of CTA, as the kernel names them
TABLE_COLS = 11


def _declare(lib: ctypes.CDLL) -> None:
    lib.gl_power_iteration.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.gl_power_iteration.restype = ctypes.c_int
    lib.gl_power_iteration_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gl_power_iteration_empty.restype = ctypes.c_int


library = KernelLibrary("power_iteration", _declare)


class Cta(NamedTuple):
    """One CTA's work: columns ``[col0, col0 + width)`` of weight ``weight``'s
    ``W^T`` (``weight`` is -1 for an idle CTA)."""
    weight: int
    col0: int
    width: int
    kind: int
    stream: bool     # the slab is read from device memory, not shared memory
    smem_bytes: int  # shared memory this CTA's layout needs


class Plan(NamedTuple):
    ctas: List[Cta]   # len is a multiple of CLUSTER; rank = position % CLUSTER
    smem_bytes: int   # the launch's dynamic shared memory: the largest CTA's


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(k: int, width: int, nranks: int, stream: bool) -> int:
    """Shared memory of one CTA of a weight split over ``nranks`` CTAs, as
    ``smem_floats`` in the kernel lays it out: the partials peers push (one
    |v|^2 per rank and K sums of W^T v per rank), the slab (absent when
    streamed), u, the v slice, the row-group partials of the v pass and
    block-sum scratch."""
    peer = CLUSTER + 4 * _cdiv(nranks * k, 4)
    return 4 * (peer + (0 if stream else k * width) + k + width
                + WARPS * CHUNK + WARPS + 1)


def plan_power_iteration(dims: Sequence[Tuple[int, int]]) -> Plan:
    """Split the weights ``dims`` (``(M, K)`` = ``(fan_in, out)`` each) over
    CTAs in clusters of ``CLUSTER``.

    A weight larger than ``SOLO_BYTES`` (with at least 4 columns per rank)
    takes a whole cluster: rank c owns ``width = ceil(M / CLUSTER)`` columns
    rounded up to 4, so 16-byte copies stay aligned. Any other weight takes
    one CTA; those CTAs are packed into clusters of their own, idle CTAs
    filling the last. A slab whose CTA would need more than ``SMEM_LIMIT``
    bytes is streamed from device memory instead (W read twice).
    """
    split, solo = [], []
    for i, (m, k) in enumerate(dims):
        if 4 * m * k > SOLO_BYTES and m >= 4 * CLUSTER:
            width = 4 * _cdiv(_cdiv(m, CLUSTER), 4)
            stream = smem_bytes(k, width, CLUSTER, False) > SMEM_LIMIT
            for c in range(CLUSTER):
                col0 = min(c * width, m)
                wd = min(width, m - col0)
                split.append(Cta(i, col0, wd, SPLIT, stream, smem_bytes(k, wd, CLUSTER, stream)))
        else:
            stream = smem_bytes(k, m, 1, False) > SMEM_LIMIT
            solo.append(Cta(i, 0, m, SOLO, stream, smem_bytes(k, m, 1, stream)))
    idle = Cta(-1, 0, 0, IDLE, False, 0)
    ctas = split + solo + [idle] * (-len(solo) % CLUSTER)
    need = max(c.smem_bytes for c in ctas)
    if need > SMEM_LIMIT:
        raise ValueError(f"a CTA needs {need} bytes of shared memory even with its slab "
                         f"streamed, more than {SMEM_LIMIT}")
    return Plan(ctas, need)


def _dims(weights: Sequence[torch.Tensor]) -> Tuple[List[int], List[int]]:
    ks = [int(w.shape[0]) for w in weights]
    return [w.numel() // k for w, k in zip(weights, ks)], ks


class PowerIterationTable:
    """The plan and its device table of CTA rows ``(w_ptr, u_ptr, M, K,
    v_offset, u_offset, col0, width, kind, weight, stream)`` for a fixed list
    of weights. Owned by one discriminator and rebuilt, after the full input
    checks, only when a pointer or shape changes: the optimizer updates
    parameters in place, so in training it is built once and every later call
    costs one comparison of pointers and shapes."""

    def __init__(self):
        self._ptrs: Optional[List[int]] = None
        self._shapes: Optional[List[torch.Size]] = None
        self.table: Optional[torch.Tensor] = None
        self.plan: Optional[Plan] = None
        self.ms: List[int] = []
        self.ks: List[int] = []
        self.out_sizes: List[int] = []  # sigma, u', v in one output buffer

    def get(self, weights: Sequence[torch.Tensor],
            us: Sequence[torch.Tensor]) -> "PowerIterationTable":
        ptrs = list(map(torch.Tensor.data_ptr, (*weights, *us)))
        shapes = [w.shape for w in weights]
        if ptrs != self._ptrs or shapes != self._shapes:
            _check(weights, us)
            self._build(weights, us)
            self._ptrs, self._shapes = ptrs, shapes
        return self

    def _build(self, weights, us) -> None:
        self.ms, self.ks = _dims(weights)
        self.plan = plan_power_iteration(list(zip(self.ms, self.ks)))
        v_offs, u_offs = [0], [0]
        for m, k in zip(self.ms, self.ks):
            v_offs.append(v_offs[-1] + m)
            u_offs.append(u_offs[-1] + k)
        rows = []
        for c in self.plan.ctas:
            if c.kind == IDLE:
                rows.append([0] * TABLE_COLS)
                continue
            i = c.weight
            rows.append([weights[i].data_ptr(), us[i].data_ptr(), self.ms[i], self.ks[i],
                         v_offs[i], u_offs[i], c.col0, c.width, c.kind, i, int(c.stream)])
        self.table = torch.tensor(rows, dtype=torch.int64).to(weights[0].device)
        self.out_sizes = [len(weights), u_offs[-1], v_offs[-1]]


def _check(weights: Sequence[torch.Tensor], us: Sequence[torch.Tensor]) -> None:
    if not weights or len(weights) != len(us):
        raise ValueError(f"need one u per weight, got {len(weights)} weights "
                         f"and {len(us)} u buffers")
    dev = weights[0].device
    for i, (w, u) in enumerate(zip(weights, us)):
        for name, t in (("weight", w), ("u", u)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    f"{name} {i}: the kernel takes contiguous float32 tensors "
                    f"on {dev}, got {t.dtype} on {t.device} "
                    f"(contiguous={t.is_contiguous()})")
        if w.dim() < 2 or u.numel() != w.shape[0]:
            raise ValueError(f"weight {i} of shape {tuple(w.shape)} needs a u "
                             f"of {w.shape[0]} values, got {tuple(u.shape)}")
        if w.numel() >= 2**31:
            raise ValueError(f"weight {i} has {w.numel()} values; the kernel "
                             "indexes with 32-bit ints")


def launch(weights: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
           write_u: bool = False, table: Optional[PowerIterationTable] = None):
    """Launch the CUDA kernel once. Returns ``(sigma [N], u_new flat [sum K],
    v flat [sum M])``; when ``write_u`` the kernel also writes u' into ``us``."""
    global launches
    t = (table if table is not None else PowerIterationTable()).get(weights, us)
    dev = weights[0].device
    if dev.type != "cuda":
        raise ValueError(f"the power-iteration kernel runs on CUDA tensors, got {dev}")
    out = torch.empty(sum(t.out_sizes), device=dev, dtype=torch.float32)
    sigma, u_out, v_out = out.split_with_sizes(t.out_sizes)
    lib = library.load()
    plan = t.plan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gl_power_iteration(
            t.table.data_ptr(), len(plan.ctas), plan.smem_bytes, sigma.data_ptr(),
            u_out.data_ptr(), v_out.data_ptr(), int(write_u), stream)
    library.check(err, "power-iteration kernel")
    launches += 1
    check_kernel_output("power-iteration kernel", sigma, u_out, v_out)
    return sigma, u_out, v_out


def launch_empty(table: PowerIterationTable) -> None:
    """Launch an empty kernel with ``table``'s grid, cluster and shared
    memory on the current device and stream: what launching alone costs.
    Not counted in ``launches``."""
    plan = table.plan
    err = library.load().gl_power_iteration_empty(
        len(plan.ctas), plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    library.check(err, "empty clustered kernel")


class _KernelSigma(torch.autograd.Function):
    """sigma of each weight from the kernel; backward d(sigma_i)/dW_i =
    u'_i v_i^T (u and v are constants, as in the reference)."""

    @staticmethod
    def forward(ctx, us, write_u, table, *weights):
        sigma, u_out, v_out = launch(weights, us, write_u, table)
        ctx.save_for_backward(u_out, v_out)
        ctx.ms, ctx.ks = _dims(weights)
        ctx.shapes = [w.shape for w in weights]
        return sigma

    @staticmethod
    def backward(ctx, grad_sigma):
        u_out, v_out = ctx.saved_tensors
        grads = [(g * torch.outer(u, v)).view(shape) for g, u, v, shape in zip(
            grad_sigma, u_out.split(ctx.ks), v_out.split(ctx.ms), ctx.shapes)]
        return (None, None, None, *grads)


def plain_power_iteration(weights: Sequence[torch.Tensor],
                          us: Sequence[torch.Tensor]):
    """The plain version: ``(sigma [N], [u_new [K]], [v [M]])``, sigma
    differentiable in the weights."""
    sig, u_new, v = [], [], []
    for w, u in zip(weights, us):
        s, un, vv = power_iteration(w.reshape(w.shape[0], -1).T, u.reshape(1, -1))
        sig.append(s)
        u_new.append(un.reshape(-1))
        v.append(vv.reshape(-1))
    return torch.stack(sig), u_new, v


def batched_power_iteration(weights: Sequence[torch.Tensor],
                            us: Sequence[torch.Tensor], update: bool = False,
                            table: Optional[PowerIterationTable] = None
                            ) -> torch.Tensor:
    """sigma ``[N]`` of every weight (differentiable in the weights); the
    ``u`` buffers advance to u' in place only when ``update``."""
    dev = weights[0].device
    if dev.type == "cpu":
        sigma, u_new, _ = plain_power_iteration(weights, us)
        if update:
            with torch.no_grad():
                for u, un in zip(us, u_new):
                    u.copy_(un.reshape(u.shape))
        return sigma
    if dev.type != "cuda":
        raise ValueError(f"batched_power_iteration runs on cpu or cuda, got {dev}")
    return _KernelSigma.apply(list(us), bool(update), table, *weights)
