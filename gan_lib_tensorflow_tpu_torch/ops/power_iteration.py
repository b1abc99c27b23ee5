"""Batched spectral-norm power iteration: the wrapper of the hand-written CUDA
kernel ``csrc/power_iteration.cu``, its host-side work plan and its plain
PyTorch version.

Port of ``gan_lib_tensorflow_tpu/ops/pallas_kernels.py:batched_power_iteration``.
One call runs one power-iteration step for every spectral-norm weight of a
discriminator. Weights are taken ragged in the port's layout (``[out, ...]``,
read as the row-major ``[K=out, M=fan_in]`` matrix ``W^T``); ``u`` buffers
hold ``K`` floats each.

``plan_power_iteration`` splits the work from the shapes alone, for one of
the kernel's two paths. When every weight's slab fits in shared memory,
the CTAs run in thread-block clusters of ``CLUSTER``: a large weight gets a
whole cluster, each CTA a slab of its columns; small weights take one CTA
each, packed into shared clusters. When a weight's slab does not fit,
every weight streams: each is cut into tiles of all its rows by
``tile_cols(K)`` columns, and the tiles are dealt, in order, to one CTA per
SM, each about the same cost; a CTA's run of tiles within one weight is a
work item (``Item``), and each weight's items are its parts, added in part
order by the CTA that finishes last. ``PowerIterationTable`` writes that
plan, with the pointers, into the device tables the kernel reads, and holds
the items' workspace and the weights' counters.

On CPU tensors the wrapper runs the plain version (a loop over
``ops/sn.py:power_iteration``). On CUDA tensors it launches the kernel, or
raises: there is no fallback. The kernel is built at first use by
``ops/cuda_lib.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.debug_nans import check_kernel_output
from ..utils.profiler import span
from .cuda_lib import KernelLibrary
from .sn import power_iteration

# Launches of the CUDA kernel in this process (the plain version does not
# count). Callers reset it to 0 to count the launches of one run.
launches = 0

CLUSTER = 8             # CTAs per cluster, kCluster in csrc/power_iteration.cu
WARPS = 8               # warps per CTA, kThreads / 32 there
CHUNK = 256             # columns per chunk of the v pass, kChunk there
SMEM_LIMIT = 232_448    # bytes of shared memory one CTA may use on sm_90 (227 KB)
SOLO_BYTES = 64 * 1024  # a weight of at most this many bytes takes one CTA
CHUNK_FLOATS = 4096     # floats of one chunk slot of a streaming CTA (16 KB), kChunkFloats there
MAX_SLOTS = 13          # chunk slots of a streaming CTA at most, kMaxSlots there
# a streaming CTA's shared memory besides its slots, u and its partial sums
# (the warps' v partials, the tile's v, scratch and the ticket), in floats
STREAM_SMALL_FLOATS = WARPS * 32 + 32 + 16 + 4
# streaming CTAs of a launch when the card is not asked: an H100's 132 SMs,
# one CTA each (what its shared memory allows)
DEFAULT_MAX_CTAS = 132
# what a tile and a work item cost a streaming CTA beyond their bytes (a
# tile's waits, passes and barriers; an item's u, partial sums, ticket and,
# for a weight of one part, its last sums), in bytes' worth of time, when
# the tiles are dealt
TILE_COST_BYTES = 8192
ITEM_COST_BYTES = 65536
IDLE, SOLO, SPLIT, STREAM = 0, 1, 2, 3  # kinds of CTA, as the kernel names them
TABLE_COLS = 10
ITEM_COLS = 12


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gl_power_iteration.argtypes = [p, i, p, i, p, p, i, p, p, p, i, p]
    lib.gl_power_iteration.restype = i
    lib.gl_power_iteration_max_ctas.argtypes = [i]
    lib.gl_power_iteration_max_ctas.restype = i
    lib.gl_power_iteration_empty.argtypes = [i, i, i, p]
    lib.gl_power_iteration_empty.restype = i


library = KernelLibrary("power_iteration", _declare)


class Cta(NamedTuple):
    """One CTA's work. A slab CTA: columns ``[col0, col0 + width)`` of
    weight ``weight``'s ``W^T``. A streaming CTA (``kind == STREAM``,
    ``weight`` -1): the plan's items ``[col0, col0 + width)``. An idle CTA:
    ``weight`` -1, nothing."""
    weight: int
    col0: int
    width: int
    kind: int
    smem_bytes: int  # shared memory this CTA's layout needs


class Item(NamedTuple):
    """Columns ``[col0, col0 + width)`` of streamed weight ``weight``, all
    its rows, for one streaming CTA: part ``part`` of ``parts`` of that
    weight, whose partial sums go to workspace slot ``part`` of the weight."""
    weight: int
    col0: int
    width: int
    part: int
    parts: int


class Plan(NamedTuple):
    ctas: List[Cta]    # len is a multiple of CLUSTER; rank = position % CLUSTER
    smem_bytes: int    # the launch's dynamic shared memory: the largest CTA's
    items: List[Item]  # the streaming CTAs' work, each CTA's items consecutive
    slots: int         # chunk slots of each streaming CTA (0 without one)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(k: int, width: int, nranks: int) -> int:
    """Shared memory of one slab CTA of a weight split over ``nranks`` CTAs,
    as ``smem_floats`` in the kernel lays it out: the partials peers push
    (one |v|^2 per rank and K sums of W^T v per rank), the slab, u, the v
    slice, the row-group partials of the v pass and block-sum scratch."""
    peer = CLUSTER + 4 * _cdiv(nranks * k, 4)
    return 4 * (peer + k * width + k + width + WARPS * CHUNK + WARPS + 1)


def tile_cols(k: int) -> int:
    """Columns of a streamed tile of ``k`` rows: 32 up to K = 1024, so that
    each row of W^T is read 128 bytes at a time, then halved as K doubles
    (a tile stays within 8 chunks)."""
    if k > 4096:
        raise ValueError(f"a streamed weight of {k} rows needs more shared memory than a "
                         "streaming CTA has (its tiles take at most 4096 rows)")
    return 32 if k <= 1024 else 16 if k <= 2048 else 8


def tile_chunks(k: int) -> int:
    """Chunk slots one streamed tile of ``k`` rows fills."""
    return _cdiv(k, CHUNK_FLOATS // tile_cols(k))


def stream_slots(kmax: int) -> int:
    """Chunk slots of a streaming CTA whose weights have at most ``kmax``
    rows: as many as fit beside u and the partial sums, up to MAX_SLOTS."""
    return min(MAX_SLOTS, (SMEM_LIMIT // 4 - STREAM_SMALL_FLOATS - 2 * kmax) // CHUNK_FLOATS)


def stream_smem_bytes(kmax: int) -> int:
    """Shared memory of a streaming CTA whose weights have at most ``kmax``
    rows: its slots, then the small part, u and the partial sums."""
    return 4 * (stream_slots(kmax) * CHUNK_FLOATS + STREAM_SMALL_FLOATS + 2 * kmax)


def ws_stride(k: int) -> int:
    """Floats of one part's workspace slot: K partial sums padded to a
    multiple of 4, then |v|^2 (``ws_stride`` in the kernel)."""
    return 4 * _cdiv(k, 4) + 4


def _deal(dims: Sequence[Tuple[int, int]], streamed: List[int], n_ctas: int
          ) -> Tuple[List[Item], List[Tuple[int, int]]]:
    """The tiles of the streamed weights, in order, dealt to ``n_ctas``
    streaming CTAs by cost (a tile's bytes, ``TILE_COST_BYTES``, and
    ``ITEM_COST_BYTES`` for a weight's first tile): a tile goes to the CTA
    whose equal share of the whole cost holds the tile's middle. Returns
    the items and each CTA's ``(first item, count)``."""
    tiles = []  # (weight, col0, width, cost)
    for i in streamed:
        m, k = dims[i]
        tc = tile_cols(k)
        tiles += [(i, c, min(tc, m - c), 4 * k * min(tc, m - c) + TILE_COST_BYTES
                   + (ITEM_COST_BYTES if c == 0 else 0)) for c in range(0, m, tc)]
    share = sum(t[3] for t in tiles) / n_ctas
    runs: List[List] = []  # [cta, weight, col0, width]
    done = 0
    for i, c, w, b in tiles:
        cta = min(n_ctas - 1, int((done + b / 2) // share))
        done += b
        if runs and runs[-1][0] == cta and runs[-1][1] == i:
            runs[-1][3] += w
        else:
            runs.append([cta, i, c, w])
    parts: Dict[int, int] = {}
    for _, i, _, _ in runs:
        parts[i] = parts.get(i, 0) + 1
    items, seen = [], {}
    ranges = [(0, 0)] * n_ctas
    for cta, i, c, w in runs:
        part = seen.get(i, 0)
        seen[i] = part + 1
        first, count = ranges[cta]
        ranges[cta] = (first if count else len(items), count + 1)
        items.append(Item(i, c, w, part, parts[i]))
    return items, ranges


def _splits(m: int, k: int) -> bool:
    """Whether a weight takes a whole cluster in path 1."""
    return 4 * m * k > SOLO_BYTES and m >= 4 * CLUSTER


def _split_width(m: int) -> int:
    return 4 * _cdiv(_cdiv(m, CLUSTER), 4)


def slab_fits(m: int, k: int) -> bool:
    """Whether a weight's slab fits in its CTA's shared memory in path 1
    (split over a cluster, or whole in one CTA)."""
    if _splits(m, k):
        return smem_bytes(k, _split_width(m), CLUSTER) <= SMEM_LIMIT
    return smem_bytes(k, m, 1) <= SMEM_LIMIT


def plan_power_iteration(dims: Sequence[Tuple[int, int]],
                         max_ctas: int = DEFAULT_MAX_CTAS) -> Plan:
    """Split the weights ``dims`` (``(M, K)`` = ``(fan_in, out)`` each) over
    CTAs.

    When every weight's slab fits in shared memory (path 1), the CTAs run in
    clusters of ``CLUSTER``. A weight larger than ``SOLO_BYTES`` (with at
    least 4 columns per rank) takes a whole cluster: rank c owns ``width =
    ceil(M / CLUSTER)`` columns rounded up to 4, so 16-byte copies stay
    aligned. Any other weight takes one CTA; those CTAs are packed into
    clusters of their own, idle CTAs filling the last.

    When a weight's CTA would need more than ``SMEM_LIMIT`` bytes, every
    weight of the launch streams (path 2): ``max_ctas`` CTAs without
    clusters, as many as the card holds at once, share the tiles of all the
    weights (``_deal``).
    """
    split, solo = [], []
    for i, (m, k) in enumerate(dims):
        if _splits(m, k):
            width = _split_width(m)
            for c in range(CLUSTER):
                col0 = min(c * width, m)
                wd = min(width, m - col0)
                split.append(Cta(i, col0, wd, SPLIT, smem_bytes(k, wd, CLUSTER)))
        else:
            solo.append(Cta(i, 0, m, SOLO, smem_bytes(k, m, 1)))
    idle = Cta(-1, 0, 0, IDLE, 0)
    if all(slab_fits(m, k) for m, k in dims):
        ctas = split + solo + [idle] * (-len(solo) % CLUSTER)
        return Plan(ctas, max(c.smem_bytes for c in ctas), [], 0)
    kmax = max(k for _, k in dims)
    slots = stream_slots(kmax)
    if slots <= tile_chunks(kmax):
        raise ValueError(f"a streamed weight of {kmax} rows needs more shared memory "
                         f"than {SMEM_LIMIT} bytes")
    items, ranges = _deal(dims, list(range(len(dims))), max_ctas)
    need = stream_smem_bytes(kmax)
    ctas = [Cta(-1, first, count, STREAM, need) if count else idle for first, count in ranges]
    return Plan(ctas, need, items, slots)


def _dims(weights: Sequence[torch.Tensor]) -> Tuple[List[int], List[int]]:
    ks = [int(w.shape[0]) for w in weights]
    return [w.numel() // k for w, k in zip(weights, ks)], ks


class PowerIterationTable:
    """The plan and its device tables for a fixed list of weights: a row per
    CTA ``(w_ptr, u_ptr, M, K, v_offset, u_offset, col0, width, kind,
    weight)`` and a row per item ``(w_ptr, u_ptr, M, K, v_offset, u_offset,
    col0, width, weight, part, parts, ws_base)``, with the items' workspace
    (``K + 1`` floats per part) and one counter per weight. Owned by one
    discriminator and rebuilt, after the full input checks, only when a
    pointer or shape changes: the optimizer updates parameters in place, so
    in training it is built once and every later call costs one comparison
    of pointers and shapes. One launch of a table runs at a time (its
    workspace and counters are shared)."""

    def __init__(self):
        self._ptrs: Optional[List[int]] = None
        self._shapes: Optional[List[torch.Size]] = None
        self.table: Optional[torch.Tensor] = None
        self.items: Optional[torch.Tensor] = None
        self.workspace: Optional[torch.Tensor] = None
        self.counters: Optional[torch.Tensor] = None
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
        dev = weights[0].device
        self.plan = plan_power_iteration(list(zip(self.ms, self.ks)),
                                         max_ctas(dev) if dev.type == "cuda" else DEFAULT_MAX_CTAS)
        v_offs, u_offs = [0], [0]
        for m, k in zip(self.ms, self.ks):
            v_offs.append(v_offs[-1] + m)
            u_offs.append(u_offs[-1] + k)

        def head(i):
            return [weights[i].data_ptr(), us[i].data_ptr(), self.ms[i], self.ks[i],
                    v_offs[i], u_offs[i]]

        rows = []
        for c in self.plan.ctas:
            if c.kind == STREAM:
                rows.append([0] * 6 + [c.col0, c.width, c.kind, self.plan.slots])
            elif c.kind == IDLE:
                rows.append([0] * TABLE_COLS)
            else:
                rows.append(head(c.weight) + [c.col0, c.width, c.kind, c.weight])
        ws_base, n_ws = {}, 0
        for it in self.plan.items:
            if it.weight not in ws_base:
                ws_base[it.weight] = n_ws
                n_ws += it.parts * ws_stride(self.ks[it.weight])
        items = [head(it.weight) + [it.col0, it.width, it.weight, it.part, it.parts,
                                    ws_base[it.weight]] for it in self.plan.items]
        self.table = torch.tensor(rows, dtype=torch.int64).to(dev)
        self.items = torch.tensor(items or [[0] * ITEM_COLS], dtype=torch.int64).to(dev)
        self.workspace = torch.empty(max(n_ws, 1), dtype=torch.float32, device=dev)
        self.counters = torch.zeros(len(weights), dtype=torch.int32, device=dev)
        self.out_sizes = [len(weights), u_offs[-1], v_offs[-1]]


_max_ctas: Dict[int, int] = {}


def max_ctas(device: torch.device) -> int:
    """The streaming CTAs (path 2) that ``device`` holds at once at the most
    shared memory a CTA may take: one per SM (asked of the card once per
    device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _max_ctas:
        with torch.cuda.device(index):
            n = library.load().gl_power_iteration_max_ctas(SMEM_LIMIT)
        if n < 1:
            raise RuntimeError(f"the card holds {n} CTAs of the power-iteration kernel at once "
                               f"({library.load().gl_error_string(-n).decode() if n < 0 else ''})")
        _max_ctas[index] = n
    return _max_ctas[index]


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
    plan = t.plan
    # path 1: clustered, every slab in shared memory; path 2: streamed
    with span("kernel.power_iteration", path=2 if plan.items else 1, weights=len(weights)):
        out = torch.empty(sum(t.out_sizes), device=dev, dtype=torch.float32)
        sigma, u_out, v_out = out.split_with_sizes(t.out_sizes)
        lib = library.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.gl_power_iteration(
                t.table.data_ptr(), len(plan.ctas), t.items.data_ptr(), int(bool(plan.items)),
                t.workspace.data_ptr(), t.counters.data_ptr(), plan.smem_bytes,
                sigma.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), int(write_u), stream)
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
        len(plan.ctas), plan.smem_bytes, int(not plan.items),
        torch.cuda.current_stream().cuda_stream)
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
