"""Sharding rules (port of ``gan_lib_tensorflow_tpu/parallel/sharding.py:
11-101``): the rank's rows of a global batch and of an image's height, the
tensor-parallel spec of a network's parameters, and the collectives the
sharded step needs.

The reference leaves the collectives to GSPMD. Here they are explicit:

- 'data': each rank holds ``B / d`` contiguous rows of the global batch.
  Batch norm and minibatch stddev sum their statistics over the 'data'
  group with an autograd-aware ``all_reduce`` (its backward is the
  all-reduce of the gradient, and it differentiates again for the
  gradient penalty), and the step averages its gradients and metrics there.
- 'model': a wide parameter (``tensor_parallel_spec``) is split along its
  dim 0, the output features, which is the last dimension of the JAX
  package's kernel or embedding (``convert.py``). The rank owns one shard
  (``ModelShards.masters``), and the optimizer and EMA hold only that
  shard; the network keeps one full-size copy of the weight, gathered over
  'model' in place after each update, so its storage (and the power
  iteration's table of pointers) stays the same for the whole run.
- 'sp' (spatial partitioning, PGGAN): a height of H rows is sharded when
  H >= 4 * sp (``height_is_sharded``); each rank of an 'sp' line then holds
  H / sp contiguous rows, every shard starting on an even row. Below that a
  level is whole on every rank of the line. Inside ``height_shards()`` the
  convolutions of the port (``ops/layers.py``, ``ops/fused.py``,
  ``ops/s2d.py``) take their zero padding rows from the 'sp' neighbours
  instead (``halo_pad``: an exchange of edge rows, zeros at the image edge).
  ``gather_height`` makes a sharded tensor whole, ``split_height`` takes the
  rank's rows of a whole one, ``sum_over_sp`` sums over the line.

  The gradient rule: every collective here is differentiable and its
  backward is its exact adjoint (the halo exchange's is the exchange back,
  the gather's the reduce-scatter, the sum's the sum), and so are those
  backwards, for the penalty's double backward. Autograd then computes on
  each rank the gradient of the sum over the ranks of what each rank
  computes. A loss that every rank of an 'sp' line computes whole counts sp
  times: the step averages the parameter gradients over all d * sp ranks
  (the 'sp' sum and the 'data' mean in one all-reduce), and the penalty
  divides its inner critic sum by sp, whose gradient it reads as a value.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from .mesh import Mesh, active

DEFAULT_MIN_FEATURES = 256
# rows an 'sp' shard holds at least: a height H is sharded when H >= 4 * sp
MIN_SHARD_ROWS = 4


def data_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n`` (all of them without a
    mesh); ``n`` must divide over the 'data' axis."""
    d = 1 if mesh is None else mesh.size("data")
    if n % d:
        raise ValueError(f"batch_size {n} not divisible by data-mesh size {d}")
    k, i = n // d, (0 if mesh is None else mesh.coord("data"))
    return slice(i * k, (i + 1) * k)


def height_is_sharded(h: int, n: int) -> bool:
    """Whether a height of ``h`` rows is split over an 'sp' axis of ``n``
    ranks: when each shard holds ``MIN_SHARD_ROWS`` rows or more, an even
    number that ``n`` divides out of ``h``."""
    if n <= 1 or h < MIN_SHARD_ROWS * n:
        return False
    if h % n or (h // n) % 2:
        raise ValueError(f"a height of {h} rows does not split into {n} shards of an "
                         "even number of rows")
    return True


def height_rows(h: int, mesh: Optional[Mesh], axis: str = "sp") -> slice:
    """This rank's rows of a height of ``h`` (all of them unless the height
    is sharded over ``axis``)."""
    n = 1 if mesh is None else mesh.size(axis)
    if not height_is_sharded(h, n):
        return slice(0, h)
    k, j = h // n, mesh.coord(axis)
    return slice(j * k, (j + 1) * k)


def shard_batch(batch: Any, mesh: Optional[Mesh], leading_stack_dims: int = 0,
                spatial_axis: Optional[str] = None) -> Any:
    """This rank's rows of a batch (a tensor, an array, or a dict or list of
    them): dim ``leading_stack_dims`` is the batch; the leading microbatch
    stack dims before it stay whole. ``spatial_axis``: the image leaves
    (NHWC, 4 dims after the stack dims) also keep only the rank's height
    rows over that axis (``height_rows``)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, leading_stack_dims, spatial_axis)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, leading_stack_dims, spatial_axis)
                           for v in batch)
    rows = data_rows(batch.shape[leading_stack_dims], mesh)
    index = (slice(None),) * leading_stack_dims + (rows,)
    if spatial_axis is not None and batch.ndim >= leading_stack_dims + 4:
        index += (height_rows(batch.shape[leading_stack_dims + 1], mesh, spatial_axis),)
    return batch[index]


def global_batch(n_local: int) -> int:
    """The global batch of a rank's ``n_local`` rows in the enclosing
    ``sharded_step``."""
    mesh = active()
    return n_local * (1 if mesh is None else mesh.size("data"))


def local_rows(x: torch.Tensor, dim: int = 0, parts: int = 1) -> torch.Tensor:
    """The rows of the enclosing ``sharded_step``'s rank of a global draw
    ``x`` (the whole of ``x`` outside one). ``parts`` > 1: dim ``dim`` is
    that many global batches one after the other (a D pass over
    ``[real; fake]``), and the rank takes its rows of each."""
    mesh = active()
    if mesh is None or mesh.size("data") == 1:
        return x
    chunks = x.chunk(parts, dim) if parts > 1 else (x,)
    out = [c.narrow(dim, r.start, r.stop - r.start)
           for c in chunks for r in (data_rows(c.shape[dim], mesh),)]
    return out[0] if parts == 1 else torch.cat(out, dim)


def sum_over_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the enclosing ``sharded_step``'s 'data' group (``t``
    itself outside one, or on a 'data' axis of one rank): differentiable
    when autograd records ``t``."""
    mesh = active()
    if mesh is None or mesh.size("data") == 1:
        return t
    group = mesh.group("data")
    if torch.is_grad_enabled() and t.requires_grad:
        return dist_fn.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def spatial_axis_of(mesh) -> Optional[str]:
    """``'sp'`` when ``mesh`` shards the image height (an 'sp' axis of more
    than one rank), else None."""
    if mesh is None or "sp" not in getattr(mesh, "axis_names", ()):
        return None
    return "sp" if mesh.size("sp") > 1 else None


def sp_size() -> int:
    """Ranks along 'sp' in the enclosing ``sharded_step`` (1 outside one)."""
    mesh = active()
    return 1 if mesh is None else mesh.size("sp")


_HEIGHT_SHARDS = False


@contextlib.contextmanager
def height_shards() -> Iterator[None]:
    """The body's activations hold the rank's height rows: the convolutions
    exchange halo rows with the 'sp' neighbours (a no-op outside a
    ``sharded_step`` with more than one 'sp' rank). A module-level flag, not
    a thread-local: autograd may recompute a rematerialized block on its own
    thread, and the block sets the flag again there."""
    global _HEIGHT_SHARDS
    prev, _HEIGHT_SHARDS = _HEIGHT_SHARDS, True
    try:
        yield
    finally:
        _HEIGHT_SHARDS = prev


def height_sharded() -> bool:
    return _HEIGHT_SHARDS and sp_size() > 1


def _sp_line() -> Tuple[Any, int, int]:
    mesh = active()
    return mesh.group("sp"), mesh.coord("sp"), mesh.size("sp")


def _like(x: torch.Tensor, h: int) -> torch.Tensor:
    """An empty ``[N, C, h, W]`` tensor in ``x``'s memory format."""
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    return torch.empty(x.shape[:2] + (h,) + x.shape[3:], dtype=x.dtype, device=x.device,
                       memory_format=fmt)


def _edges(t: torch.Tensor, p: int, group, n: int) -> List[torch.Tensor]:
    """Every 'sp' rank's ``[first p rows, last p rows]`` of ``t``, gathered."""
    mine = torch.stack([t[:, :, :p], t[:, :, -p:]]).contiguous()
    out = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(out, mine, group=group)
    return out


def _halo(x: torch.Tensor, p: int, group, j: int, n: int) -> torch.Tensor:
    got = _edges(x, p, group, n)
    h = x.shape[2]
    out = _like(x, h + 2 * p)
    out[:, :, p:p + h] = x
    out[:, :, :p] = got[j - 1][1] if j > 0 else 0.0
    out[:, :, p + h:] = got[j + 1][0] if j < n - 1 else 0.0
    return out


def _halo_adjoint(g: torch.Tensor, p: int, group, j: int, n: int) -> torch.Tensor:
    """The adjoint of ``_halo``: the gradient of the rank's own rows plus
    what its neighbours' halo rows send back (rank j-1's bottom halo was
    this rank's top rows, rank j+1's top halo its bottom rows)."""
    got = _edges(g, p, group, n)
    h = g.shape[2] - 2 * p
    out = _like(g, h)
    out.copy_(g[:, :, p:p + h])
    if j > 0:
        out[:, :, :p] += got[j - 1][1]
    if j < n - 1:
        out[:, :, h - p:] += got[j + 1][0]
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, group, j, n):
        ctx.args = (p, group, j, n)
        return _halo(x, p, group, j, n)

    @staticmethod
    def backward(ctx, g):
        return (_HaloAdjoint.apply(g, *ctx.args),) + (None,) * 4


class _HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, p, group, j, n):
        ctx.args = (p, group, j, n)
        return _halo_adjoint(g, p, group, j, n)

    @staticmethod
    def backward(ctx, gg):
        return (_HaloExchange.apply(gg, *ctx.args),) + (None,) * 4


def halo_pad(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, int]:
    """``(x, p)`` for a conv to pad by ``p`` rows, or inside
    ``height_shards()`` ``(x with p rows of each 'sp' neighbour above and
    below, zeros at the image edge, 0)``: the rows a SAME conv of the whole
    image reads across the shard's edges."""
    if p == 0 or not height_sharded():
        return x, p
    group, j, n = _sp_line()
    if x.shape[2] < p:
        raise ValueError(f"a halo of {p} rows needs shards of {p} rows or more, "
                         f"got {x.shape[2]}")
    return _HaloExchange.apply(x, p, group, j, n), 0


class _GatherHeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, j, n):
        ctx.args = (group, j, n)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        return (_ReduceScatterHeight.apply(g, *ctx.args),) + (None,) * 3


class _ReduceScatterHeight(torch.autograd.Function):
    """The adjoint of the gather: the sum over the line, the rank's rows."""

    @staticmethod
    def forward(ctx, g, group, j, n):
        ctx.args = (group, j, n)
        total = g.contiguous().clone()
        dist.all_reduce(total, group=group)
        k = g.shape[2] // n
        return total[:, :, j * k:(j + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, gg):
        return (_GatherHeight.apply(gg, *ctx.args),) + (None,) * 3


def gather_height(x: torch.Tensor) -> torch.Tensor:
    """The whole height of a tensor whose dim 2 holds each 'sp' rank's rows
    (``x`` itself on one 'sp' rank); differentiable twice."""
    if sp_size() == 1:
        return x
    return _GatherHeight.apply(x, *_sp_line())


def split_height(x: torch.Tensor) -> torch.Tensor:
    """This 'sp' rank's contiguous 1/sp of dim 2 of a whole tensor (a view;
    its backward is local: the rank's rows of the gradient, zeros elsewhere)."""
    _, j, n = _sp_line()
    k = x.shape[2] // n
    return x.narrow(2, j * k, k)


class _SumOver(torch.autograd.Function):
    """A sum over ``group`` whose backward is the same sum (its adjoint)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return _SumOver.apply(g, ctx.group), None


def sum_over_sp(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the enclosing ``sharded_step``'s 'sp' line
    (differentiable: the backward sums the gradient over the line)."""
    mesh = active()
    if mesh is None or mesh.size("sp") == 1:
        return t
    return _SumOver.apply(t, mesh.group("sp"))


def average(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of each tensor over ``group``'s ranks, in one all-reduce of
    one flat buffer (``tensors`` need not be contiguous; the results are
    new tensors of their shapes; ``tensors`` as they are for a group of
    one rank, which has nothing to average)."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def tensor_parallel_spec(module: nn.Module, model_size: int,
                         min_features: int = DEFAULT_MIN_FEATURES) -> List[str]:
    """Names of ``module``'s parameters that shard over 'model', in module
    order: the reference's rule (``sharding.py:44-70``), a leaf of 2 or more
    dims whose JAX last dim (the port's dim 0: out-features of every kernel,
    features of every embedding table) is at least ``min_features`` and
    divides by ``model_size``. None under ``model_size`` 1."""
    if model_size <= 1:
        return []
    return [n for n, p in module.named_parameters()
            if p.dim() >= 2 and p.shape[0] >= min_features and p.shape[0] % model_size == 0]


def train_state_shardings(g: nn.Module, d: nn.Module, mesh: Optional[Mesh],
                          min_features: int = DEFAULT_MIN_FEATURES) -> Dict[str, List[str]]:
    """``{"g": names, "d": names}``: the parameters whose values, both Adam
    slots and (for G) the EMA shard over 'model' (reference ``sharding.py:
    73-101``). Buffers (BN running stats, SN ``u``) are replicated."""
    t = 1 if mesh is None else mesh.size("model")
    return {"g": tensor_parallel_spec(g, t, min_features),
            "d": tensor_parallel_spec(d, t, min_features)}


class ModelShards:
    """The rank's 'model' shards of one network's wide parameters.

    ``masters[name]`` is the rank's dim-0 slice of parameter ``name``, an
    ``nn.Parameter`` of its own that the optimizer updates; ``gather()``
    writes every shard back into the network's full-size parameter, in
    place. ``opt_params()`` lists the parameters the optimizer holds, in
    the network's order (a master in place of each wide parameter), so an
    optimizer ``state_dict`` keeps the one-rank indices."""

    def __init__(self, module: nn.Module, names: Sequence[str], mesh: Mesh):
        self.group = mesh.group("model")
        self.t, self.j = mesh.size("model"), mesh.coord("model")
        self.params = dict(module.named_parameters())
        self.masters = {n: nn.Parameter(self.params[n].detach()[self.rows(n)].clone())
                        for n in names}

    def rows(self, name: str) -> slice:
        k = self.params[name].shape[0] // self.t
        return slice(self.j * k, (self.j + 1) * k)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full-size tensor of parameter ``name``
        (``full`` itself for a replicated parameter)."""
        return full[self.rows(name)] if name in self.masters else full

    def opt_params(self) -> List[nn.Parameter]:
        return [self.masters.get(n, p) for n, p in self.params.items()]

    def shard_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.shard(n, g) for n, g in zip(self.params, grads)]

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """A new full-size tensor gathered from every rank's ``shard`` of
        parameter ``name``."""
        out = torch.empty(self.params[name].shape, dtype=shard.dtype, device=shard.device)
        dist.all_gather(list(out.chunk(self.t)), shard.contiguous(), group=self.group)
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """Every master into its full-size parameter, in place."""
        for n, m in self.masters.items():
            dist.all_gather(list(self.params[n].chunk(self.t)), m, group=self.group)

    @torch.no_grad()
    def load_full(self) -> None:
        """Every master from its full-size parameter (after a restore)."""
        for n, m in self.masters.items():
            m.copy_(self.shard(n, self.params[n]))

