"""Sharding rules (port of ``gan_lib_tensorflow_tpu/parallel/sharding.py:
11-101``): the rank's rows of a global batch, the tensor-parallel spec of a
network's parameters, and the collectives the sharded step needs.

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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from .mesh import Mesh, active

DEFAULT_MIN_FEATURES = 256


def data_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n`` (all of them without a
    mesh); ``n`` must divide over the 'data' axis."""
    d = 1 if mesh is None else mesh.size("data")
    if n % d:
        raise ValueError(f"batch_size {n} not divisible by data-mesh size {d}")
    k, i = n // d, (0 if mesh is None else mesh.coord("data"))
    return slice(i * k, (i + 1) * k)


def shard_batch(batch: Any, mesh: Optional[Mesh], leading_stack_dims: int = 0) -> Any:
    """This rank's rows of a batch (a tensor, an array, or a dict or list of
    them): dim ``leading_stack_dims`` is the batch; the leading microbatch
    stack dims before it stay whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, leading_stack_dims) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, leading_stack_dims) for v in batch)
    rows = data_rows(batch.shape[leading_stack_dims], mesh)
    return batch[(slice(None),) * leading_stack_dims + (rows,)]


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

