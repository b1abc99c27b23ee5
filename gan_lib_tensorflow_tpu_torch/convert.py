"""Load a JAX-package ``GANTrainState`` (``gan_lib_tensorflow_tpu/train/
state.py``), given as numpy trees, into the port's ``GANTrainState``.

Layouts: conv kernels HWIO -> OIHW, Dense kernels ``[in, out]`` -> ``[out,
in]``, embedding tables ``[num_embeddings, features]`` -> ``[features,
num_embeddings]`` (conditional BN's gamma and beta, the projection's SN
``proj_embed``), BN ``scale`` -> ``weight``; ``'sn'`` ``u`` -> the layer's
``u`` buffer;
``'batch_stats'`` ``mean``/``var`` -> ``running_mean``/``running_var``. optax
Adam ``mu``/``nu``/``count`` become ``torch.optim.Adam``'s ``exp_avg``/
``exp_avg_sq``/``step``. Flax module names are the port's module names, so a
flax path ``block0/conv1/kernel`` is the port's ``block0.conv1.weight``.

G's first Dense output is reshaped NHWC in both packages (the port permutes
the NHWC view to NCHW afterwards), so its columns need no permutation. The
same holds for the input of PGGAN D's ``dense_4``: the reference flattens
its NHWC map, and the port flattens an NHWC view of its NCHW map, so the
rows of that kernel keep their order too. PGGAN states have no ``'sn'`` or
``'batch_stats'`` collections; their fade-in ``alpha`` is carried over.

The input can be the state object itself after ``tree_map(np.asarray, ...)``
or a mapping of its fields; optax states are read by their ``count``, ``mu``
and ``nu`` fields, so neither optax nor JAX is imported here.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias", "u": "u", "mean": "running_mean", "var": "running_var"}


def _field(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def to_torch_names(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax tree (params, one of their Adam slots, or a state collection
    without its collection key) -> ``{port name: array in port layout}``."""
    out = {}
    for path, leaf in _flatten(tree):
        *mods, name = path
        if name not in _LEAF_NAMES:
            raise ValueError(f"no port counterpart for flax leaf {'/'.join(path)}")
        arr = np.asarray(leaf, dtype=np.float32)
        if name in ("kernel", "embedding"):
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[".".join(mods + [_LEAF_NAMES[name]])] = np.array(arr, order="C")  # own, writable copy
    return out


def module_tensors(params: Mapping, collections: Mapping) -> Dict[str, np.ndarray]:
    """Everything a network's ``state_dict`` holds: params plus the 'sn' and
    'batch_stats' collections."""
    out = to_torch_names(params)
    for coll in collections.values():
        out.update(to_torch_names(coll))
    return out


def _adam_fields(opt: Any):
    """(count, mu, nu) of the optax Adam state inside ``opt`` (a chain's
    tuple of states, or the Adam state itself)."""
    if hasattr(opt, "mu") or (isinstance(opt, Mapping) and "mu" in opt):
        return _field(opt, "count"), _field(opt, "mu"), _field(opt, "nu")
    if isinstance(opt, (tuple, list)):
        for sub in opt:
            found = _adam_fields(sub)
            if found is not None:
                return found
    return None


def _load_adam(opt: torch.optim.Optimizer, sched, module: torch.nn.Module,
               jax_opt: Any) -> None:
    fields = _adam_fields(jax_opt)
    if fields is None:
        raise ValueError("no optax Adam state (count/mu/nu) found")
    count, mu, nu = fields
    count = int(np.asarray(count))
    mu, nu = to_torch_names(mu), to_torch_names(nu)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(mu[name]).to(p),
            "exp_avg_sq": torch.as_tensor(nu[name]).to(p),
        }
    if sched is not None:  # the schedule counts the same updates
        sched.last_epoch = count
        for group, base, f in zip(opt.param_groups, sched.base_lrs,
                                  sched.lr_lambdas):
            group["lr"] = base * f(count)


def load_jax_state(state, jax_state: Any) -> None:
    """Copy a numpy-tree JAX ``GANTrainState`` into the port's ``state``
    (in place). Names and shapes must match exactly (``load_state_dict``
    with ``strict=True`` raises otherwise)."""
    for net, p_key, s_key in ((state.g, "g_params", "g_state"),
                              (state.d, "d_params", "d_state")):
        tensors = module_tensors(_field(jax_state, p_key), _field(jax_state, s_key))
        net.load_state_dict({k: torch.as_tensor(v) for k, v in tensors.items()},
                            strict=True)
    _load_adam(state.g_opt, state.g_sched, state.g, _field(jax_state, "g_opt"))
    _load_adam(state.d_opt, state.d_sched, state.d, _field(jax_state, "d_opt"))
    ema = _field(jax_state, "ema_params")
    if ema is None:
        state.ema_params = None
    else:
        ema = to_torch_names(ema)
        state.ema_params = {n: torch.as_tensor(ema[n]).to(p)
                            for n, p in state.g.named_parameters()}
    state.step = int(np.asarray(_field(jax_state, "step")))
    alpha = (jax_state.get("alpha") if isinstance(jax_state, Mapping)
             else getattr(jax_state, "alpha", None))
    if alpha is not None:
        state.alpha = float(np.asarray(alpha))
