"""The system under test as the harness drives it: a train state built by
the program's own builders, its fused step (``train/step.py``
``make_train_step``) and its batches (``train/loop.py`` ``device_batches``
over a ``DeviceCachedStore``). ``builders/<config>.py`` makes one.

The harness loads the benchmark's weights into the state (``load``), calls
``next_batch`` and ``run_step`` as ``train_loop`` does (``state.alpha`` set
from the phase's ``alpha_fn`` before each step), and reads what the
comparison needs: the critic's logits of its first update (a forward hook
on D for that call only), each leaf's first gradient as its Adam gets it (a
step pre-hook on each Adam) and each leaf's tensor after three.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from gan_lib_tensorflow_tpu_torch.train import make_train_step


class _FirstCall:
    """A critic loss that keeps every output of ``critic`` (the logits of
    each sample) that its first call made, in order."""

    def __init__(self, fn: Callable, critic: torch.nn.Module):
        self.fn, self.critic, self.logits = fn, critic, None

    def __call__(self, *args, **kwargs):
        if self.logits is not None:
            return self.fn(*args, **kwargs)
        logits = []
        hook = self.critic.register_forward_hook(
            lambda module, inputs, out: logits.append(out.detach().float().reshape(-1).clone()))
        try:
            out = self.fn(*args, **kwargs)
        finally:
            hook.remove()
        self.logits = torch.cat(logits)
        return out


class Program:
    def __init__(self, state, spec, batches: Iterator, images_per_step: int,
                 alpha_fn: Optional[Callable[[int], float]] = None, start_step: int = 0):
        """The step is ``make_train_step(spec)`` with the spec's critic loss
        keeping its first call's logits."""
        self._d_loss = _FirstCall(spec.d_loss, state.d)
        self.state, self.batches = state, batches
        self.step_fn = make_train_step(dataclasses.replace(spec, d_loss=self._d_loss))
        self.images_per_step = images_per_step
        self.alpha_fn, self.pos = alpha_fn, start_step

    def first_logits(self) -> list:
        """Every logit the critic gave in its first update, in call order."""
        return [] if self._d_loss.logits is None else self._d_loss.logits.cpu().tolist()

    def next_batch(self):
        return next(self.batches)

    def run_step(self, batch) -> Dict[str, torch.Tensor]:
        if self.alpha_fn is not None:
            self.state.alpha = float(self.alpha_fn(self.pos))
        self.pos += 1
        return self.step_fn(self.state, batch)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The state's leaves by the reference's names: ``g.``/``d.``
        parameters, ``gbuf.``/``dbuf.`` buffers, ``ema.`` the EMA of G."""
        st, out = self.state, {}
        for net in ("g", "d"):
            module = getattr(st, net)
            out.update({f"{net}.{n}": p for n, p in module.named_parameters()})
            out.update({f"{net}buf.{n}": b for n, b in module.named_buffers()})
        if st.ema_params is not None:
            out.update({f"ema.{n}": t for n, t in st.ema_params.items()})
        return out

    @torch.no_grad()
    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        """Copy the benchmark's weights into every parameter and buffer; the
        EMA starts as G's parameters. Raises unless the names and shapes
        are exactly the reference's."""
        live = {n: t for n, t in self.tensors().items() if not n.startswith("ema.")}
        if set(live) != set(weights):
            raise ValueError(f"the program's leaves differ from the reference's: only "
                             f"the program has {sorted(set(live) - set(weights))[:8]}, only "
                             f"the reference {sorted(set(weights) - set(live))[:8]}")
        for name, t in live.items():
            if t.shape != weights[name].shape:
                raise ValueError(f"{name}: the program's shape {tuple(t.shape)} is not "
                                 f"the reference's {tuple(weights[name].shape)}")
            t.copy_(weights[name])
        for name, t in (self.state.ema_params or {}).items():
            t.copy_(weights[f"g.{name}"])

    def watch_first_grads(self) -> Tuple[Dict[str, torch.Tensor], Callable[[], None]]:
        """A dict that fills, by the reference's names, with each parameter's
        gradient as its optimizer gets it at its first update (a step
        pre-hook on each Adam), and the function that removes the hooks."""
        grads: Dict[str, torch.Tensor] = {}
        handles = []
        for net in ("g", "d"):
            names = {id(p): f"{net}.{n}" for n, p in getattr(self.state, net).named_parameters()}

            def first(opt, args, kwargs, names=names):
                if next(iter(names.values())) in grads:
                    return
                for group in opt.param_groups:
                    for p in group["params"]:
                        grads[names[id(p)]] = p.grad.detach().clone()

            handles.append(getattr(self.state, f"{net}_opt").register_step_pre_hook(first))
        return grads, lambda: [h.remove() for h in handles]

    @staticmethod
    def start_of(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The leaves as they start, the EMA's included."""
        return {**weights, **{f"ema.{n[2:]}": t for n, t in weights.items()
                              if n.startswith("g.")}}
