"""The fused n_critic x D + G train step (port of
``gan_lib_tensorflow_tpu/train/step.py:59-130``).

One call runs: all n_critic fake microbatches (one G forward under
``no_grad``), the n_critic critic updates, the G update against D as it stands
after the critic loop, then the EMA of G's parameters. Unlike the reference's
pure function, the step updates the state in place (parameters, Adam slots,
``u`` buffers, BN running stats), which saves a copy of every tensor.

On a mesh (``state.mesh``, one process per rank) the step computes the
one-rank step's function of the global batch, as the reference's GSPMD step
does: the batch holds the rank's rows, every draw is made at the global
batch from generators seeded alike on every rank and sliced, batch
statistics are global (``ops/norms.py``), and each update averages its
gradients over 'data' in one flat all-reduce before the optimizer step (the
reference's psum; no DDP, whose reducer cannot take the gradient penalty's
double backward nor ``torch.autograd.grad``). Under 'model' sharding the
optimizer and EMA hold the rank's shards (``parallel.ModelShards``): the
full gradient is sliced to the shard, and the updated shards are gathered
back into the network's weights. With an 'sp' axis (PGGAN's spatial
partitioning) the update averages its gradients over all d * sp ranks in
the one all-reduce: every rank of an 'sp' line computes the loss whole,
which counts it sp times (``parallel/sharding.py`` gives the rule); the
metrics, whole on every rank of a line, average over 'data' only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from ..parallel.mesh import sharded_step
from ..parallel.sharding import average, global_batch, local_rows
from ..utils.profiler import span

# each update's spans (utils/profiler.py): its gradient, all-reduce and optimizer
_UPDATE_SPANS = {net: (f"{net}.backward", f"{net}.allreduce", f"{net}.optimizer")
                 for net in ("d", "g")}


@dataclasses.dataclass(frozen=True)
class GANSpec:
    """What the step needs to know about a model family. ``alpha`` is the
    state's fade-in weight (a float; only PGGAN reads it), as the
    reference's loss signature carries it (``step.py:27-30``). With
    ``num_classes`` > 0 the family is class-conditional: ``labels`` below are
    integer class tensors; otherwise they are None.

    prepare_fakes(z_stack [n_critic, B, z_dim], alpha, labels [n_critic, B])
        -> fakes [n_critic, B, ...]
    d_loss(real, fake, alpha, noise, u_gp, labels, masks) -> (loss, metrics):
        ``noise`` is the generator of the critic's own draws (the
        reference's per-substep rng), ``u_gp`` the gradient penalty's
        interpolation weights ``[B, 1, 1, 1]`` when the caller hands them
        in, else None; ``labels`` is ``(real_labels, fake_labels)``;
        ``masks`` D's dropout keep masks when the caller hands them in
        (else None: a family with dropout draws them from ``noise``)
    g_loss(z, alpha, labels [B], noise, masks) -> (loss, metrics): ``noise``
        is the G update's generator, ``masks`` as for ``d_loss``

    A ``paired`` family (pix2pix) translates real inputs and draws no z:
    the batch is ``{"input", "target"}`` stacks, ``prepare_fakes`` is None,
    and the losses take the microbatch dict itself:
    d_loss(micro, noise, masks) and g_loss(micro, noise, masks).
    """

    prepare_fakes: Optional[Callable]
    d_loss: Callable
    g_loss: Callable
    n_critic: int = 1
    ema_decay: float = 0.0
    z_dim: int = 128
    num_classes: int = 0
    paired: bool = False


def make_train_step(spec: GANSpec):
    """``train_step(state, batch, z_critic=None, z_g=None, u_gp=None,
    labels_critic=None, labels_g=None, masks_critic=None, masks_g=None)
    -> metrics``.

    ``batch["image"]`` is ``[n_critic, B, S, S, 3]``; a conditional family
    also reads ``batch["label"]`` ``[n_critic, B]``. Draws come from the
    state's generators unless given (the parity tests feed JAX's draws):
    ``z_critic`` ``[n_critic, B, z_dim]`` then ``labels_critic`` ``[n_critic,
    B]`` (the critic fakes' classes) from ``d_noise``, ``z_g`` ``[B, z_dim]``
    then ``labels_g`` ``[B]`` from ``g_noise``, ``u_gp`` ``[n_critic, B, 1, 1,
    1]``, and the dropout masks of a family with dropout: ``masks_critic``
    one set per critic substep, ``masks_g`` the G update's (the spec says
    what a set holds). A paired spec's batch is ``{"input", "target"}``
    ``[n_critic, B, S, S, 3]`` stacks, and only the masks apply. Metrics are
    device tensors; reading them waits for the step."""

    def _apply(params, grads, opt, sched) -> None:
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:  # a shard's gradient is a view of the full one: free it
            p.grad = None
        if sched is not None:
            sched.step()

    def _update(state, net: str, loss: torch.Tensor) -> None:
        """One optimizer update of ``net`` ('g' or 'd') from ``loss``: the
        rank's gradients (its 'model' shards of the wide ones) averaged over
        'data', the update on what the rank holds, the shards gathered back
        into the network."""
        backward, allreduce, optimizer = _UPDATE_SPANS[net]
        module, shards = getattr(state, net), getattr(state, f"{net}_shards")
        params = list(module.parameters())
        with span(backward):
            grads = torch.autograd.grad(loss, params)
            if shards is not None:
                grads, params = shards.shard_grads(grads), shards.opt_params()
        if state.mesh is not None:
            with span(allreduce):
                # None: every rank of the mesh, the 'sp' sum with the 'data' mean
                grads = average(grads, state.mesh.group("data")
                                if state.mesh.size("sp") == 1 else None)
        with span(optimizer):
            _apply(params, grads, getattr(state, f"{net}_opt"),
                   getattr(state, f"{net}_sched"))
            if shards is not None:
                shards.gather()

    def train_step(state, batch, z_critic: Optional[torch.Tensor] = None,
                   z_g: Optional[torch.Tensor] = None,
                   u_gp: Optional[torch.Tensor] = None,
                   labels_critic: Optional[torch.Tensor] = None,
                   labels_g: Optional[torch.Tensor] = None,
                   masks_critic: Optional[Sequence] = None,
                   masks_g=None) -> Dict[str, torch.Tensor]:
        with span("step", step=state.step + 1), sharded_step(state.mesh):
            return _step(state, batch, z_critic, z_g, u_gp, labels_critic, labels_g,
                         masks_critic, masks_g)

    def _step(state, batch, z_critic, z_g, u_gp, labels_critic, labels_g,
              masks_critic, masks_g):
        key = "input" if spec.paired else "image"
        images = batch[key]
        if images.shape[0] != spec.n_critic:
            raise ValueError(f"batch[{key!r}] must be a [n_critic={spec.n_critic}"
                             f", B, ...] stack, got shape {tuple(images.shape)}")
        if spec.ema_decay > 0 and state.ema_params is None:
            raise ValueError("spec.ema_decay > 0 but state.ema_params is None")
        if spec.paired:
            def micro(i):
                return {k: v[i] for k, v in batch.items()}

            def d_call(i, masks):
                return spec.d_loss(micro(i), state.d_noise, masks)

            def g_call(masks):
                return spec.g_loss(micro(-1), state.g_noise, masks)
        else:
            with span("step.fakes"):
                d_call, g_call = _drawn_calls(spec, state, batch, images, z_critic, z_g,
                                              u_gp, labels_critic, labels_g)

        for i in range(spec.n_critic):
            with span("step.d_update", i=i):
                with span("d.loss"):
                    loss, metrics = d_call(i, None if masks_critic is None
                                           else masks_critic[i])
                _update(state, "d", loss)

        with span("step.g_update"):
            with span("g.loss"):
                g_loss, g_metrics = g_call(masks_g)
            _update(state, "g", g_loss)

        if spec.ema_decay > 0:
            with span("step.ema"):
                d_ = spec.ema_decay
                names = [name for name, _ in state.g.named_parameters()]
                held = (state.g_shards.opt_params() if state.g_shards is not None
                        else list(state.g.parameters()))
                ema = [state.ema_params[name] for name in names]
                with torch.no_grad():
                    torch._foreach_mul_(ema, d_)
                    torch._foreach_add_(ema, held, alpha=1.0 - d_)
        state.step += 1
        out = {**metrics, **g_metrics, "g_loss": g_loss.detach()}
        if state.mesh is not None:  # the global batch's means
            out = dict(zip(out, average(list(out.values()), state.mesh.group("data"))))
        return out

    return train_step


def _drawn_calls(spec: GANSpec, state, batch, images, z_critic, z_g, u_gp,
                 labels_critic, labels_g):
    """The critic and G loss calls of a family that draws z (and classes):
    the critic fakes' draws come from ``d_noise`` now, the G update's from
    ``g_noise`` when the G loss is called. Every draw, given or made, is of
    the global batch; the rank keeps its rows."""
    n, dev, alpha = global_batch(images.shape[1]), images.device, state.alpha
    nc = spec.num_classes
    if z_critic is None:
        z_critic = torch.randn(spec.n_critic, n, spec.z_dim, device=dev,
                               generator=state.d_noise)
    if nc and labels_critic is None:
        labels_critic = torch.randint(0, nc, (spec.n_critic, n), device=dev,
                                      generator=state.d_noise)
    z_critic = local_rows(z_critic, dim=1)
    labels_critic = None if labels_critic is None else local_rows(labels_critic, dim=1)
    if u_gp is not None:
        u_gp = local_rows(u_gp, dim=1)
    fakes = spec.prepare_fakes(z_critic, alpha, labels_critic)

    def d_call(i, masks):
        labels = (batch["label"][i], labels_critic[i]) if nc else None
        return spec.d_loss(images[i], fakes[i], alpha, state.d_noise,
                           None if u_gp is None else u_gp[i], labels, masks)

    def g_call(masks):
        z, labels = z_g, labels_g
        if z is None:
            z = torch.randn(n, spec.z_dim, device=dev, generator=state.g_noise)
        if nc and labels is None:
            labels = torch.randint(0, nc, (n,), device=dev, generator=state.g_noise)
        return spec.g_loss(local_rows(z), alpha,
                           None if labels is None else local_rows(labels),
                           state.g_noise, masks)

    return d_call, g_call
