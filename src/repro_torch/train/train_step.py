"""Training step: microbatched grad accumulation + optimizer update.

The counterpart of the JAX package's ``train/train_step.py``: ``step(state,
batch) -> (state, metrics)``.  PyTorch runs it eagerly (the JAX step is
``jax.jit``-compiled; nothing here needs a compiler), and the optimizer
writes the parameters and moments in place (``optimizer.py``), so the
state a step returns holds the tensors it was given.

Microbatching: the global batch is split along its first axis into
``microbatches`` equal parts, each part's gradients taken with
``torch.autograd.grad`` and added into f32 accumulators in order, then
divided by the count, as the JAX ``lax.scan`` does.  ``.backward()`` is not
used: ``.grad`` of a bf16 leaf would accumulate in bf16, a different sum.

On a mesh (the parameters DTensors placed by ``elastic.reshard``, the
step called under ``use_mesh``) the same code runs on DTensors: each
gradient is redistributed to its parameter's sharding (a ``Partial`` sum
reduced there), the loss and metrics are the whole values on every rank,
microbatches are cut from each rank's local rows, and the optimizer
updates local shards.  Off a mesh, and on a mesh of one rank, nothing of
this runs: the step is the one-card step, bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..models.model import Model
from ..models.sharding import (init_params, tree_leaves, tree_map,
                               tree_unflatten)
from .compress import compress_grads, init_error
from .optimizer import AdamW, AdamWState, _local, _zeros_like, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    error: Optional[Any] = None     # error-feedback state (compression)


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``: each leaf
    is differentiated through a detached alias (the parameters themselves
    need not require grad), the grads a tree shaped like ``params`` in
    each leaf's dtype, the loss and metrics detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [_as_placed(g, p) for g, p in zip(grads, leaves)]
    metrics = {k: _local(torch.as_tensor(v).detach())
               for k, v in metrics.items()}
    return _local(loss.detach()), metrics, tree_unflatten(params, grads)


def _as_placed(g, p):
    """A DTensor gradient redistributed to its parameter's placements (a
    ``Partial`` sum reduced); a plain one as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local_chunks(v, n: int):
    """``v`` cut into ``n`` parts along its first axis; a DTensor's local
    rows are cut on each rank (each part keeps ``v``'s placements), so a
    batch sharded over the DP axes splits with no communication."""
    from torch.distributed.tensor import DTensor
    if not isinstance(v, DTensor):
        return v.chunk(n)
    return [DTensor.from_local(c, v.device_mesh, v.placements,
                               run_check=False)
            for c in v.to_local().chunk(n)]


def make_train_step(
    model: Model,
    optimizer: AdamW,
    microbatches: int = 1,
    compress: bool = False,
) -> Callable:
    """Returns step(state, batch) -> (state, metrics)."""

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            parts = {k: torch.as_tensor(v) for k, v in batch.items()}
            if any(_local_rows(v) % microbatches for v in parts.values()):
                raise ValueError(f"the batch does not split into "
                                 f"{microbatches} microbatches")
            parts = {k: _local_chunks(v, microbatches)
                     for k, v in parts.items()}
            acc = [_zeros_like(p, torch.float32) for p in tree_leaves(params)]
            loss = 0.0
            for i in range(microbatches):
                mloss, _, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in parts.items()})
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi)
                del g
                loss = loss + mloss
            for a in acc:
                a.div_(microbatches)
            grads = tree_unflatten(params, acc)
            loss = loss / microbatches
            metrics = {}

        new_error = state.error
        if compress:
            grads, new_error = compress_grads(grads, state.error)

        new_params, new_opt = optimizer.update(grads, state.opt, params)
        with torch.no_grad():
            gnorm = global_norm(grads)
        out_metrics = {"loss": loss, "grad_norm": gnorm,
                       "lr": torch.as_tensor(optimizer.lr(new_opt.step),
                                             dtype=torch.float32),
                       **metrics}
        return TrainState(new_params, new_opt, new_error), out_metrics

    return step


def _local_rows(v) -> int:
    from torch.distributed.tensor import DTensor
    return (v.to_local() if isinstance(v, DTensor) else v).shape[0]


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               compress: bool = False, device=None) -> TrainState:
    """Parameters drawn by ``init_params`` from ``generator`` on ``device``
    (None: the GPU, raising without one; ``"cpu"`` for tests), zero
    moments, and the error state when ``compress``."""
    params = init_params(model.specs, generator, device)
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        error=init_error(params) if compress else None,
    )


def abstract_state(model: Model, optimizer: AdamW, compress: bool = False
                   ) -> TrainState:
    """The state on the ``meta`` device: every leaf's shape and dtype, no
    storage (``jax.ShapeDtypeStruct``'s counterpart)."""
    shapes = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), model.specs)
    return TrainState(
        params=shapes,
        opt=optimizer.init_abstract(shapes),
        error=tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"), shapes)
        if compress else None,
    )
