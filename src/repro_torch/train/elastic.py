"""Elastic scaling: re-mesh + state resharding after topology changes.

The counterpart of the JAX package's ``train/elastic.py``.  Scenario at
1000+ nodes: a pod (or a slice of one) fails mid-run.  The job restarts
on the surviving ranks; ``plan_mesh`` builds the largest valid (data,
model) mesh from what is left (the model-parallel degree is kept where it
can be — TP re-sharding would change matmul partitioning — while the data
axis absorbs the loss), and ``reshard`` places the restored checkpoint on
the new shardings as DTensors.  ``scale_batch`` keeps the *global* batch
constant when possible by raising the per-replica microbatch count.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..core.device_stats import resolve_device
from ..models.sharding import NamedSharding, P, mesh_size, tree_shardings


def plan_mesh(devices: Optional[Sequence[int]] = None,
              model_parallel: int = 16,
              axis_names: Tuple[str, str] = ("data", "model"),
              device=None):
    """Largest (data, model) ``DeviceMesh`` from the surviving ranks.

    ``devices`` lists the surviving global ranks of the default process
    group (None: all of them); ``device`` is the mesh's device type (None:
    the GPU, raising without one; ``"cpu"`` for tests).  Every rank of
    the group calls it, as it builds the axes' process groups."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    while model_parallel > 1 and (n % model_parallel or n < model_parallel):
        model_parallel //= 2
    data = n // model_parallel
    usable = torch.tensor(ranks[: data * model_parallel], dtype=torch.int64)
    return DeviceMesh(dev.type, usable.reshape(data, model_parallel),
                      mesh_dim_names=tuple(axis_names))


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` on ``sharding`` (``jax.device_put``'s counterpart): a DTensor
    cut from this rank's copy of the whole tensor (no communication: every
    rank holds the same values, as after a restore); on a mesh of one rank
    the plain tensor on the mesh's device.  A DTensor on another mesh is
    gathered whole first."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = sharding.mesh
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.to(mesh.device_type)
    if mesh_size(mesh) == 1:
        return t
    return distribute_tensor(t, mesh, sharding.placements(),
                             src_data_rank=None)


def reshard(state: Any, specs: Any, new_mesh, rules=None) -> Any:
    """Place every leaf on the new mesh's shardings.

    ``specs`` is the ParamSpec tree for the params; optimizer-state and
    error leaves reuse the matching param shardings (same logical axes),
    and the step is replicated.  On a mesh of one rank the leaves stay
    plain tensors on its device."""
    from .train_step import TrainState

    param_sh = tree_shardings(specs, new_mesh, rules)

    def put(tree):
        return _zip_map(place, tree, param_sh)

    if isinstance(state, TrainState):
        return TrainState(
            params=put(state.params),
            opt=type(state.opt)(
                step=place(state.opt.step, NamedSharding(new_mesh, P())),
                m=put(state.opt.m),
                v=put(state.opt.v),
            ),
            error=None if state.error is None else put(state.error),
        )
    return put(state)


def _zip_map(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    return fn(tree, shardings)


def scale_batch(global_batch: int, old_data: int, new_data: int,
                microbatches: int) -> Tuple[int, int]:
    """Keep the global batch when the data-parallel degree shrinks by
    raising the microbatch count; otherwise shrink to the nearest valid.

    Returns (global_batch, microbatches).
    """
    if new_data == old_data:
        return global_batch, microbatches
    if global_batch % new_data == 0:
        factor = max(old_data // max(new_data, 1), 1)
        return global_batch, microbatches * factor
    per = max(global_batch // new_data, 1)
    return per * new_data, microbatches
