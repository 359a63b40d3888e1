"""Elastic scaling: batch bookkeeping after a topology change.

The counterpart of the JAX package's ``train/elastic.py``.
``scale_batch`` keeps the *global* batch constant when the data-parallel
degree shrinks by raising the per-replica microbatch count.  ``plan_mesh``
and ``reshard`` build and fill a (data, model) mesh: they need the mesh
half of ``models/sharding.py``, which is ROADMAP queue 1, item 15.5, and
until then they raise.
"""

from __future__ import annotations

from typing import Any, Tuple

from .compress import MESH_ITEM


def plan_mesh(devices=None, model_parallel: int = 16,
              axis_names: Tuple[str, str] = ("data", "model")):
    """The largest (data, model) mesh from the surviving devices: not
    ported."""
    raise NotImplementedError(f"plan_mesh needs the mesh: {MESH_ITEM}")


def reshard(state: Any, specs: Any, new_mesh, rules=None) -> Any:
    """Place every leaf on the new mesh's shardings: not ported."""
    raise NotImplementedError(f"reshard needs the mesh: {MESH_ITEM}")


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
