"""Error-feedback int8 gradient compression for the cross-pod hop.

The counterpart of the JAX package's ``train/compress.py``.  Quantizing
the summand to int8 (per-tensor absmax scale) cuts the bytes of a
gradient all-reduce 4x against f32, at the cost of quantization noise
that *error feedback* (Karimireddy et al., 2019) re-injects next step.

  * ``compress_grads`` — tree-level quantize -> dequantize with carried
    error state; applied before the optimizer in ``train_step`` when
    enabled.  It simulates the wire format exactly: ``torch.round`` and
    ``jnp.round`` both round half to even, so the wire values equal the
    JAX package's bit for bit.
  * ``compressed_psum`` — the quantized all-reduce over one mesh axis,
    ``torch.distributed`` collectives on that axis's process group (the
    JAX package's ``pmax`` / ``psum`` inside ``shard_map``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.sharding import (current_mesh, tree_leaves, tree_map,
                               tree_unflatten)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads as seen after the wire, new error
    state)."""
    out_g, out_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        deq = q.float() * scale
        out_g.append(deq.to(g.dtype))
        out_e.append(g32 - deq)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(x: torch.Tensor, axis_name: str, mesh=None
                    ) -> torch.Tensor:
    """int8-quantized all-reduce of this rank's ``x`` over the mesh axis
    ``axis_name`` (``mesh=None``: the mesh ``use_mesh`` activated).

    Protocol, as in the JAX package: agree on a shared scale (the max of
    each rank's ``max(|x|, 1e-12) / 127`` over the axis), send int8,
    accumulate in int32, rescale.  The sum travels as int32, as the JAX
    package's ``psum`` of the int32 cast does, after one scalar round for
    the scale.  The int32 sum is exact and ``torch.round``
    rounds half to even as ``jnp.round`` does, so the result is the JAX
    package's bit for bit on the same per-rank inputs.  Collectives run
    on ``x``'s own device: NCCL on the card, and gloo takes CUDA tensors
    too (the MAX and SUM all-reduces in f32 and int32 among them)."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or call "
                         "it under use_mesh")
    group = mesh.get_group(axis_name)
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    total = torch.clamp(torch.round(x / scale), -127, 127).to(
        torch.int8).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale
