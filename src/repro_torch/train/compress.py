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
  * ``compressed_psum`` — the quantized all-reduce over a mesh axis.  It
    needs the mesh, which is ROADMAP queue 1, item 15.5: until then it
    raises.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.sharding import tree_leaves, tree_map, tree_unflatten

MESH_ITEM = "ROADMAP queue 1, item 15.5"


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


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The int8-quantized all-reduce over ``axis_name``: not ported."""
    raise NotImplementedError(
        f"compressed_psum is a collective over the mesh: {MESH_ITEM}")
