"""AdamW with configurable state dtype + global-norm clipping.

The counterpart of the JAX package's ``train/optimizer.py``, with the
same names and arithmetic: the moments and the step in f32 whatever the
state dtype, the clip scale from the global norm of the gradients, and
each parameter cast back to its own dtype.  ``state_dtype=torch.bfloat16``
halves the optimizer state (6 bytes a bf16 parameter instead of 10).

``update`` differs on purpose: it writes the new parameters, m and v into
their tensors in place, leaf by leaf and ``UPDATE_CHUNK`` elements at a
time under ``no_grad`` (elementwise, so the chunks change no value), so
a step adds a few chunks' f32 temporaries to the peak, where the JAX
step returns new arrays and its driver donates the old ones.  The
caller's ``params`` and ``state`` tensors are the updated ones
afterwards; they must be contiguous.

On a mesh (``reshard``'s DTensors) each rank updates its own local
shards: the arithmetic is elementwise and the gradients, moments and
parameters of a leaf share one sharding, so no value changes; the global
norm is the norm over the whole mesh (DTensor reduces the per-shard sums).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..models.sharding import tree_leaves, tree_map

# elements of a leaf updated at once: the f32 temporaries of a step stay
# at a few of these (256 MB each) whatever the leaf's size (a stacked FFN
# leaf of Llama-3.2-3B is 704 M elements, 2.8 GB in f32)
UPDATE_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    m: Any
    v: Any


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves added in
    ``tree_leaves``'s order (the JAX package's ``sum`` over its leaves).
    Over DTensor leaves it is the norm of the whole tensors, a plain
    tensor holding the same value on every rank."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return _local(torch.sqrt(total))


def _local(t):
    """A DTensor's value on this rank (``full_tensor``: a scalar or a
    replicated value), any other value as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _shard(t):
    """This rank's local shard of a DTensor, a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], Any]        # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = lambda p: _zeros_like(p, self.state_dtype)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    def init_abstract(self, param_shapes) -> AdamWState:
        """The state on the ``meta`` device: shapes and dtypes, no
        storage (``jax.ShapeDtypeStruct``'s counterpart)."""
        zeros = lambda p: torch.empty(p.shape, dtype=self.state_dtype,
                                      device="meta")
        return AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=tree_map(zeros, param_shapes),
            v=tree_map(zeros, param_shapes),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        """One step: returns (params, state), the same tensors written in
        place, with the state's step a new tensor."""
        step = _local(state.step) + 1
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        s32 = step.float()
        bc1 = 1.0 - torch.pow(b1, s32)
        bc2 = 1.0 - torch.pow(b2, s32)
        lr = _local(self.lr(step))

        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v), tree_leaves(params)):
            g, m, v, p = (_shard(g).reshape(-1), _flat(_shard(m)),
                          _flat(_shard(v)), _flat(_shard(p)))
            for i in range(0, p.numel(), UPDATE_CHUNK):
                at = slice(i, i + UPDATE_CHUNK)
                self._update_chunk(g[at], m[at], v[at], p[at], scale, bc1,
                                   bc2, lr)
        return params, AdamWState(step=step, m=state.m, v=state.v)

    def _update_chunk(self, g, m, v, p, scale, bc1, bc2, lr) -> None:
        b1, b2 = self.b1, self.b2
        # a clipped gradient is f32, as the JAX package's product of a
        # bf16 leaf with its f32 scale is
        g32 = g.float() if scale is None else g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        del g32
        m.copy_(m_new)
        v.copy_(v_new)
        delta = (m_new / bc1).div_(torch.sqrt(v_new / bc2).add_(self.eps))
        del m_new, v_new
        p32 = p.float()
        delta.add_(self.weight_decay * p32)
        p.copy_(p32.sub_(lr * delta))


def _zeros_like(p, dtype):
    """Zeros shaped (and, for a DTensor, sharded) like ``p``."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a tensor the update writes in place."""
    if not t.is_contiguous():
        raise ValueError("AdamW updates contiguous tensors in place")
    return t.view(-1)


def cosine_schedule(peak: float, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)

    return lr
