"""Batched JOIN distinct-key overlap, one launch per (table, key column).

Evaluates **Q build summaries x P probe partitions**: hit[q, p] is 1 iff
some distinct build key of query q lies inside partition p's resident
[pmin, pmax] key interval (core/device_stats.py ``join_key_plane``).
Keys are [Q, Db] f32 rows, sorted, +inf padded (``ops.pack_distinct``).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/join_overlap_batched.cu`` (built at first use, see ``build.py``);
on a CPU tensor it runs the plain PyTorch version
(``ref.join_overlap_batched_ref``, slabbed over P).  There is no
fallback between the two: a CUDA input either launches the kernel or
raises ``KernelError``, as does any input the kernel does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import join_overlap_batched_ref

KERNEL = "join_overlap_batched"


def join_overlap_batched(
    dist: torch.Tensor,      # [Q, Db] f32 sorted distinct keys, +inf padded
    pmin: torch.Tensor,      # [Pc] f32 resident key-column minima (widened)
    pmax: torch.Tensor,      # [Pc] f32 resident key-column maxima (widened)
    num_partitions: Optional[int] = None,   # logical P <= Pc (default Pc)
) -> torch.Tensor:
    """Returns hit [Q, P] int8 in {0, 1} on the plane's device."""
    if dist.dim() != 2 or pmin.dim() != 1:
        raise KernelError("keys must be [Q, Db] and the plane rows [Pc]")
    Q, Db = dist.shape
    Pc = int(pmin.shape[0])
    P = Pc if num_partitions is None else int(num_partitions)
    if not 0 <= P <= Pc:
        raise KernelError(f"num_partitions {P} outside [0, {Pc}]")
    if Db < 1:
        raise KernelError("a key row needs at least one slot")
    dev = pmin.device
    for name, t, shape in (("dist", dist, (Q, Db)), ("pmin", pmin, (Pc,)),
                           ("pmax", pmax, (Pc,))):
        check_tensor(name, t, torch.float32, shape, dev)
    if not build.runs_kernel(dev):
        return join_overlap_batched_ref(dist, pmin, pmax, num_partitions=P)
    hit = torch.empty((Q, P), dtype=torch.int8, device=dev)
    if Q == 0 or P == 0:
        return hit
    build.launch(KERNEL, dev, dist, pmin, pmax, hit, Q, Db, P)
    join_overlap_batched.launches += 1
    return hit


# launches of the CUDA kernel (CPU calls of the plain version not counted)
join_overlap_batched.launches = 0
