"""Multi-query conjunctive-range pruning, one launch per table group.

Evaluates **Q queries x Kb constraints x P partitions** against a table's
resident ``[C, Pc]`` f32 metadata planes (core/device_stats.py): tv[q, p]
is 0 (NO) when a constraint's range misses the partition interval or the
interval is empty, 2 (FULL) when every constraint contains it and its
demote flag is 0, else 1 (PARTIAL); ``(-inf, +inf)`` slots are padding.

The planes may be a column block of wider resident planes (a partition
shard, ``ops.prune_ranges_batched_device`` with a mesh): the kernel reads
row c at ``c * stride``, so the block is passed as a view with the wider
planes' row stride, never copied.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/minmax_prune_batched.cu`` (built at first use, see ``build.py``);
on a CPU tensor it runs the plain PyTorch version
(``ref.minmax_prune_batched_ref``) over column slabs, so CPU memory stays
bounded at any P.  There is no fallback between the two: a CUDA input
either launches the kernel or raises ``KernelError``, as does any input
the kernel does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import minmax_prune_batched_ref

KERNEL = "minmax_prune_batched"
# Peak elements per [Q, P_slab] intermediate of the plain version on the
# CPU; keeps it memory-bounded for huge P.
_REF_SLAB_ELEMS = 1 << 25


def _plain_slabbed(cids, lo, hi, mins, maxs, demote, P: int) -> torch.Tensor:
    """The plain version over [Q, slab] column slabs (bounded memory)."""
    Q = int(lo.shape[0])
    slab = max(1024, _REF_SLAB_ELEMS // max(Q, 1))
    tv = torch.empty((Q, P), dtype=torch.int8)
    for s in range(0, P, slab):
        e = min(s + slab, P)
        tv[:, s:e] = minmax_prune_batched_ref(
            cids, lo, hi, mins[:, s:e], maxs[:, s:e], demote[:, s:e])
    return tv


def minmax_prune_batched(
    cids: torch.Tensor,      # [Q, Kb] int32 constraint column ids
    lo: torch.Tensor,        # [Q, Kb] f32 range lows  (inclusive; -inf pad)
    hi: torch.Tensor,        # [Q, Kb] f32 range highs (inclusive; +inf pad)
    mins: torch.Tensor,      # [C, Pc] f32 resident partition minima (widened)
    maxs: torch.Tensor,      # [C, Pc] f32 resident partition maxima (widened)
    demote: torch.Tensor,    # [C, Pc] f32 1.0 where FULL must be suppressed
    num_partitions: Optional[int] = None,   # logical P <= Pc (default Pc)
) -> torch.Tensor:
    """Returns tv [Q, P] int8 in {0, 1, 2} on the planes' device.  The
    three planes are contiguous or column blocks of one row stride."""
    if mins.dim() != 2 or lo.dim() != 2:
        raise KernelError("planes must be [C, Pc] and constraints [Q, Kb]")
    Q, Kb = lo.shape
    C, Pc = mins.shape
    P = Pc if num_partitions is None else int(num_partitions)
    if not 0 <= P <= Pc:
        raise KernelError(f"num_partitions {P} outside [0, {Pc}]")
    dev = mins.device
    for name, t, dtype, shape in (
            ("cids", cids, torch.int32, (Q, Kb)),
            ("lo", lo, torch.float32, (Q, Kb)),
            ("hi", hi, torch.float32, (Q, Kb)),
            ("mins", mins, torch.float32, (C, Pc)),
            ("maxs", maxs, torch.float32, (C, Pc)),
            ("demote", demote, torch.float32, (C, Pc))):
        check_tensor(name, t, dtype, shape, dev, rows=name in
                     ("mins", "maxs", "demote"))
    stride = int(mins.stride(0)) if C > 1 else Pc
    if C > 1 and (maxs.stride(0) != stride or demote.stride(0) != stride
                  or stride < Pc):
        raise KernelError(f"planes must share one row stride >= {Pc}, got "
                          f"{(mins.stride(0), maxs.stride(0), demote.stride(0))}")
    if not build.runs_kernel(dev):
        return _plain_slabbed(cids, lo, hi, mins, maxs, demote, P)
    tv = torch.empty((Q, P), dtype=torch.int8, device=dev)
    if Q == 0 or P == 0:
        return tv                       # nothing to launch
    if Kb == 0:
        return tv.fill_(2)              # empty conjunction: all FULL
    build.launch(KERNEL, dev, cids, lo, hi, mins, maxs, demote, tv,
                 Q, Kb, P, stride, C)
    minmax_prune_batched.launches += 1
    return tv


# launches of the CUDA kernel (CPU calls of the plain version not counted)
minmax_prune_batched.launches = 0
