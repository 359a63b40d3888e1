"""JOIN distinct-key overlap: batched, one launch per (table, key
column), and single-query.

``join_overlap_batched`` evaluates **Q build summaries x P probe
partitions**: hit[q, p] is 1 iff some distinct build key of query q lies
inside partition p's resident [pmin, pmax] key interval
(core/device_stats.py ``join_key_plane``).  Keys are [Q, Db] f32 rows,
sorted, +inf padded (``ops.pack_distinct``).

``join_overlap`` is the single-query form: one sorted distinct list [D]
against [P] partition intervals staged for the call
(``ops.join_overlap_device``), hit [P] int32.  Its kernel binary-searches
the list, which is right only on a sorted, NaN-free list, so the wrapper
checks that first (``check_keys``).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/join_overlap_batched.cu``, ``csrc/join_overlap.cu``, built at
first use, see ``build.py``); on a CPU tensor it runs the plain PyTorch
version (``ref.join_overlap_batched_ref``, slabbed over P;
``ref.join_overlap_ref``).  There is no fallback between the two: a CUDA
input either launches the kernel or raises ``KernelError``, as does any
input the kernel does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import join_overlap_batched_ref, join_overlap_ref

KERNEL = "join_overlap_batched"
KERNEL_SINGLE = "join_overlap"


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


def check_keys(pmin: torch.Tensor, pmax: torch.Tensor,
               distinct: torch.Tensor) -> None:
    """Raise ``KernelError`` unless ``distinct`` is sorted non-decreasing
    and no key or interval bound is NaN: a binary search is right only
    there (the TPU's brute-force compare was right on any list).  A few
    reductions and, on the card, one wait for their result."""
    bad = torch.isnan(pmin).any() | torch.isnan(pmax).any()
    if distinct.numel():
        bad = bad | torch.isnan(distinct).any() \
            | (distinct[1:] < distinct[:-1]).any()
    if bool(bad):
        raise KernelError("join keys must be sorted non-decreasing, with "
                          "no NaN key or partition bound")


def join_overlap(
    pmin: torch.Tensor,      # [P] f32 probe partition key minima (widened)
    pmax: torch.Tensor,      # [P] f32 probe partition key maxima (widened)
    distinct: torch.Tensor,  # [D] f32 sorted distinct build keys, no NaN
) -> torch.Tensor:
    """Returns hit [P] int32 in {0, 1} on the intervals' device (0: the
    partition holds no build key and can be pruned)."""
    if pmin.dim() != 1 or distinct.dim() != 1:
        raise KernelError("intervals must be [P] and keys [D]")
    P = int(pmin.shape[0])
    D = int(distinct.shape[0])
    dev = pmin.device
    for name, t, shape in (("pmin", pmin, (P,)), ("pmax", pmax, (P,)),
                           ("distinct", distinct, (D,))):
        check_tensor(name, t, torch.float32, shape, dev)
    check_keys(pmin, pmax, distinct)
    if not build.runs_kernel(dev):
        return join_overlap_ref(pmin, pmax, distinct)
    return launch_checked(pmin, pmax, distinct)


def launch_checked(pmin: torch.Tensor, pmax: torch.Tensor,
                   distinct: torch.Tensor) -> torch.Tensor:
    """The kernel's launch alone, on CUDA inputs that ``join_overlap`` has
    checked: hit [P].  ``chip_smoke.py`` times this as the kernel's
    time."""
    P = int(pmin.shape[0])
    D = int(distinct.shape[0])
    hit = torch.empty(P, dtype=torch.int32, device=pmin.device)
    if P == 0 or D == 0:
        return hit.zero_()              # no key: nothing can hit
    build.launch(KERNEL_SINGLE, pmin.device, pmin, pmax, distinct, hit, D, P)
    join_overlap.launches += 1
    return hit


# launches of the CUDA kernel (CPU calls of the plain version not counted)
join_overlap.launches = 0
