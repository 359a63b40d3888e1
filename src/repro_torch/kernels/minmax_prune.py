"""Single-query conjunctive-range pruning over pre-gathered stats.

Evaluates **one conjunction of K closed ranges x P partitions** against
``[K, P]`` f32 stat rows that the caller gathered for the query's
constraints (``ops.stage_ranges``): tv[p] is 0 (NO) when a range misses
the partition interval or the interval is empty, 2 (FULL) when every
range contains it and its nullable flag is 0, else 1 (PARTIAL).  Every
row is a real constraint; there is no padding slot.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/minmax_prune.cu`` (built at first use, see ``build.py``); on a CPU
tensor it runs the plain PyTorch version (``ref.minmax_prune_ref``).
There is no fallback between the two: a CUDA input either launches the
kernel or raises ``KernelError``, as does any input the kernel does not
take.
"""

from __future__ import annotations

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import minmax_prune_ref

KERNEL = "minmax_prune"


def minmax_prune(
    lo: torch.Tensor,        # [K] f32 range lows  (inclusive)
    hi: torch.Tensor,        # [K] f32 range highs (inclusive)
    mins: torch.Tensor,      # [K, P] f32 per-constraint partition minima
    maxs: torch.Tensor,      # [K, P] f32 per-constraint partition maxima
    nullable: torch.Tensor,  # [K, P] f32 1.0 where FULL must be suppressed
) -> torch.Tensor:
    """Returns tv [P] int32 in {0, 1, 2} on the stats' device."""
    if mins.dim() != 2 or lo.dim() != 1:
        raise KernelError("stats must be [K, P] and bounds [K]")
    K, P = mins.shape
    dev = mins.device
    for name, t, shape in (("lo", lo, (K,)), ("hi", hi, (K,)),
                           ("mins", mins, (K, P)), ("maxs", maxs, (K, P)),
                           ("nullable", nullable, (K, P))):
        check_tensor(name, t, torch.float32, shape, dev)
    if not build.runs_kernel(dev):
        return minmax_prune_ref(lo, hi, mins, maxs, nullable)
    return launch_checked(lo, hi, mins, maxs, nullable)


def launch_checked(lo: torch.Tensor, hi: torch.Tensor, mins: torch.Tensor,
                   maxs: torch.Tensor, nullable: torch.Tensor) -> torch.Tensor:
    """The kernel's launch alone, on CUDA inputs that ``minmax_prune`` has
    checked: tv [P].  ``chip_smoke.py`` times this beside the wrapper."""
    K, P = mins.shape
    tv = torch.empty(P, dtype=torch.int32, device=mins.device)
    if P == 0:
        return tv                       # nothing to launch
    if K == 0:
        return tv.fill_(2)              # empty conjunction: all FULL
    build.launch(KERNEL, mins.device, lo, hi, mins, maxs, nullable, tv, K, P)
    minmax_prune.launches += 1
    return tv


# launches of the CUDA kernel (CPU calls of the plain version not counted)
minmax_prune.launches = 0
