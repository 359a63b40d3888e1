"""Multi-query conjunctive-range pruning, one launch per table group.

Evaluates **Q queries x Kb constraints x P partitions** against a table's
resident ``[C, Pc]`` f32 metadata planes (core/device_stats.py): tv[q, p]
is 0 (NO) when a constraint's range misses the partition interval or the
interval is empty, 2 (FULL) when every constraint contains it and its
demote flag is 0, else 1 (PARTIAL); ``(-inf, +inf)`` slots are padding.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/minmax_prune_batched.cu`` (built at first use, see ``build.py``);
on a CPU tensor it runs the plain PyTorch version
(``ref.minmax_prune_batched_ref``) over column slabs, so CPU memory stays
bounded at any P.  There is no fallback between the two: a CUDA input
either launches the kernel or raises ``KernelError``, as does any input
the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .build import KernelError
from .ref import minmax_prune_batched_ref

KERNEL = "minmax_prune_batched"
# Queries per block.  The kernel stages a block's (cid, lo, hi) slots
# through a 2048-slot shared-memory tile (kSlots in the .cu), in chunks
# when there are more; up to 2048 slots a block stages them all at once.
MAX_BLOCK_SLOTS = 2048
BLOCK_Q = 32
# Peak elements per [Q, P_slab] intermediate of the plain version on the
# CPU; keeps it memory-bounded for huge P.
_REF_SLAB_ELEMS = 1 << 25

_fn = None


def load_kernel():
    """Build (first use) and bind the kernel's C entry point."""
    global _fn
    if _fn is None:
        fn = build.load(KERNEL).minmax_prune_batched_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def block_q(kb: int) -> int:
    return max(1, min(BLOCK_Q, MAX_BLOCK_SLOTS // max(kb, 1)))


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise KernelError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise KernelError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name} must have shape {tuple(shape)}, "
                          f"got {tuple(t.shape)}")
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise KernelError(f"{name} must be contiguous")


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
    """Returns tv [Q, P] int8 in {0, 1, 2} on the planes' device."""
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
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return _plain_slabbed(cids, lo, hi, mins, maxs, demote, P)
    if dev.type != "cuda":
        raise KernelError(f"unsupported device {dev}")
    if max(Q, Kb, C, Pc) >= 2 ** 31:
        raise KernelError("dimensions must fit in int32")
    fn = load_kernel()
    tv = torch.empty((Q, P), dtype=torch.int8, device=dev)
    if Q == 0 or P == 0:
        return tv                       # nothing to launch
    if Kb == 0:
        return tv.fill_(2)              # empty conjunction: all FULL
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cids.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 mins.data_ptr(), maxs.data_ptr(), demote.data_ptr(),
                 tv.data_ptr(), Q, Kb, P, Pc, block_q(Kb), stream)
    if err != 0:
        raise KernelError(f"{KERNEL} launch failed: cudaError {err}")
    minmax_prune_batched.launches += 1
    return tv


# launches of the CUDA kernel (CPU calls of the plain version not counted)
minmax_prune_batched.launches = 0
