"""Wrappers wiring the batched kernel into the pruning engine.

Host-side NumPy metadata is staged to torch tensors here; the core engine
(core/*) stays NumPy-pure so compile-time pruning never touches a device.

Resident + batched path (``prune_ranges_batched_device``): the table's
full ``[C, P]`` planes live on the device in a
``core.device_stats.DeviceStatsCache`` (staged once per table version); a
*batch* of queries is packed into ``[Q, Kb]`` constraint tables (Kb a
power-of-two bucket, ``(-inf, +inf)`` no-op padding) and evaluated by
``minmax_prune_batched`` in one launch.  ``serve.prune_service
.PruningService`` groups a workload by table and drives this path.

Kernel modes: ``auto`` dispatches on the planes' device (CUDA tensors
launch the kernel, CPU tensors run the plain torch version; the choice is
the wrapper's), ``cuda`` requires CUDA planes and ``torch`` requires CPU
planes; each raises on the other device.  The host rung (``prune_ranges_batched_host``) stays
NumPy f64.

All f32 downcasts go through ``core.device_stats`` (widening + demotion;
see its precision contract).  Integral columns (int / dictionary codes)
get their query bounds snapped to integers first, so the f32 path stays
exactly equal to the f64 host oracle on the paper's workloads.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.device_stats import (DeviceStats, cast_bounds_f32,
                                 snap_bounds_integral)
from ..core.metadata import PartitionStats
from .build import KernelError
from .minmax_prune_batched import minmax_prune_batched

MODES = ("auto", "cuda", "torch")

# Query-row floor of ``q_bucket``: the packed tables keep the reference's
# power-of-two query buckets (8 rows minimum), so both packages pack
# identical [Qb, Kb] tables.
BLOCK_Q = 8


def _pow2_at_least(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def k_bucket(k: int) -> int:
    """Constraint-count bucket: next power of two >= max(k, 1).

    Batches are padded up to the bucket with no-op ranges so the kernel
    sees a handful of Kb values.
    """
    return _pow2_at_least(max(k, 1))


def q_bucket(q: int) -> int:
    """Query-count bucket: next power of two >= max(q, BLOCK_Q)."""
    return _pow2_at_least(max(q, 1), floor=BLOCK_Q)


def check_mode(mode: str, device: torch.device) -> None:
    """Raise unless ``mode`` may run on ``device``."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; have {MODES}")
    if mode == "cuda" and device.type != "cuda":
        raise ValueError(f"mode 'cuda' needs CUDA planes, got {device}")
    if mode == "torch" and device.type != "cpu":
        raise ValueError(f"mode 'torch' runs on the CPU, got {device}")


def pack_ranges(
    range_lists: Sequence[List[Tuple[int, float, float]]],
    dstats: DeviceStats,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-query constraint lists into [Qb, Kb] kernel inputs.

    Returns (cids int32, lo f32, hi f32, full_safe bool[Q]).  Constraint
    slots beyond a query's K and query rows beyond Q are ``(-inf, +inf)``
    no-ops; Kb/Qb are power-of-two buckets.
    """
    Q = len(range_lists)
    Kb = k_bucket(max((len(r) for r in range_lists), default=1))
    Qb = q_bucket(Q)
    cids = np.zeros((Qb, Kb), dtype=np.int32)
    valid = np.zeros((Qb, Kb), dtype=bool)
    lo64 = np.full((Qb, Kb), -np.inf, dtype=np.float64)
    hi64 = np.full((Qb, Kb), np.inf, dtype=np.float64)
    for qi, ranges in enumerate(range_lists):
        for ki, (cid, lo_v, hi_v) in enumerate(ranges):
            cids[qi, ki] = cid
            valid[qi, ki] = True
            lo64[qi, ki] = lo_v
            hi64[qi, ki] = hi_v
    lo64, hi64 = snap_bounds_integral(lo64, hi64, dstats.integral[cids])
    lo32, hi32, exact = cast_bounds_f32(lo64, hi64)
    # cast_bounds_f32 clamps to finite f32; re-impose the (-inf, +inf)
    # sentinel on padding slots so the kernel's no-op detection fires.
    lo32 = np.where(valid, lo32, np.float32(-np.inf))
    hi32 = np.where(valid, hi32, np.float32(np.inf))
    full_safe = (exact | ~valid).all(axis=1)[:Q]
    return cids, lo32, hi32, full_safe


def prune_ranges_batched_device(
    range_lists: Sequence[List[Tuple[int, float, float]]],
    dstats: DeviceStats,
    mode: str = "auto",          # 'auto' | 'cuda' | 'torch'
) -> np.ndarray:
    """Evaluate Q queries' conjunctive ranges in one batched launch.

    Returns tv ``[Q, P]`` int8 (host) — row q is identical to the f64 host
    oracle on int/dictionary workloads (bounds snap to integers and cast
    exactly).  Bounds that are inexact in f32 demote FULL to PARTIAL —
    never a false NO_MATCH or false FULL (core.device_stats precision
    contract).
    """
    Q = len(range_lists)
    # one consistent snapshot of (planes, logical P)
    planes, P = dstats.planes_state
    mins, maxs, demote = planes
    dev = mins.device
    check_mode(mode, dev)
    cids, lo, hi, full_safe = pack_ranges(range_lists, dstats)
    # the padded query rows of the bucket are no-ops: launch the Q real ones
    cids_d = torch.from_numpy(np.ascontiguousarray(cids[:Q])).to(dev)
    lo_d = torch.from_numpy(np.ascontiguousarray(lo[:Q])).to(dev)
    hi_d = torch.from_numpy(np.ascontiguousarray(hi[:Q])).to(dev)
    tv_d = minmax_prune_batched(cids_d, lo_d, hi_d, mins, maxs, demote,
                                num_partitions=P)
    try:
        tv = tv_d.cpu().numpy()
    except RuntimeError as exc:
        # the first sync after the launch: a fault the kernel raised on
        # the card surfaces here, and must not pass for a degradation
        raise KernelError(f"reading back minmax_prune_batched: {exc}") \
            from exc
    if not full_safe.all():
        tv[~full_safe] = np.minimum(tv[~full_safe], 1)
    return tv


def prune_ranges_batched_host(
    range_lists: Sequence[List[Tuple[int, float, float]]],
    stats: PartitionStats,
) -> np.ndarray:
    """Pure-numpy host fallback for the batched range kernel.

    The degradation ladder's host rung: same ``[Q, P]`` int8 verdict
    contract as ``prune_ranges_batched_device`` but evaluated directly on
    the host f64 stats — no device, no staged planes, no f32 cast, so it
    is bit-identical to the per-query ``eval_tv`` host oracle on every
    predicate whose ranges lowered (the closed-interval semantics: NO when
    the partition interval misses [lo, hi], FULL when it sits inside with
    no nulls, PARTIAL otherwise; constraints AND via min).  An empty range
    list is the TruePred lowering: everything FULL.
    """
    P = stats.num_partitions
    tv = np.full((len(range_lists), P), 2, dtype=np.int8)
    mins, maxs = stats.mins, stats.maxs            # [P, C] float64
    has_nulls = stats.null_counts > 0
    for qi, ranges in enumerate(range_lists):
        row = np.full(P, 2, dtype=np.int8)
        for cid, lo, hi in ranges:
            pmin, pmax = mins[:, cid], maxs[:, cid]
            no = (pmax < lo) | (pmin > hi)
            full = (pmin >= lo) & (pmax <= hi) & ~has_nulls[:, cid]
            row = np.minimum(
                row, np.where(no, 0, np.where(full, 2, 1)).astype(np.int8))
        tv[qi] = row
    return tv
