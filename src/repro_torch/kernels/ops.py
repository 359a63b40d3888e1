"""Wrappers wiring the kernels into the pruning engine.

Host-side NumPy metadata is staged to torch tensors here; the core engine
(core/*) stays NumPy-pure so compile-time pruning never touches a device.
Two staging regimes coexist.

Per-query paths: one query's inputs are gathered from the host
``PartitionStats`` (or its ordered block-top-k rows) and staged for one
launch of a single-query kernel.  Simple, but every query pays a host
gather and cast, an H2D copy and a launch -- fine for one-off queries,
wrong for a workload:

  * filter (``prune_ranges_device``): the ``[K, P]`` stat rows of the
    query's constraints (``stage_ranges``), ``minmax_prune``;
  * JOIN (``join_overlap_device``): the key column's [P] intervals
    against the build side's sorted distinct keys, ``join_overlap``;
  * top-k (``topk_boundary_device``): the sequential boundary scan over
    ordered block-top-k rows, ``topk_boundary`` (or the plain prefix-merge
    formulation, ``mode="prefix"``).

Each takes the device explicitly: ``None`` is the GPU (raising without
one), ``"cpu"`` runs the plain versions.

Resident + batched paths: a table's planes live on the device in a
``core.device_stats.DeviceStatsCache`` (staged once per table version)
and a *batch* of queries is packed into one launch per table group.
``serve.prune_service.PruningService`` groups a workload and drives them:

  * filter (``prune_ranges_batched_device``): ``[Q, Kb]`` constraint
    tables (Kb a power-of-two bucket, ``(-inf, +inf)`` no-op padding)
    against the ``[C, P]`` stat planes, ``minmax_prune_batched``;
  * JOIN, distinct summaries (``join_overlap_batched_device``): ``[Q, Db]``
    sorted key rows against the join-key plane, ``join_overlap_batched``;
  * JOIN, Bloom summaries (``bloom_probe_batched_device``): ``[Q, Bb*16]``
    filter words against the enumeration plane, ``bloom_probe_batched``;
  * top-k (``topk_init_batched_device``): per-query candidate partitions
    (CSR) against the block-top-k plane, ``topk_init_batched``.

Kernel modes: ``auto`` dispatches on the planes' device (CUDA tensors
launch the kernel, CPU tensors run the plain torch version; the choice is
the wrapper's), ``cuda`` requires CUDA planes and ``torch`` requires CPU
planes; each raises on the other device.  The host rung
(``prune_ranges_batched_host``) stays NumPy f64.  ``topk_boundary_device``
also takes ``prefix``, the plain prefix-merge formulation on either
device (the JAX package has no Pallas kernel for it).

LM serving: ``flash_attention`` (``kernels/flash_attention.py``) is the
attention of the model's prefill, reached through
``models.layers.chunked_attention`` with q, k, v as [B*H, S, D].

All f32 downcasts go through ``core.device_stats`` (widening + demotion;
see its precision contract).  Integral columns (int / dictionary codes)
get their query bounds snapped to integers first, so the f32 path stays
exactly equal to the f64 host oracle on the paper's workloads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device_stats import (DeviceStats, cast_bounds_f32,
                                 cast_stats_f32, resolve_device,
                                 round_down_f32, round_up_f32,
                                 snap_bounds_integral)
from ..core.metadata import PartitionStats
from ..core.prune_join import BLOCK_WORDS
from .bloom_probe import bloom_probe_batched
from .build import KernelError, load_all
from .flash_attention import flash_attention
from .join_overlap import join_overlap, join_overlap_batched
from .minmax_prune import minmax_prune
from .minmax_prune_batched import minmax_prune_batched
from .ref import topk_boundary_prefix_ref
from .topk_boundary import topk_boundary, topk_init_batched

# the port's kernels (csrc/<name>.cu): the batched ones in the order of
# the pipeline's stages, then the per-query ones, then the LM prefill's
KERNELS = ("minmax_prune_batched", "join_overlap_batched",
           "bloom_probe_batched", "topk_init_batched",
           "minmax_prune", "join_overlap", "topk_boundary",
           "flash_attention")

MODES = ("auto", "cuda", "torch")
TOPK_MODES = MODES + ("prefix",)

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


def d_bucket(d: int) -> int:
    """Distinct-key-count bucket: next power of two >= max(d, 8).

    Batched join overlap pads each query's distinct list up to the bucket
    with +inf no-op keys — the same scheme as ``k_bucket`` for constraint
    counts.
    """
    return _pow2_at_least(max(d, 1), floor=8)


def bloom_bucket(n_blocks: int) -> int:
    """Bloom block-count bucket: next power of two >= max(n_blocks, 8).

    Filters are *tiled* (not zero-padded) up to the bucket — block
    selection is ``h & (blocks - 1)``, so a periodically repeated filter
    probes identical words under the larger mask (see pack_blooms).
    """
    return _pow2_at_least(max(n_blocks, 1), floor=8)


# Cap on blocks per Bloom filter on the batched path (64 KB of words):
# bigger filters (build NDV > ~32k at 16 bits/key) keep the host matcher,
# counted per technique, as in the reference engine.
BLOOM_MAX_BLOCKS = 1024


def load_kernels() -> None:
    """Build every kernel of the port (one ``nvcc`` per source, all
    started together) and bind their C entry points."""
    load_all(KERNELS)


def check_mode(mode: str, device: torch.device) -> None:
    """Raise unless ``mode`` may run on ``device``."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; have {MODES}")
    if mode == "cuda" and device.type != "cuda":
        raise ValueError(f"mode 'cuda' needs CUDA planes, got {device}")
    if mode == "torch" and device.type != "cpu":
        raise ValueError(f"mode 'torch' runs on the CPU, got {device}")


# ---------------------------------------------------------------------------
# Per-query staging (single-launch path)
# ---------------------------------------------------------------------------

def _stage_ranges(ranges, stats: PartitionStats, device: torch.device):
    """One staging pass: kernel inputs + whether FULL is provable.

    Returns ((lo, hi, mins, maxs, demote) tensors on ``device``,
    full_safe bool).  The f32 downcast is centralized in core.device_stats:
    stat intervals are widened (mins down, maxs up) and partitions whose
    cast was inexact are FULL-demoted via the nullable/demote rows
    (``null_counts > 0 | inexact``); full_safe is False when any query
    bound's own cast was inexact.
    """
    cids = np.array([c for c, _, _ in ranges], dtype=np.int64)
    lo64 = np.array([l for _, l, _ in ranges], dtype=np.float64)
    hi64 = np.array([h for _, _, h in ranges], dtype=np.float64)
    integral = np.array([c.kind != "float" for c in stats.columns], dtype=bool)
    lo64, hi64 = snap_bounds_integral(lo64, hi64, integral[cids])
    lo32, hi32, exact = cast_bounds_f32(lo64, hi64)
    mins32, maxs32, inexact = cast_stats_f32(stats.mins.T[cids],
                                             stats.maxs.T[cids])
    demote = ((stats.null_counts.T[cids] > 0) | inexact).astype(np.float32)
    staged = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (lo32, hi32, mins32, maxs32, demote))
    return staged, bool(exact.all())


def stage_ranges(
    ranges: List[Tuple[int, float, float]],
    stats: PartitionStats,
    device=None,
):
    """Gather per-constraint stat rows into the kernel's [K, P] layout:
    (lo [K], hi [K], mins, maxs, demote [K, P]) f32 tensors on ``device``
    (None: the GPU)."""
    staged, _ = _stage_ranges(ranges, stats, resolve_device(device))
    return staged


def prune_ranges_device(
    ranges: List[Tuple[int, float, float]],
    stats: PartitionStats,
    mode: str = "auto",          # 'auto' | 'cuda' | 'torch'
    device=None,
) -> np.ndarray:
    """Three-valued conjunctive-range pruning of one query; returns tv [P]
    (int32 from the kernel).  Equal, row for row, to
    ``prune_ranges_batched_device``'s row for the same ranges."""
    dev = resolve_device(device)
    check_mode(mode, dev)
    if not ranges:   # empty conjunction == TruePred: everything FULL
        return np.full(stats.num_partitions, 2, dtype=np.int8)
    (lo, hi, mins, maxs, nullable), full_safe = _stage_ranges(ranges, stats,
                                                              dev)
    tv = _read_back(minmax_prune(lo, hi, mins, maxs, nullable),
                    "minmax_prune")
    if not full_safe:
        tv = np.minimum(tv, 1)   # inexact f32 bounds: FULL is not provable
    return tv


# ---------------------------------------------------------------------------
# Batched multi-query path (resident metadata plane)
# ---------------------------------------------------------------------------

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


def _read_back(t: torch.Tensor, kernel: str) -> np.ndarray:
    """The host copy of a kernel's output.  The first sync after a launch:
    a fault the kernel raised on the card surfaces here, and must not pass
    for a degradation."""
    try:
        return t.cpu().numpy()
    except RuntimeError as exc:
        raise KernelError(f"reading back {kernel}: {exc}") from exc


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
    tv = _read_back(tv_d, "minmax_prune_batched")
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


# ---------------------------------------------------------------------------
# Runtime techniques: JOIN (distinct keys, Bloom filters) and top-k
# ---------------------------------------------------------------------------

def build_block_topk(
    values: np.ndarray,
    part_bounds: np.ndarray,
    k: int,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-partition block top-k table [P, k] (desc, -inf padded).

    The metadata sketch the top-k boundary init consumes; masked-out rows
    (filter misses, nulls) are excluded.  Segmented formulation: one
    lexsort by (partition, -value) then a rank-within-partition select —
    O(N log N) total with no Python loop over P.

    part_bounds must be non-decreasing row offsets (they are cumulative
    by construction everywhere in the engine).  NaN values are dropped
    (a NaN in a sketch row would corrupt the boundary comparisons).
    """
    part_bounds = np.asarray(part_bounds)
    if np.any(np.diff(part_bounds) < 0):
        raise ValueError("part_bounds must be non-decreasing row offsets")
    P = len(part_bounds) - 1
    out = np.full((P, k), -np.inf, dtype=np.float32)
    values = np.asarray(values)
    # Clamp like the slice values[s:e] would: bounds may overrun values.
    cb = np.clip(part_bounds, 0, len(values))
    lo_row, hi_row = int(cb[0]), int(cb[-1])
    # Widen, don't round-to-nearest: a plane value must never understate
    # the block's potential, or the boundary test could skip a match.
    vals = round_up_f32(values[lo_row:hi_row])
    pid = np.repeat(np.arange(P), np.diff(cb))
    if mask is not None:
        sel = np.asarray(mask, dtype=bool)[lo_row:hi_row]
        vals = vals[sel]
        pid = pid[sel]
    finite = ~np.isnan(vals)
    if not finite.all():
        vals = vals[finite]
        pid = pid[finite]
    if vals.size == 0:
        return out
    order = np.lexsort((-vals, pid))        # partition-major, value desc
    pid_s = pid[order]
    vals_s = vals[order]
    starts = np.searchsorted(pid_s, np.arange(P), side="left")
    rank = np.arange(len(vals_s)) - starts[pid_s]
    keep = rank < k
    out[pid_s[keep], rank[keep]] = vals_s[keep]
    return out


def topk_boundary_device(
    rows: np.ndarray,
    b_init: float = -np.inf,
    mode: str = "auto",          # 'auto' | 'cuda' | 'torch' | 'prefix'
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(skip [P] int32, heap [k] f32) for pre-ordered block top-k rows.

    The upfront boundary is rounded down to f32 on every route, so a
    narrowed ``b_init`` can never skip a block the f64 boundary would have
    kept, and a CPU run and a card run agree on every input.  ``prefix``
    runs the plain prefix-merge formulation on ``device``: the same heap,
    and with a witnessed ``b_init`` a superset of the sequential skips.
    """
    dev = resolve_device(device)
    if mode not in TOPK_MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; have {TOPK_MODES}")
    if mode != "prefix":
        check_mode(mode, dev)
    rows_t = torch.from_numpy(
        np.ascontiguousarray(rows, dtype=np.float32)).to(dev)
    b32 = float(round_down_f32(b_init))
    if mode == "prefix":
        skip, heap = topk_boundary_prefix_ref(rows_t, b32)
    else:
        skip, heap = topk_boundary(rows_t, b32)
    return _read_back(skip, "topk_boundary"), _read_back(heap, "topk_boundary")


def _stage_join(stats: PartitionStats, key_col: str, distinct: np.ndarray,
                device: torch.device):
    """The join kernel's inputs on ``device``: (pmin [P], pmax [P],
    distinct [D]) f32, the key column's intervals widened (min down, max
    up) and the keys cast round-to-nearest."""
    pmin = round_down_f32(stats.col_min(key_col))
    pmax = round_up_f32(stats.col_max(key_col))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                 .to(device) for a in (pmin, pmax, distinct))


def join_overlap_device(
    stats: PartitionStats,
    key_col: str,
    distinct: np.ndarray,
    mode: str = "auto",
    device=None,
) -> np.ndarray:
    """hit [P] int32: 1 where a build key may live in the partition.

    The key column's intervals are widened (min down, max up) and the keys
    cast round-to-nearest, which is monotone: a key inside a partition's
    f64 range stays inside its widened f32 one, and a sorted list stays
    sorted."""
    dev = resolve_device(device)
    check_mode(mode, dev)
    return _read_back(join_overlap(*_stage_join(stats, key_col, distinct,
                                                dev)), "join_overlap")


def pack_distinct(distinct_lists: Sequence[np.ndarray]) -> np.ndarray:
    """Pack per-query sorted distinct keys into the [Q, Db] kernel layout.

    Db is the power-of-two ``d_bucket``; padding is +inf — sorted last
    and, against the finite join-key plane, never inside a range.  The
    f32 key cast rounds to nearest, which is monotone: sorted keys stay
    sorted and a key inside a partition's f64 range stays inside its
    widened f32 one.
    """
    Q = len(distinct_lists)
    Db = d_bucket(max((len(d) for d in distinct_lists), default=1))
    dist = np.full((Q, Db), np.inf, dtype=np.float32)
    for qi, d in enumerate(distinct_lists):
        dist[qi, : len(d)] = np.asarray(d, dtype=np.float32)
    return dist


def join_overlap_batched_device(
    distinct_lists: Sequence[np.ndarray],
    pmin: torch.Tensor,      # [Pc] resident f32 key-column minima (widened)
    pmax: torch.Tensor,      # [Pc] resident f32 key-column maxima (widened)
    num_partitions: int,     # logical P of the plane
    mode: str = "auto",
) -> np.ndarray:
    """hit [Q, P] int8 — Q build summaries vs the resident key plane, one
    launch for the whole table group.  The device path can keep extra
    partitions (widened intervals) but never prunes a partition holding a
    joinable key."""
    dev = pmin.device
    check_mode(mode, dev)
    dist = torch.from_numpy(pack_distinct(distinct_lists)).to(dev)
    hit = join_overlap_batched(dist, pmin, pmax,
                               num_partitions=num_partitions)
    return _read_back(hit, "join_overlap_batched")


def pack_blooms(blooms: Sequence) -> np.ndarray:
    """Pack Q blocked-Bloom filters into the kernel's [Q, Bb * 16] layout.

    Each row holds a filter's uint32 words (as int32 bits), word index
    ``block * 16 + w``, tiled periodically up to the common power-of-two
    Bb bucket: block selection is ``h & (n_blocks - 1)``, and
    ``tiled[h & (Bb - 1)] == words[h & (nb - 1)]`` for any pow-2 multiple
    Bb, so every query in a launch shares one block mask.
    """
    Q = len(blooms)
    Bb = bloom_bucket(max((b.n_blocks for b in blooms), default=1))
    out = np.zeros((Q, Bb * BLOCK_WORDS), dtype=np.uint32)
    for qi, b in enumerate(blooms):
        out[qi] = np.tile(b.words, Bb // b.n_blocks)
    return out.view(np.int32)


def bloom_probe_batched_device(
    blooms: Sequence,        # Q core.prune_join.BlockedBloom filters
    pmin: torch.Tensor,      # [Pc] int32 resident enumeration minima
    width: torch.Tensor,     # [Pc] int32 resident candidate counts (0=keep)
    enum_limit: int,
    num_partitions: int,     # logical P of the plane
    mode: str = "auto",
) -> np.ndarray:
    """hit [Q, P] int8 — Q Bloom summaries vs the resident enumeration
    plane; row q equals the host matcher's narrow-range enumeration for
    query q's filter (hit 0 only where 0 < width <= enum_limit and no
    candidate value is in the filter)."""
    dev = pmin.device
    check_mode(mode, dev)
    words = torch.from_numpy(pack_blooms(blooms)).to(dev)
    # partitions wider than the enumeration limit are kept, never probed
    width_eff = torch.where(width <= int(enum_limit), width,
                            torch.zeros_like(width))
    hit = bloom_probe_batched(words, pmin, width_eff,
                              num_partitions=num_partitions)
    return _read_back(hit, "bloom_probe_batched")


def pack_candidates(candidate_lists: Sequence[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of per-query candidate partition ids: (offsets int64 [Q + 1],
    ids int32 [nnz])."""
    counts = np.array([len(c) for c in candidate_lists], dtype=np.int64)
    offsets = np.zeros(len(candidate_lists) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = (np.concatenate([np.asarray(c, dtype=np.int32)
                           for c in candidate_lists])
           if len(candidate_lists) else np.zeros(0, dtype=np.int32))
    return offsets, ids


def topk_init_batched_device(
    plane: torch.Tensor,     # [Pc, K] resident block-top-k rows (signed f32)
    candidate_lists: Sequence[np.ndarray],   # per query: candidate ids
    k: int,
    mode: str = "auto",
) -> np.ndarray:
    """heap [Q, k] f32 — per-query top-k over its candidates' resident
    plane rows.  Query q's Sec. 5.4 upfront boundary for any effective
    kq <= k is ``heap[q, kq - 1]`` (-inf when fewer than kq values exist).
    """
    dev = plane.device
    check_mode(mode, dev)
    offsets, ids = pack_candidates(candidate_lists)
    heap = topk_init_batched(plane, torch.from_numpy(offsets).to(dev),
                             torch.from_numpy(ids).to(dev), k)
    return _read_back(heap, "topk_init_batched")
