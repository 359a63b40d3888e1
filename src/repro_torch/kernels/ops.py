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
``core.device_stats.DeviceStatsCache`` (staged once, delta-synced on DML)
and a *batch* of queries is packed into one launch per table group.
``serve.prune_service.PruningService`` groups a workload and drives them:

  * filter (``prune_ranges_batched_device``): ``[Q, Kb]`` constraint
    tables (Kb a power-of-two bucket, ``(-inf, +inf)`` no-op padding)
    against the ``[C, P]`` stat planes, ``minmax_prune_batched``;
  * JOIN, the build sides' summaries (``summarize_build_batched_device``):
    G build sides' keys in one buffer, deduped and Bloom-set on the card,
    ``bloom_build`` (not a TPU kernel: the reference summarises on the
    host);
  * JOIN, distinct summaries (``join_overlap_batched_device``): ``[Q, Db]``
    sorted key rows against the join-key plane, ``join_overlap_batched``;
  * JOIN, Bloom summaries (``bloom_probe_batched_device``): ``[Q, Bb*16]``
    filter words against the enumeration plane, ``bloom_probe_batched``;
  * top-k (``topk_init_batched_device``): per-query candidate partitions
    (CSR) against the block-top-k plane, ``topk_init_batched``.

Each has a ``*_tree`` form (``prune_ranges_batched_tree`` and siblings)
that first prunes whole groups of partitions on the tree planes and
evaluates only what survives; see "Hierarchical (tree) pruning path".
Each of the eight takes ``mesh=`` (``launch.mesh.make_plane_mesh``) and
then shards the planes' partition dim over it; see "Partition-dim
sharding".

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

import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core.device_stats import (TREE_MIN_GROUPS, DeviceStats,
                                 cast_bounds_f32, cast_stats_f32,
                                 resolve_device, round_down_f32,
                                 round_up_f32, snap_bounds_integral, to_host)
from ..core.metadata import PartitionStats
from ..core.prune_join import (BLOCK_WORDS, BlockedBloom, BuildSummary,
                               summarize_build)
from . import build
from .bloom_build import bloom_build, plan_builds
from .bloom_probe import bloom_probe_batched
from .build import KernelError, load_all
from .flash_attention import flash_attention
from .join_overlap import join_overlap, join_overlap_batched
from .minmax_prune import minmax_prune
from .minmax_prune_batched import _REF_SLAB_ELEMS, minmax_prune_batched
from .ref import minmax_prune_gathered_ref, topk_boundary_prefix_ref
from .topk_boundary import topk_boundary, topk_init_batched

# the port's kernels (csrc/<name>.cu): the batched ones in the order of
# the pipeline's stages (the JOIN's build summary before its probe), then
# the per-query ones, then the LM prefill's
KERNELS = ("minmax_prune_batched", "bloom_build", "join_overlap_batched",
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


# ---------------------------------------------------------------------------
# Partition-dim sharding (launch/mesh.make_plane_mesh)
# ---------------------------------------------------------------------------
#
# Every batched kernel evaluates queries x partitions with no coupling
# across partitions except the top-k heap (a pure selection, mergeable by
# rank).  A mesh -- an ordered tuple of devices -- therefore shards the
# resident planes on the partition (capacity) dim: shard i evaluates its
# [*, cap/n] slice on ``mesh[i]`` with the same kernel wrapper, verdict
# and hit rows concatenate, and the per-shard top-k heaps [n, Q, k] merge
# by rank.  Capacity padding and drop sentinels are position-independent,
# so a sentinel on a shard edge behaves as it does mid-plane.  A shard
# evaluates only its partitions below the logical P (the unsharded
# launch's ``num_partitions``): one wholly in the capacity tail launches
# nothing.
#
# A shard on the planes' own device is a view, never a copy: a column
# block of the [C, cap] planes (the kernel takes the planes' row stride
# apart from the shard's width) or a contiguous slice of the [cap] and
# [cap, K] rows.  On another device the slice is copied once per write of
# the plane and cached (``_shard_of``).

def mesh_shards(mesh, cap: int) -> int:
    """Usable partition-shard count for a capacity-``cap`` plane: the
    mesh's device count when it divides ``cap`` (capacities and meshes
    from ``make_plane_mesh`` are powers of two), else 1 -- the launch
    stays unsharded, the same math on one device."""
    if mesh is None:
        return 1
    n = len(mesh)
    return n if (n > 1 and cap % n == 0) else 1


# Shard count the most recent batched launch on THIS thread used (1 =
# unsharded): a wrapper can demote a mesh-eligible launch back to
# unsharded, and the service's ``sharded_launches`` reports what ran.
_shard_note = threading.local()


def last_launch_shards() -> int:
    return getattr(_shard_note, "n", 1)


def _note_shards(n: int) -> int:
    _shard_note.n = int(n)
    return n


def _usable_shards(mesh, cap: int, dev, plain_elems: int) -> int:
    """The shard count a launch runs with, noted for
    ``last_launch_shards``.  Off the card a sharded plain body whose
    per-shard footprint (``plain_elems / n``) passes the slab bound runs
    unsharded instead, where the plain versions slab their work."""
    n = mesh_shards(mesh, cap)
    if n > 1 and not build.runs_kernel(dev) \
            and plain_elems // n > _REF_SLAB_ELEMS:
        n = 1
    return _note_shards(n)


def _shard_spans(cap: int, n: int, P: int) -> List[Tuple[int, int, int]]:
    """(start, end, live) of each of the n shards of a capacity-``cap``
    plane: live is the count of the shard's partitions below P."""
    w = cap // n
    return [(i * w, (i + 1) * w, max(0, min(P - i * w, w)))
            for i in range(n)]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current CUDA device)."""
    def idx(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and idx(a) == idx(b)


# plane id -> (weak reference to the plane, {(dim, start, end, device):
# (plane version, copy)}): shard copies on another device than the plane's
_shard_copies: dict = {}
_shard_copies_lock = threading.Lock()


def _shard_of(plane: torch.Tensor, dim: int, start: int, end: int,
              dev) -> torch.Tensor:
    """Partitions [start, end) of ``plane`` along ``dim`` on ``dev``: a view
    on the plane's own device; elsewhere a copy, made again only after
    the plane is written (a delta replay swaps in a new tensor, whose
    copies start afresh)."""
    view = plane.narrow(dim, start, end - start)
    if same_device(plane.device, dev):
        return view
    key = (dim, start, end, str(dev))
    with _shard_copies_lock:
        ref, copies = _shard_copies.get(id(plane), (None, None))
        if ref is None or ref() is not plane:
            copies = {}
            _shard_copies[id(plane)] = (weakref.ref(plane), copies)
            weakref.finalize(plane, _shard_copies.pop, id(plane), None)
        hit = copies.get(key)
        if hit is not None and hit[0] == plane._version:
            return hit[1]
        copy = view.contiguous().to(dev)
        copies[key] = (plane._version, copy)
        return copy


def _gather(parts: Sequence[torch.Tensor], dev) -> List[torch.Tensor]:
    """Per-shard outputs on the planes' device ``dev``."""
    return [t if same_device(t.device, dev) else t.to(dev) for t in parts]


def _sharded_rows(kernel, host_args, planes, dim: int, mesh, P: int,
                  name: str) -> np.ndarray:
    """``kernel(*host_args, *plane shards, num_partitions=live)`` on each
    shard of ``planes`` (partition dim ``dim``) on its mesh device, the
    [Q, live] rows concatenated into [Q, P] on the host."""
    dev = planes[0].device
    parts = []
    for (s, e, live), sdev in zip(
            _shard_spans(int(planes[0].shape[dim]), len(mesh), P), mesh):
        args = [torch.from_numpy(a).to(sdev) for a in host_args]
        args += [_shard_of(p, dim, s, e, sdev) for p in planes]
        parts.append(kernel(*args, num_partitions=live))
    return _read_back(torch.cat(_gather(parts, dev), dim=1), name)


def merge_heaps(heaps: torch.Tensor, k: int) -> torch.Tensor:
    """Rank merge of per-shard top-k heaps [n, Q, k] into [Q, k]: the k
    largest of the union, descending, -inf padded.  Top-k is a pure
    selection, so the k largest of the shard-local heaps are exactly the
    k largest of all candidates."""
    n, Q, _ = heaps.shape
    allv = heaps.permute(1, 0, 2).reshape(Q, n * k)
    return torch.sort(allv, dim=1, descending=True,
                      stable=True).values[:, :k].contiguous()


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
    for a degradation.  Its ``launch.readback`` span is where the host
    waits on the card."""
    try:
        with tracing.span("launch.readback"):
            return t.cpu().numpy()
    except RuntimeError as exc:
        raise KernelError(f"reading back {kernel}: {exc}") from exc


def prune_ranges_batched_device(
    range_lists: Sequence[List[Tuple[int, float, float]]],
    dstats: DeviceStats,
    mode: str = "auto",          # 'auto' | 'cuda' | 'torch'
    mesh=None,                   # plane mesh: shard the partition dim
) -> np.ndarray:
    """Evaluate Q queries' conjunctive ranges in one batched launch.

    Returns tv ``[Q, P]`` int8 (host) — row q is identical to the f64 host
    oracle on int/dictionary workloads (bounds snap to integers and cast
    exactly).  Bounds that are inexact in f32 demote FULL to PARTIAL —
    never a false NO_MATCH or false FULL (core.device_stats precision
    contract).  With ``mesh`` each shard evaluates its column block of the
    planes and the verdict rows concatenate, bit-identical to the
    unsharded launch (partitions are independent).
    """
    Q = len(range_lists)
    # one consistent snapshot of (planes, logical P)
    planes, P = dstats.planes_state
    mins, maxs, demote = planes
    dev = mins.device
    check_mode(mode, dev)
    with tracing.span("launch.minmax_prune_batched"):
        cids, lo, hi, full_safe = pack_ranges(range_lists, dstats)
        Pc = int(mins.shape[1])
        shards = _usable_shards(mesh, Pc, dev, cids.shape[0] * Pc)
        # the padded query rows of the bucket are no-ops: launch the Q
        # real ones
        host = [np.ascontiguousarray(a[:Q]) for a in (cids, lo, hi)]
        if shards > 1:
            tv = _sharded_rows(minmax_prune_batched, host, planes, 1, mesh,
                               P, "minmax_prune_batched")
        else:
            cids_d, lo_d, hi_d = (torch.from_numpy(a).to(dev) for a in host)
            tv = _read_back(minmax_prune_batched(
                cids_d, lo_d, hi_d, mins, maxs, demote, num_partitions=P),
                "minmax_prune_batched")
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
    sizes = np.diff(cb)
    pid = np.repeat(np.arange(P), sizes)
    keep = ~np.isnan(vals)
    if mask is not None:
        keep &= np.asarray(mask, dtype=bool)[lo_row:hi_row]
    R = int(sizes.max()) if P else 0
    if 0 < P * R <= 2 * vals.size:
        # partitions of near-equal size: sort each row of a padded [P, R]
        # matrix, -inf in the gaps.  The same rows as the segmented sort
        # below: -inf is the padding either way, and a stable sort keeps
        # equal values (+0 / -0 included) in row order
        col = np.arange(vals.size) - np.repeat(cb[:-1] - lo_row, sizes)
        m = np.full((P, R), -np.inf, dtype=np.float32)
        m[pid[keep], col[keep]] = vals[keep]
        w = min(R, k)
        out[:, :w] = -np.sort(-m, axis=1, kind="stable")[:, :w]
        return out
    vals = vals[keep]
    pid = pid[keep]
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


def keys_f32(keys) -> np.ndarray:
    """Distinct build keys in f32, rounded to nearest.  The one key cast
    of the JOIN paths: it is monotone, so a sorted list stays sorted and
    a key inside a partition's f64 range stays inside its widened f32
    interval (the partition side is widened, never the keys)."""
    return np.asarray(keys, dtype=np.float32)


def _stage_join(stats: PartitionStats, key_col: str, distinct: np.ndarray,
                device: torch.device):
    """The join kernel's inputs on ``device``: (pmin [P], pmax [P],
    distinct [D]) f32, the key column's intervals widened (min down, max
    up) and the keys cast round-to-nearest."""
    pmin = round_down_f32(stats.col_min(key_col))
    pmax = round_up_f32(stats.col_max(key_col))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (pmin, pmax, keys_f32(distinct)))


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
        dist[qi, : len(d)] = keys_f32(d)
    return dist


def _listed(part_ids_lists, qi: int, P: int, dev) -> torch.Tensor:
    """Query qi's listed partition ids (all P without a list) as an index
    tensor on ``dev``."""
    if part_ids_lists is None:
        return torch.arange(P, device=dev)
    return torch.from_numpy(
        np.asarray(part_ids_lists[qi], dtype=np.int64)).to(dev)


def join_overlap_batched_device(
    distinct_lists: Sequence[np.ndarray],
    pmin: torch.Tensor,      # [Pc] resident f32 key-column minima (widened)
    pmax: torch.Tensor,      # [Pc] resident f32 key-column maxima (widened)
    num_partitions: int,     # logical P of the plane
    mode: str = "auto",
    part_ids_lists: Optional[Sequence[np.ndarray]] = None,
    mesh=None,               # plane mesh: shard the partition dim
) -> np.ndarray:
    """hit [Q, P] int8 — Q build summaries vs the resident key plane, one
    launch for the whole table group.  The device path can keep extra
    partitions (widened intervals) but never prunes a partition holding a
    joinable key.

    ``part_ids_lists`` optionally names the partitions each query will
    consult (its scan set).  The kernel ignores it — it evaluates the
    resident plane dense, the batched design — while the plain version
    evaluates only the listed positions; other entries are then 0 and
    must not be read.  A sharded launch evaluates each shard's rows dense
    (the plain version too) and concatenates the hit rows."""
    dev = pmin.device
    check_mode(mode, dev)
    Pc = int(pmin.shape[0])
    packed = pack_distinct(distinct_lists)
    shards = _usable_shards(mesh, Pc, dev, q_bucket(len(distinct_lists)) * Pc)
    if shards > 1:
        return _sharded_rows(join_overlap_batched, [packed], (pmin, pmax),
                             0, mesh, num_partitions, "join_overlap_batched")
    dist = torch.from_numpy(packed).to(dev)
    if part_ids_lists is None or build.runs_kernel(dev):
        hit = join_overlap_batched(dist, pmin, pmax,
                                   num_partitions=num_partitions)
        return _read_back(hit, "join_overlap_batched")
    hit = torch.zeros((len(distinct_lists), num_partitions),
                      dtype=torch.int8, device=dev)
    for qi in range(len(distinct_lists)):
        ids = _listed(part_ids_lists, qi, num_partitions, dev)
        hit[qi, ids] = join_overlap_batched(dist[qi:qi + 1], pmin[ids],
                                            pmax[ids],
                                            num_partitions=len(ids))[0]
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
    part_ids_lists: Optional[Sequence[np.ndarray]] = None,
    mesh=None,               # plane mesh: shard the partition dim
) -> np.ndarray:
    """hit [Q, P] int8 — Q Bloom summaries vs the resident enumeration
    plane; row q equals the host matcher's narrow-range enumeration for
    query q's filter (hit 0 only where 0 < width <= enum_limit and no
    candidate value is in the filter).

    ``part_ids_lists`` as in ``join_overlap_batched_device``: the kernel
    evaluates dense and ignores it; the plain version probes only the
    listed positions, and other entries are 1 (keep) and must not be
    read.  A sharded launch probes each shard's rows dense (the plain
    version too) and concatenates the hit rows; the kernel builds its
    bit-sliced filter table in each shard's launch."""
    dev = pmin.device
    check_mode(mode, dev)
    Pc = int(pmin.shape[0])
    packed = pack_blooms(blooms)
    # partitions wider than the enumeration limit are kept, never probed
    width_eff = torch.where(width <= int(enum_limit), width,
                            torch.zeros_like(width))
    # the plain version's candidates a query: the widest enumerated
    # partition, at least a 128-lane bucket (the reference's enum_bucket)
    enum_w = (0 if build.runs_kernel(dev) else
              _pow2_at_least(max(1, min(int(width.max()) if Pc else 0,
                                        int(enum_limit))), floor=128))
    shards = _usable_shards(mesh, Pc, dev,
                            q_bucket(len(blooms)) * Pc * enum_w)
    if shards > 1:
        return _sharded_rows(bloom_probe_batched, [packed],
                             (pmin, width_eff), 0, mesh, num_partitions,
                             "bloom_probe_batched")
    words = torch.from_numpy(packed).to(dev)
    if part_ids_lists is None or build.runs_kernel(dev):
        hit = bloom_probe_batched(words, pmin, width_eff,
                                  num_partitions=num_partitions)
        return _read_back(hit, "bloom_probe_batched")
    hit = torch.ones((len(blooms), num_partitions), dtype=torch.int8,
                     device=dev)
    for qi in range(len(blooms)):
        ids = _listed(part_ids_lists, qi, num_partitions, dev)
        hit[qi, ids] = bloom_probe_batched(words[qi:qi + 1], pmin[ids],
                                           width_eff[ids],
                                           num_partitions=len(ids))[0]
    return _read_back(hit, "bloom_probe_batched")


def summarize_build_batched_device(
    keys_list: Sequence[np.ndarray],   # G build sides' non-null keys
    ndv_limit: int = 4096,
    bits_per_key: int = 16,
    device=None,
) -> List[BuildSummary]:
    """``core.prune_join.summarize_build`` of each key array, field for
    field, computed by ``bloom_build`` in one launch: one H2D of the plan
    and every key as int64 (through pinned memory on the card), a read of
    the [G, 8] header (the NDVs), and one read of what each summary needs:
    its distinct keys (sorted here, in the keys' dtype) or its Bloom
    words.  Keys are signed integers, or floats holding integers inside
    int64's range (an integer column's encoded values: the caller checks,
    ``PruningService.summary_on_card``).  An empty build side launches
    nothing."""
    dev = resolve_device(device)
    keys_list = [np.asarray(k) for k in keys_list]
    for k in keys_list:
        if k.ndim != 1 or k.dtype.kind not in "if":
            raise KernelError(f"build keys must be 1-D signed integers or "
                              f"floats, got {k.dtype} of shape {k.shape}")
    out: List[Optional[BuildSummary]] = [
        None if k.size else summarize_build(k) for k in keys_list]
    live = [i for i, k in enumerate(keys_list) if k.size]
    if not live:
        return out
    with tracing.span("launch.bloom_build"):
        plan = plan_builds([keys_list[i].size for i in live], ndv_limit,
                           bits_per_key)
        G = len(live)
        host = torch.empty(G * plan.shape[1] + int(plan[:, 1].sum()),
                           dtype=torch.int64,
                           pin_memory=build.runs_kernel(dev))
        buf = host.numpy()
        buf[:plan.size] = plan.reshape(-1)
        for g, i in enumerate(live):
            k0 = plan.size + int(plan[g, 0])
            buf[k0:k0 + keys_list[i].size] = keys_list[i]
        header, distinct, words = bloom_build(
            host.to(dev, non_blocking=True), plan, ndv_limit, bits_per_key)
        head = _read_back(header, "bloom_build")
        # what each summary needs, read back as one int64 array: its NDV
        # keys, or its filter's words in pairs (16 words a block)
        parts = []
        for g in range(G):
            ndv, w0 = int(head[g, 0]), int(plan[g, 4])
            w1 = w0 + int(head[g, 3]) * BLOCK_WORDS
            parts.append(distinct[g, :ndv] if ndv <= ndv_limit
                         else words[w0:w1].view(torch.int64))
        flat = _read_back(torch.cat(parts) if G > 1 else parts[0],
                          "bloom_build")
    at = 0
    for g, i in enumerate(live):
        ndv, lo, hi, n_blocks = (int(v) for v in head[g, :4])
        keys = keys_list[i]
        summary_of = (float(lo), float(hi), int(keys.size))
        if ndv <= ndv_limit:
            uniq = np.sort(flat[at:at + ndv]).astype(keys.dtype, copy=False)
            out[i] = BuildSummary(*summary_of, uniq, None,
                                  int(uniq.nbytes) + 16)
            at += ndv
        else:
            n = n_blocks * BLOCK_WORDS // 2
            bloom = BlockedBloom.from_words(flat[at:at + n].view(np.uint32))
            out[i] = BuildSummary(*summary_of, None, bloom,
                                  bloom.size_bytes + 16)
            at += n
    return out


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


def split_candidates(offsets: torch.Tensor, ids: torch.Tensor, cap: int,
                     n: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """A CSR candidate list (int64 offsets [Q + 1], int32 ids, on the
    planes' device) cut into the n shards of a capacity-``cap`` plane: per
    shard (offsets [Q + 1], ids rebased to the shard's first partition),
    each query's ids kept in their order.  Computed where the lists are:
    on the card a few passes over them, no host loop over candidates."""
    Q = int(offsets.shape[0]) - 1
    w = cap // n
    qidx = torch.repeat_interleave(
        torch.arange(Q, device=ids.device), offsets.diff())
    shard = torch.div(ids, w, rounding_mode="floor")
    out = []
    for i in range(n):
        sel = shard == i
        off = torch.zeros(Q + 1, dtype=torch.int64, device=ids.device)
        torch.cumsum(torch.bincount(qidx[sel], minlength=Q), 0, out=off[1:])
        out.append((off, ids[sel] - i * w))
    return out


def topk_init_batched_device(
    plane: torch.Tensor,     # [Pc, K] resident block-top-k rows (signed f32)
    candidate_lists: Sequence[np.ndarray],   # per query: candidate ids
    k: int,
    mode: str = "auto",
    mesh=None,               # plane mesh: shard the partition dim
) -> np.ndarray:
    """heap [Q, k] f32 — per-query top-k over its candidates' resident
    plane rows.  Query q's Sec. 5.4 upfront boundary for any effective
    kq <= k is ``heap[q, kq - 1]`` (-inf when fewer than kq values exist).
    With ``mesh`` each shard selects over its own rows with its share of
    the candidates (rebased to the shard), and the per-shard heaps merge
    by rank (``merge_heaps``); a shard without a candidate launches
    nothing.
    """
    dev = plane.device
    check_mode(mode, dev)
    with tracing.span("launch.topk_init_batched"):
        offsets, ids = (torch.from_numpy(a).to(dev)
                        for a in pack_candidates(candidate_lists))
        Q, Pc = len(candidate_lists), int(plane.shape[0])
        shards = _usable_shards(mesh, Pc, dev, Q * Pc * int(plane.shape[1]))
        if shards > 1:
            heaps = torch.full((shards, Q, k), float("-inf"),
                               dtype=torch.float32, device=dev)
            for i, ((off, sid), (s, e, _live), sdev) in enumerate(zip(
                    split_candidates(offsets, ids, Pc, shards),
                    _shard_spans(Pc, shards, Pc), mesh)):
                if sid.numel():
                    heaps[i] = topk_init_batched(
                        _shard_of(plane, 0, s, e, sdev), off.to(sdev),
                        sid.to(sdev), k).to(dev)
            return _read_back(merge_heaps(heaps, k), "topk_init_batched")
        return _read_back(topk_init_batched(plane, offsets, ids, k),
                          "topk_init_batched")


# ---------------------------------------------------------------------------
# Hierarchical (tree) pruning path: group pre-pass + gathered leaf eval
# ---------------------------------------------------------------------------
#
# The flat batched path is linear in P: every query touches every
# partition slot.  The tree path makes the work follow the *survivors*,
# in three levels (core.device_stats stages the aggregated planes):
#
#   0. host coarse: the [C, G2] root hulls (G2 <= 64) evaluate in numpy;
#      this restricts level 1 and *prices* the pre-pass before any
#      launch.  Coarse survivors bound fine survivors from above, so a
#      coarse density over the cutoff proves the pre-pass cannot win and
#      the flat launch runs with no extra work.
#   1. fine group pre-pass: the [C, G] group planes evaluate only at the
#      coarse survivors' children, per query, by the gathered evaluator.
#   2. leaf: the flat [C, cap] planes evaluate only at the surviving
#      groups' members; verdicts scatter into the [Q, P] output.  Every
#      unlisted live partition sits in a group whose hull missed the
#      query, and group NO_MATCH implies member NO_MATCH, so the rows are
#      bit-identical to the flat evaluation.
#
# FULL is never decided above the leaves: a hull inside [lo, hi] proves
# nothing about its members, so the pre-pass only decides NO_MATCH versus
# survive.  The gathered evaluator (``ref.minmax_prune_gathered_ref``) is
# plain torch on both devices; the JOIN and top-k forms launch the flat
# kernels on dense or compacted planes.

TREE_DENSE_CUTOFF = 0.5

# What the most recent tree-path call on THIS thread did (path taken,
# group count, survivor densities, leaf columns).
_tree_note = threading.local()


def last_tree_stats() -> dict:
    return getattr(_tree_note, "d", {})


def _note_tree(**kw) -> None:
    _tree_note.d = dict(kw)


def _coarse_survivors(cids, lo, hi, cmins, cmaxs) -> np.ndarray:
    """surv [Q, G2] bool — host evaluation of the coarse root level: the
    NO_MATCH term of the batched evaluation (empty hull, range miss);
    no-op slots keep everything."""
    surv = np.ones((cids.shape[0], cmins.shape[1]), dtype=bool)
    for k in range(cids.shape[1]):
        pm = cmins[cids[:, k]]                        # [Q, G2]
        px = cmaxs[cids[:, k]]
        lo_k = lo[:, k][:, None]
        hi_k = hi[:, k][:, None]
        noop = (lo_k == -np.inf) & (hi_k == np.inf)
        no = ((pm > px) | (px < lo_k) | (pm > hi_k)) & ~noop
        surv &= ~no
    return surv


def _survivor_ids(surv: np.ndarray) -> np.ndarray:
    """ids [Q, Sb] int64 — each row's surviving ids, right-padded with id
    0 up to the power-of-two bucket Sb of the largest row count.  The
    padding is exact, not a sentinel: the gathered evaluator computes the
    true verdict at every position it is given, and scattering a true
    verdict twice — or for a pruned group, whose members are provably NO
    — changes nothing."""
    Q = surv.shape[0]
    counts = surv.sum(axis=1)
    sb = _pow2_at_least(max(int(counts.max()), 1))
    ids = np.zeros((Q, sb), dtype=np.int64)
    qs, gs = np.nonzero(surv)
    col = np.arange(len(qs)) - np.repeat(np.cumsum(counts) - counts, counts)
    ids[qs, col] = gs
    return ids


def _survivor_positions(ids, span: int):
    """pos [Q, Sb * span] — each surviving id expanded to its ``span``
    child positions (id * span + j), in the array type of ``ids`` (a
    numpy array, or a tensor on its device)."""
    if isinstance(ids, torch.Tensor):
        j = torch.arange(span, dtype=ids.dtype, device=ids.device)
    else:
        j = np.arange(span, dtype=ids.dtype)
    return (ids[:, :, None] * span + j).reshape(ids.shape[0], -1)


def prune_ranges_batched_tree(
    range_lists: Sequence[List[Tuple[int, float, float]]],
    dstats: DeviceStats,
    tree_entry,                  # DeviceStatsCache.tree_plane(...) entry
    mode: str = "auto",
    mesh=None,
) -> np.ndarray:
    """tv [Q, P] int8 via the hierarchical group pre-pass.

    Bit-identical to ``prune_ranges_batched_device`` row for row: the
    pre-pass only removes positions whose group hull *proves* NO_MATCH.
    Falls back to the flat launch when the table is too small for the
    tree geometry or the coarse survivor density exceeds
    ``TREE_DENSE_CUTOFF`` (priced on the host coarse level, so the fallback
    pays no pre-pass).  The gathered evaluations are unsharded: a mesh is
    forwarded to the flat fallback only.
    """
    Q = len(range_lists)
    planes, P = dstats.planes_state
    mins, maxs, demote = planes
    dev = mins.device
    check_mode(mode, dev)
    gm, gx, gd, cmins, cmaxs = tree_entry.arrays
    cmins, cmaxs = to_host(cmins), to_host(cmaxs)
    fanout = int(tree_entry.meta["fanout"])
    G = int(gm.shape[1])
    if Q == 0 or int(mins.shape[1]) != G * fanout \
            or P < fanout * TREE_MIN_GROUPS:
        _note_tree(path="flat_small", groups=G)
        return prune_ranges_batched_device(range_lists, dstats, mode, mesh)
    cids, lo, hi, full_safe = pack_ranges(range_lists, dstats)
    cids, lo, hi = cids[:Q], lo[:Q], hi[:Q]
    # Level 0 — the host coarse hulls price the pre-pass
    csurv = _coarse_survivors(cids, lo, hi, cmins, cmaxs)
    G2 = csurv.shape[1]
    cdens = csurv.sum(axis=1).max() / G2
    if cdens > TREE_DENSE_CUTOFF:
        _note_tree(path="flat_dense", groups=G, coarse_density=float(cdens))
        return prune_ranges_batched_device(range_lists, dstats, mode, mesh)
    cids_d, lo_d, hi_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (cids, lo, hi))
    # Level 1 — fine group pre-pass over the coarse survivors' children
    gpos = _survivor_positions(_survivor_ids(csurv), G // G2)
    tvg = _read_back(minmax_prune_gathered_ref(
        cids_d, lo_d, hi_d, gm, gx, gd, torch.from_numpy(gpos).to(dev)),
        "tree pre-pass")
    gsurv = np.zeros((Q, G), dtype=bool)
    qrow = np.repeat(np.arange(Q), gpos.shape[1])
    gsurv[qrow, gpos.reshape(-1)] = (tvg > 0).reshape(-1)
    fdens = gsurv.sum(axis=1).max() / G
    # Level 2 — the leaves of the surviving groups (expanded on the
    # device from their group ids), in slabs of whole groups (a power of
    # two of them) that bound the gathers' memory
    pos = _survivor_positions(
        torch.from_numpy(_survivor_ids(gsurv)).to(dev), fanout)
    W = int(pos.shape[1])
    groups_per_slab = max(1, (_REF_SLAB_ELEMS // q_bucket(Q)) // fanout)
    slab = fanout * (1 << (groups_per_slab.bit_length() - 1))
    tvl = torch.cat([minmax_prune_gathered_ref(
        cids_d, lo_d, hi_d, mins, maxs, demote, pos[:, s:s + slab])
        for s in range(0, W, slab)], dim=1)
    # Scatter — unlisted positions stay 0 (NO): every unlisted live
    # partition sits in a pruned group, and group NO implies member NO;
    # capacity-tail positions are dropped
    tv_d = torch.zeros((Q, P), dtype=torch.int8, device=dev)
    live = pos < P
    rows = torch.arange(Q, device=dev)[:, None].expand(Q, W)
    tv_d[rows[live], pos[live]] = tvl[live]
    tv = _read_back(tv_d, "tree leaves")
    _note_shards(1)
    if not full_safe.all():
        tv[~full_safe] = np.minimum(tv[~full_safe], 1)
    _note_tree(path="tree", groups=G, coarse_density=float(cdens),
               fine_density=float(fdens), leaf_cols=W)
    return tv


def _restrict(part_ids_lists, n: int, P: int, keep: np.ndarray,
              fanout: int) -> List[np.ndarray]:
    """Each query's listed ids (all P without a list) that lie in a group
    ``keep[q]`` (one [G] bool row, or one shared by every query) keeps."""
    out = []
    for qi in range(n):
        ids = (np.arange(P) if part_ids_lists is None
               else np.asarray(part_ids_lists[qi], dtype=np.int64))
        k = keep if keep.ndim == 1 else keep[qi]
        out.append(ids[k[ids // fanout]])
    return out


def join_overlap_batched_tree(
    distinct_lists: Sequence[np.ndarray],
    pmin: torch.Tensor,
    pmax: torch.Tensor,
    num_partitions: int,
    tree_entry,
    key_ci: int,
    mode: str = "auto",
    part_ids_lists: Optional[Sequence[np.ndarray]] = None,
    mesh=None,
) -> np.ndarray:
    """hit [Q, P] — group pre-pass wrapper over the batched join overlap.

    The stat tree's ``key_ci`` row is a hull over the same widened f32
    member intervals as the join-key plane, so a distinct list that misses
    group g's hull misses every member: those members' hits are provably
    0 and drop out of the part-id restriction handed to the flat
    evaluator.  Bit-identical either way.  The kernel evaluates the
    resident plane dense and ignores a restriction, so the restriction is
    built only for the plain version, which reads it.
    """
    Q = len(distinct_lists)
    fanout = int(tree_entry.meta["fanout"])
    G = int(tree_entry.meta["groups"])
    if Q == 0 or int(pmin.shape[0]) > G * fanout:
        _note_tree(path="flat_small", groups=G)
        return join_overlap_batched_device(distinct_lists, pmin, pmax,
                                           num_partitions, mode,
                                           part_ids_lists, mesh)
    hg_lo = to_host(tree_entry.arrays[0][key_ci])      # [G] group hulls
    hg_hi = to_host(tree_entry.arrays[1][key_ci])
    ghit = np.empty((Q, G), dtype=bool)
    for qi, d in enumerate(distinct_lists):
        d32 = keys_f32(d)
        # group g may hit iff some key lands in its hull; an empty hull
        # (an all-sentinel group) brackets nothing
        ghit[qi] = (np.searchsorted(d32, hg_hi, side="right")
                    > np.searchsorted(d32, hg_lo, side="left"))
    dens = ghit.sum(axis=1).max() / G
    if dens > TREE_DENSE_CUTOFF:
        _note_tree(path="flat_dense", groups=G, fine_density=float(dens))
        return join_overlap_batched_device(distinct_lists, pmin, pmax,
                                           num_partitions, mode,
                                           part_ids_lists, mesh)
    _note_tree(path="tree", groups=G, fine_density=float(dens))
    restricted = (part_ids_lists if build.runs_kernel(pmin.device) else
                  _restrict(part_ids_lists, Q, num_partitions, ghit, fanout))
    return join_overlap_batched_device(distinct_lists, pmin, pmax,
                                       num_partitions, mode, restricted,
                                       mesh)


def bloom_probe_batched_tree(
    blooms: Sequence,
    pmin: torch.Tensor,
    width: torch.Tensor,
    enum_limit: int,
    num_partitions: int,
    tree_entry,
    mode: str = "auto",
    part_ids_lists: Optional[Sequence[np.ndarray]] = None,
    mesh=None,
) -> np.ndarray:
    """hit [Q, P] — group pre-pass wrapper over the batched Bloom probe.

    Bloom pruning only ever decides *enumerable* partitions (0 < width <=
    enum_limit); everything else is an unconditional keep.  The pre-pass
    aggregates enumerability over the width plane's groups (one reduction
    on the device) and restricts the part-id lists to members of groups
    with an enumerable member: the excluded rows are exactly the flat
    path's keeps, so the result is bit-identical.  As for the join, the
    kernel ignores the restriction and it is built only for the plain
    version.
    """
    Q = len(blooms)
    fanout = int(tree_entry.meta["fanout"])
    G = int(tree_entry.meta["groups"])
    if Q == 0 or int(width.shape[0]) != G * fanout:
        _note_tree(path="flat_small", groups=G)
        return bloom_probe_batched_device(blooms, pmin, width, enum_limit,
                                          num_partitions, mode,
                                          part_ids_lists, mesh)
    genum = to_host(((width > 0) & (width <= int(enum_limit)))
                    .reshape(G, fanout).any(dim=1))
    _note_tree(path="tree", groups=G, fine_density=float(genum.mean()))
    restricted = (part_ids_lists if build.runs_kernel(pmin.device) else
                  _restrict(part_ids_lists, Q, num_partitions, genum,
                            fanout))
    return bloom_probe_batched_device(blooms, pmin, width, enum_limit,
                                      num_partitions, mode, restricted, mesh)


def topk_init_batched_tree(
    plane: torch.Tensor,
    candidate_lists: Sequence[np.ndarray],
    k: int,
    tree_entry,
    mode: str = "auto",
    mesh=None,
) -> np.ndarray:
    """heap [Q, k] — group-compacted wrapper over the batched top-k init.

    The union of the candidates' groups names every plane row any query
    can select from, so the kernel runs on the compacted ``[S * fanout,
    K]`` slice of the plane (``index_select`` of the S surviving groups)
    with each candidate id remapped into it — ``rank(group) * fanout + id
    % fanout`` — and returns the identical value multisets (top-k is a
    pure selection).  Dense unions fall back flat.  A mesh shards the
    compacted plane where the mesh divides its rows, else the launch runs
    unsharded.
    """
    Q = len(candidate_lists)
    fanout = int(tree_entry.meta["fanout"])
    G = int(tree_entry.meta["groups"])
    if Q == 0 or int(plane.shape[0]) != G * fanout:
        _note_tree(path="flat_small", groups=G)
        return topk_init_batched_device(plane, candidate_lists, k, mode,
                                        mesh)
    lists = [np.asarray(c, dtype=np.int64) for c in candidate_lists]
    gunion = np.zeros(G, dtype=bool)
    for c in lists:
        gunion[c // fanout] = True
    dens = gunion.sum() / G
    if dens > TREE_DENSE_CUTOFF:
        _note_tree(path="flat_dense", groups=G, fine_density=float(dens))
        return topk_init_batched_device(plane, candidate_lists, k, mode,
                                        mesh)
    gids = np.nonzero(gunion)[0]
    _note_tree(path="tree", groups=G, fine_density=float(dens))
    if not gids.size:
        _note_shards(1)
        return np.full((Q, k), -np.inf, dtype=np.float32)
    rank = np.zeros(G, dtype=np.int64)
    rank[gids] = np.arange(gids.size)
    pos = (gids[:, None] * fanout + np.arange(fanout)[None, :]).reshape(-1)
    cplane = plane.index_select(0, torch.from_numpy(pos).to(plane.device))
    return topk_init_batched_device(
        cplane, [rank[c // fanout] * fanout + c % fanout for c in lists], k,
        mode, mesh)
