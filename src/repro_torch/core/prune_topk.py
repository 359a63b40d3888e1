"""Top-k (ORDER BY x LIMIT k) runtime pruning (paper Sec. 5).

Block-max-WAND adapted to the relational setting: while scanning, the k-th
best value seen so far — the *boundary value* — is passed sideways to the
table scan, and a partition whose metadata max (DESC ordering) cannot beat
the boundary is skipped without being fetched.

Three pieces, mirroring the paper:
  * the scan loop with boundary pruning (`run_topk`),
  * partition processing-order strategies (Sec. 5.3): 'none' | 'random' |
    'sort' (by block max),
  * upfront boundary initialization from fully-matching partitions'
    metadata (Sec. 5.4).

Everything works in the *signed domain*: ``sv = sign * value`` with
sign=+1 for DESC and -1 for ASC, so the core logic is DESC-only.  The
per-partition "block max" is ``max(sign * values) = sign * (max if desc
else min)``.

Skip rules (proved safe; hypothesis-tested against a full-scan oracle):
  with B = upfront boundary, H = heap k-th value (when the heap is full):
  * skip if block_max <  max(B, H): no row can enter the final top-k
    (rows < B are below the true k-th value; rows < H cannot improve the
    current heap);
  * skip if the heap is full and block_max <= H: a tie with the current
    k-th value cannot change the top-k *value multiset*.
  Note block_max == B with a non-full heap must NOT be skipped: the rows
  guaranteeing B may live in exactly that partition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import tracing
from . import expr as E
from .metadata import FULL_MATCH, PartitionStats, ScanSet
from .rowval import matches


@dataclasses.dataclass
class TopKResult:
    values: np.ndarray          # the top-k order-column values (best first)
    scanned: np.ndarray         # partition ids fetched
    skipped: np.ndarray         # partition ids pruned by the boundary
    pruning_ratio: float
    rows_scanned: int
    boundary_final: float       # signed-domain boundary at completion
    sources: np.ndarray = None  # partition id contributing each heap value
                                # (Sec. 8.2: recorded "alongside each tuple
                                # in the top-k heap" for predicate caching)

    @property
    def contributing(self) -> np.ndarray:
        """Distinct partitions whose rows form the final top-k."""
        if self.sources is None or self.sources.size == 0:
            return np.zeros(0, dtype=np.int64)
        return np.unique(self.sources)


def _signed_block_max(stats: PartitionStats, order_col: str, sign: float,
                      part_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-partition ``max(sign * value)``; ``part_ids`` restricts the
    gather to a scan subset (O(|scan|), not O(P) — the engine only ever
    consults the partitions it may fetch)."""
    ci = stats.col_id(order_col)
    if part_ids is None:
        return np.where(sign > 0, stats.maxs[:, ci], -stats.mins[:, ci])
    if sign > 0:
        return stats.maxs[part_ids, ci]
    return -stats.mins[part_ids, ci]


def order_partitions(
    scan: ScanSet,
    stats: PartitionStats,
    order_col: str,
    strategy: str = "sort",
    sign: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> ScanSet:
    """Sec. 5.3 processing-order strategies."""
    if strategy == "none":
        return scan
    if strategy == "random":
        rng = rng or np.random.default_rng(0)
        return scan.reorder(rng.permutation(len(scan)))
    if strategy == "sort":
        bmax = _signed_block_max(stats, order_col, sign, scan.part_ids)
        return scan.reorder(np.argsort(-bmax, kind="stable"))
    raise ValueError(f"unknown strategy {strategy!r}")


def upfront_boundary(
    scan: ScanSet, stats: PartitionStats, order_col: str, k: int, sign: float = 1.0
) -> float:
    """Sec. 5.4: initialize the boundary from fully-matching partitions.

    Signed-domain candidates: (a) the k-th largest signed block max over
    fully-matching partitions — each such partition contains a row equal to
    its block max, so >= k fully-matching partitions guarantee k rows at or
    above the k-th largest; (b) sort fully-matching partitions by signed
    block *min* descending and take the block min where the cumulative
    non-null row count first reaches k — all rows of the partitions up to
    that point are >= it.  Returns the stricter (larger).
    """
    if scan.match is None:
        return -np.inf
    full_ids = scan.part_ids[scan.match == FULL_MATCH]
    if full_ids.size == 0:
        return -np.inf
    ci = stats.col_id(order_col)
    bmax = (stats.maxs[full_ids, ci] if sign > 0 else -stats.mins[full_ids, ci])
    bmin = (stats.mins[full_ids, ci] if sign > 0 else -stats.maxs[full_ids, ci])
    rows = stats.row_counts[full_ids] - stats.null_counts[full_ids, ci]
    valid = rows > 0
    bmax, bmin, rows = bmax[valid], bmin[valid], rows[valid]
    if bmax.size == 0:
        return -np.inf

    cand_a = float(np.sort(bmax)[-k]) if bmax.size >= k else -np.inf

    order = np.argsort(-bmin, kind="stable")
    cum = np.cumsum(rows[order])
    pos = int(np.searchsorted(cum, k))
    cand_b = float(bmin[order][pos]) if pos < bmin.size else -np.inf

    return max(cand_a, cand_b)


def run_topk(
    table,
    scan: ScanSet,
    order_col: str,
    k: int,
    pred: Optional[E.Pred] = None,
    desc: bool = True,
    strategy: str = "sort",
    use_upfront_init: bool = False,
    rng: Optional[np.random.Generator] = None,
    extra_mask_fn=None,
    b_init_floor: float = -np.inf,
) -> TopKResult:
    """Execute a top-k scan with boundary-value partition pruning.

    ``extra_mask_fn(ctx) -> bool[n]`` models operators between the scan and
    the TopK node (Fig. 7b: a join probe — only rows that survive it feed
    the heap).  Note: when an extra mask is present, Sec. 5.4 upfront
    initialization is disabled — fully-matching only certifies the scan's
    own predicate, not the join's survival.

    ``b_init_floor`` lets a caller strengthen the upfront boundary with an
    externally computed one (signed domain).  The caller must guarantee it
    is a *witnessed* Sec. 5.4 boundary — k matching rows >= the floor must
    exist — e.g. the device plane's boundary init, which takes the k-th
    largest value over fully-matching partitions' resident block-top-k
    rows.  Like the built-in init, it is ignored when an extra mask is
    present (fully-matching does not certify the mask's survival).
    """
    stats = table.stats
    sign = 1.0 if desc else -1.0
    with tracing.span("topk.order"):
        scan = order_partitions(scan, stats, order_col, strategy, sign, rng)
        b_init = (
            upfront_boundary(scan, stats, order_col, k, sign)
            if use_upfront_init and extra_mask_fn is None
            else -np.inf
        )
    if extra_mask_fn is None:
        b_init = max(b_init, float(b_init_floor))

    sp = tracing.span("topk.scan")
    # partitions whose rows entered the heap (counted while tracing)
    improved = 0
    with sp:
        heap = np.empty(0)  # signed values, sorted descending
        heap_src = np.empty(0, dtype=np.int64)
        rows_scanned = 0
        block_max = _signed_block_max(stats, order_col, sign, scan.part_ids)

        # Vectorized pre-skip: eff = max(b_init, h_kth) >= b_init throughout
        # the loop, so a partition with block_max < b_init is skipped no
        # matter how the heap evolves — drop them from the Python loop in
        # one shot (same skip set, same heap; skip order is reconstructed
        # positionally).
        skip_flag = np.asarray(block_max < b_init)
        scanned: list = []
        for pos in np.where(~skip_flag)[0]:
            pid = scan.part_ids[pos]
            bm = block_max[pos]
            heap_full = len(heap) >= k
            h_kth = heap[k - 1] if heap_full else -np.inf
            eff = max(b_init, h_kth)
            if bm < eff or (heap_full and bm <= h_kth):
                skip_flag[pos] = True
                continue
            ctx = table.partition_ctx(int(pid))
            mask = (matches(pred, ctx) if pred is not None
                    else np.ones(ctx.n, dtype=bool))
            if extra_mask_fn is not None:
                mask &= extra_mask_fn(ctx)
            vals, nm = ctx.col(order_col)
            mask &= ~nm  # NULLS LAST: nulls never enter the heap
            rows_scanned += ctx.n
            scanned.append(pid)
            if mask.any():
                newv = sign * vals[mask]
                merged = np.concatenate([heap, newv])
                srcs = np.concatenate(
                    [heap_src, np.full(len(newv), pid, dtype=np.int64)])
                order_ix = np.argsort(-merged, kind="stable")[:k]
                # the stable merge keeps a full heap's rows in order, so a
                # new row entered iff the old k-th row (index k - 1) left
                if sp and (not heap_full or order_ix[k - 1] != k - 1):
                    improved += 1
                heap = merged[order_ix]
                heap_src = srcs[order_ix]
        if sp:
            sp.set(read=len(scanned), improved=improved)

    total = len(scan)
    skipped = scan.part_ids[skip_flag]
    ratio = len(skipped) / total if total else 0.0
    return TopKResult(
        values=sign * heap,
        scanned=np.asarray(scanned, dtype=np.int64),
        skipped=np.asarray(skipped, dtype=np.int64),
        pruning_ratio=ratio,
        rows_scanned=rows_scanned,
        boundary_final=float(heap[k - 1]) if len(heap) >= k else -np.inf,
        sources=heap_src,
    )


def topk_oracle(table, order_col: str, k: int, pred=None, desc: bool = True) -> np.ndarray:
    """Full-scan reference: the true top-k value multiset."""
    ctx = table.global_ctx()
    mask = matches(pred, ctx) if pred is not None else np.ones(ctx.n, dtype=bool)
    vals, nm = ctx.col(order_col)
    vals = vals[mask & ~nm]
    vals = np.sort(vals)
    return vals[::-1][:k] if desc else vals[:k]
