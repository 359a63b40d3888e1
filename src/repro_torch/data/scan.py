"""Scan + query execution over pruned scan sets.

Executes queries for real (row-level filters, hash joins, LIMIT halt,
top-k) so tests can prove pruning changes *work*, never *results*.  Also
accounts bytes/rows/partitions touched — the cost model standing in for
the network I/O a decoupled-storage system saves.

The executor halts a LIMIT scan as soon as k rows are produced (the
paper's observation that most engines do this anyway); partition-level
metrics therefore show the parallel-execution catch of Sec. 4.4 — without
pruning, n workers each fetch partitions before the halt propagates.

Host NumPy, as in the JAX package: it reads the rows themselves, which
never reach the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import expr as E
from ..core.flow import PruningReport, Query
from ..core.metadata import ScanSet, live_full_scan
from ..core.rowval import RowContext, matches
from .table import Table

BYTES_PER_VALUE = 8  # encoded columnar width


@dataclasses.dataclass
class ScanMetrics:
    partitions_scanned: int = 0
    rows_scanned: int = 0
    bytes_scanned: int = 0

    def add(self, other: "ScanMetrics") -> None:
        self.partitions_scanned += other.partitions_scanned
        self.rows_scanned += other.rows_scanned
        self.bytes_scanned += other.bytes_scanned


@dataclasses.dataclass
class QueryResult:
    columns: Dict[str, np.ndarray]
    nulls: Dict[str, np.ndarray]
    metrics: Dict[str, ScanMetrics]

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def total_bytes(self) -> int:
        return sum(m.bytes_scanned for m in self.metrics.values())


# rows a run of partitions may hold before it is evaluated: the first run
# holds FIRST_RUN_ROWS (a LIMIT halt seldom needs more), each next one
# twice the last, up to MAX_RUN_ROWS
FIRST_RUN_ROWS = 1 << 12
MAX_RUN_ROWS = 1 << 20


def scan_partitions(
    table: Table,
    scan: ScanSet,
    pred: Optional[E.Pred],
    stop_after_rows: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], ScanMetrics]:
    """Fetch partitions in scan-set order, filter rows, stop early on LIMIT.

    The JAX package walks the scan set a partition at a time; here runs
    of partitions are gathered and filtered at once, and the LIMIT halt
    is found in a run by its partitions' cumulative match counts: the
    halt still falls after the first partition that brings the rows
    produced to ``stop_after_rows``, so the rows, their order and the
    metrics are the same.
    """
    metrics = ScanMetrics()
    out_cols: Dict[str, list] = {c: [] for c in table.columns}
    out_nulls: Dict[str, list] = {c: [] for c in table.columns}
    ncols = len(table.columns)
    bounds = np.asarray(table.part_bounds, dtype=np.int64)
    ids = np.asarray(scan.part_ids, dtype=np.int64)
    starts, lens = bounds[ids], bounds[ids + 1] - bounds[ids]
    ends = np.cumsum(lens)              # rows through each listed partition
    filtered = pred is not None and not isinstance(pred, E.TruePred)
    produced = 0
    lo, budget = 0, FIRST_RUN_ROWS
    while lo < len(ids):
        before = ends[lo - 1] if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, before + budget,
                                             side="right")))
        n_rows = lens[lo:hi]
        # the run's row ids, partition after partition
        offsets = np.concatenate([[0], np.cumsum(n_rows)])
        idx = (np.repeat(starts[lo:hi] - offsets[:-1], n_rows)
               + np.arange(offsets[-1]))
        ctx = RowContext(table.columns,
                         {k: v[idx] for k, v in table.data.items()},
                         {k: v[idx] for k, v in table.nulls.items()})
        mask = (matches(pred, ctx) if filtered
                else np.ones(ctx.n, dtype=bool))
        hits = np.concatenate([[0], np.cumsum(mask)])
        counts = hits[offsets[1:]] - hits[offsets[:-1]]
        taken = hi - lo
        if stop_after_rows is not None:
            reached = np.nonzero(produced + np.cumsum(counts)
                                 >= stop_after_rows)[0]
            if reached.size:
                taken = int(reached[0]) + 1
        rows = int(offsets[taken])
        keep = mask[:rows]
        metrics.partitions_scanned += taken
        metrics.rows_scanned += rows
        metrics.bytes_scanned += rows * ncols * BYTES_PER_VALUE
        for c in table.columns:
            v, nm = ctx.col(c)
            out_cols[c].append(v[:rows][keep])
            out_nulls[c].append(nm[:rows][keep])
        produced += int(counts[:taken].sum())
        if taken < hi - lo or (stop_after_rows is not None
                               and produced >= stop_after_rows):
            break
        lo, budget = hi, min(2 * budget, MAX_RUN_ROWS)
    cols = {c: np.concatenate(v) if v else np.zeros(0) for c, v in out_cols.items()}
    nulls = {c: np.concatenate(v) if v else np.zeros(0, dtype=bool)
             for c, v in out_nulls.items()}
    return cols, nulls, metrics


def _join_indices(
    probe_keys: np.ndarray,
    probe_nulls: np.ndarray,
    build_keys: np.ndarray,
    build_nulls: np.ndarray,
    kind: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized hash-join index computation.

    Returns (probe_idx, build_idx, matched_mask_for_probe); build_idx is -1
    for unmatched probe rows under left_outer.
    """
    valid_b = ~build_nulls
    b_idx_valid = np.where(valid_b)[0]
    bk = build_keys[valid_b]
    order = np.argsort(bk, kind="stable")
    sorted_b = bk[order]

    pk = probe_keys.copy()
    n = len(pk)
    lo = np.searchsorted(sorted_b, pk, side="left")
    hi = np.searchsorted(sorted_b, pk, side="right")
    counts = (hi - lo) * (~probe_nulls)  # null keys never join
    total = int(counts.sum())

    probe_idx = np.repeat(np.arange(n), counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    build_idx = b_idx_valid[order[np.repeat(lo, counts) + within]]

    matched = counts > 0
    if kind == "left_outer":
        unmatched = np.where(~matched)[0]
        probe_idx = np.concatenate([probe_idx, unmatched])
        build_idx = np.concatenate([build_idx, np.full(len(unmatched), -1, dtype=np.int64)])
    return probe_idx, build_idx, matched


def execute_query(
    q: Query,
    report: Optional[PruningReport] = None,
    halt_on_limit: bool = True,
) -> QueryResult:
    """Execute a query; with ``report`` the pruned scan sets are used,
    otherwise every partition is scanned (the no-pruning baseline)."""
    if q.group_by:
        raise NotImplementedError("aggregation execution not modeled")

    scan_sets = (
        report.scan_sets
        if report is not None
        else {n: live_full_scan(s.table) for n, s in q.scans.items()}
    )
    metrics: Dict[str, ScanMetrics] = {}

    # Plain LIMIT without join: scan in scan-set order, halting early.
    if q.join is None:
        (name, spec), = q.scans.items()
        stop = q.effective_k if (q.is_plain_limit and halt_on_limit) else None
        if q.is_topk and report is not None and report.topk is not None:
            # Execute the top-k via the boundary-pruned runtime directly.
            cols, nulls, m = scan_partitions(
                spec.table,
                ScanSet(report.topk.scanned),
                spec.pred,
            )
            metrics[name] = m
        else:
            cols, nulls, m = scan_partitions(spec.table, scan_sets[name], spec.pred, stop)
            metrics[name] = m
        cols = {f"{name}.{c}": v for c, v in cols.items()}
        nulls = {f"{name}.{c}": v for c, v in nulls.items()}
        return _finalize(q, cols, nulls, metrics)

    # Join path: build side first (always fully scanned), then probe.
    j = q.join
    bspec, pspec = q.scans[j.build], q.scans[j.probe]
    bcols, bnulls, bm = scan_partitions(bspec.table, scan_sets[j.build], bspec.pred)
    metrics[j.build] = bm
    probe_scan = scan_sets[j.probe]
    if q.is_topk and report is not None and report.topk is not None and \
            q.order_by[0] == j.probe:
        probe_scan = ScanSet(report.topk.scanned)
    pcols, pnulls, pm = scan_partitions(pspec.table, probe_scan, pspec.pred)
    metrics[j.probe] = pm

    pi, bi, _ = _join_indices(
        pcols[j.probe_key], pnulls[j.probe_key],
        bcols[j.build_key], bnulls[j.build_key], j.kind,
    )
    cols: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    for c, v in pcols.items():
        cols[f"{j.probe}.{c}"] = v[pi]
        nulls[f"{j.probe}.{c}"] = pnulls[c][pi]
    pad = bi < 0
    bi_safe = np.where(pad, 0, bi)
    for c, v in bcols.items():
        cols[f"{j.build}.{c}"] = np.where(pad, np.nan, v[bi_safe])
        nulls[f"{j.build}.{c}"] = np.where(pad, True, bnulls[c][bi_safe])
    return _finalize(q, cols, nulls, metrics)


def _finalize(q: Query, cols, nulls, metrics) -> QueryResult:
    n = len(next(iter(cols.values()))) if cols else 0
    order = np.arange(n)
    if q.is_topk:
        scan_name, col, desc = q.order_by
        key = cols[f"{scan_name}.{col}"].astype(np.float64).copy()
        nm = nulls[f"{scan_name}.{col}"]
        key[nm] = -np.inf if desc else np.inf  # NULLS LAST
        order = np.argsort(-key if desc else key, kind="stable")
    if q.limit is not None:
        order = order[q.offset : q.offset + q.limit]
    cols = {c: v[order] for c, v in cols.items()}
    nulls = {c: v[order] for c, v in nulls.items()}
    return QueryResult(cols, nulls, metrics)
