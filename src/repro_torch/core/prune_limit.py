"""LIMIT pruning via fully-matching partitions (paper Sec. 4).

If the rows of fully-matching partitions alone can satisfy ``LIMIT k``,
the scan set is cut to the *minimal* number of fully-matching partitions —
globally IO-optimal for supported query shapes.  Otherwise the scan set is
merely reordered to put fully-matching partitions first ("starting the
table scan with fully-matching partitions promises faster query execution
times").

Row counting uses non-null row counts when a projection column is given;
the default counts partition rows (SELECT * semantics, as in the paper).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .metadata import FULL_MATCH, PartitionStats, ScanSet

# Table 2 categories.
ALREADY_MINIMAL = "already_minimal"
UNSUPPORTED_SHAPE = "unsupported_shape"
NO_FULLY_MATCHING = "no_fully_matching"   # prerequisites unmet -> reorder only
PRUNED_TO_0 = "pruned_to_=0"              # LIMIT 0: scan wiped entirely
PRUNED_TO_1 = "pruned_to_=1"
PRUNED_TO_N = "pruned_to_>1"


@dataclasses.dataclass
class LimitPruneResult:
    scan: ScanSet
    applied: bool
    category: str
    partitions_before: int
    partitions_after: int


def limit_prune(
    scan: ScanSet,
    stats: PartitionStats,
    k: int,
    supported_shape: bool = True,
) -> LimitPruneResult:
    """Prune/reorder ``scan`` for ``LIMIT k`` (k includes any OFFSET).

    ``scan.match`` must carry the three-valued filter-pruning result
    (Sec. 4.2: fully-matching detection is an extension of filter pruning).
    """
    before = len(scan)
    if not supported_shape:
        return LimitPruneResult(scan, False, UNSUPPORTED_SHAPE, before, before)
    if k == 0:
        # LIMIT 0 (BI tools fetching schemas): the scan is wiped — checked
        # BEFORE the already-minimal early return (a single-partition scan
        # must be emptied too) and reported under its own category, so the
        # Table 2 accounting never claims "pruned to 1" for 0 partitions.
        empty = ScanSet(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int8))
        return LimitPruneResult(empty, True, PRUNED_TO_0, before, 0)
    if before <= 1:
        return LimitPruneResult(scan, False, ALREADY_MINIMAL, before, before)
    assert scan.match is not None, "run filter pruning first"

    rows = stats.row_counts[scan.part_ids]
    full = scan.match == FULL_MATCH
    total_full_rows = int(rows[full].sum())

    if total_full_rows < k or not full.any():
        # Cannot prune; reorder fully-matching partitions to the front.
        order = np.argsort(~full, kind="stable")
        return LimitPruneResult(scan.reorder(order), False, NO_FULLY_MATCHING, before, before)

    # Greedy: biggest fully-matching partitions first -> minimal count.
    full_idx = np.where(full)[0]
    by_rows = full_idx[np.argsort(-rows[full_idx], kind="stable")]
    cum = np.cumsum(rows[by_rows])
    need = int(np.searchsorted(cum, k) + 1)
    chosen = np.sort(by_rows[:need])
    pruned = scan.keep(np.isin(np.arange(before), chosen))
    cat = PRUNED_TO_1 if need == 1 else PRUNED_TO_N
    return LimitPruneResult(pruned, True, cat, before, need)
