"""Predicate caching for top-k queries (paper Sec. 8.2).

The paper *proposes* extending Schmidt et al.'s predicate caching to top-k:
record the micro-partitions contributing tuples to the final top-k heap;
on a repeat of the same plan shape, scan only those partitions.  Built
here with the paper's DML semantics:

  * INSERT            — safe: new partitions (appended after the cached
                        version) are added to the cached scan set;
  * UPDATE (non-order
    column)           — safe: row membership in the top-k is unchanged;
  * UPDATE (order col)— unsafe: invalidate (reordering may promote rows
                        outside the cached partitions);
  * DELETE            — unsafe: invalidate (the k+1-th row may live
                        elsewhere — the paper's exact argument).

Capacity-bounded LRU: evicting is always safe (a miss falls back to
boundary pruning).  Host-only, as in the JAX package: it stores partition
ids, and consumes ``prune_topk.TopKResult.sources``.

``TableVersion`` is also the minimal version record a caller can hand to
``core.device_stats.DeviceStatsCache.get``: a bump forces a restage.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from . import expr as E


def plan_key(table_name: str, pred: Optional[E.Pred], order_col: str,
             desc: bool, k: int) -> Tuple:
    """The paper keys the cache by query-plan shape (its Fig. 12 metric).

    Predicates are canonicalized (``expr.canonical_key``) so commutative
    conjunct orderings and ``1`` vs ``1.0`` literals of one predicate
    share a key instead of always missing.
    """
    return (table_name, E.canonical_key(pred), order_col, desc, k)


@dataclasses.dataclass
class CacheEntry:
    part_ids: np.ndarray        # contributing partitions at record time
    version: int                # table version when recorded
    num_partitions: int         # partition count at record time
    pred_cols: Tuple[str, ...] = ()   # columns the cached predicate reads
    has_delta_log: bool = False       # recorded against a Table delta log


class TableVersion:
    """Minimal DML bookkeeping a table exposes to the cache."""

    def __init__(self, num_partitions: int):
        self.version = 0
        self.num_partitions = num_partitions

    def insert_partitions(self, n: int) -> None:
        self.version += 1
        self.num_partitions += n


class PredicateCache:
    def __init__(self, max_entries: int = 128):
        self.entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def lookup(self, key: Tuple, tv: TableVersion,
               table=None) -> Optional[np.ndarray]:
        """Partitions sufficient for this plan, or None on miss.

        INSERT-safety: partitions appended after the entry was recorded
        are unioned in (they may hold better rows).  When the entry was
        recorded against a ``data.table.Table`` (``record(..., table=)``)
        freshness is keyed on its ``TableDelta`` log and live mask:
        appends contribute exactly the logged ``[part_lo, part_hi)``
        slots, drops are masked out (tombstoned ids never resurrect),
        and an unsafe step since record time (rewrite, update of the
        order or a predicate column, compacted-away log) is a miss.  The
        raw-count arange is only the legacy ``TableVersion`` path, and
        even there a shrunken count (drop-then-append overlap) misses
        instead of resurrecting dropped ids.
        """
        e = self.entries.get(key)
        if e is None:
            self.misses += 1
            return None
        if e.has_delta_log and table is not None:
            ids = self._replay_deltas(key, e, table)
            if ids is None:
                self.misses += 1
                return None
            self.entries.move_to_end(key)
            self.hits += 1
            return ids
        if tv.num_partitions < e.num_partitions:
            # The table shrank below the recorded count: the dense-growth
            # assumption is broken, so the arange union would be wrong.
            del self.entries[key]
            self.misses += 1
            return None
        self.entries.move_to_end(key)
        self.hits += 1
        fresh = np.arange(e.num_partitions, tv.num_partitions, dtype=np.int64)
        return np.concatenate([e.part_ids, fresh])

    def _replay_deltas(self, key: Tuple, e: CacheEntry,
                       table) -> Optional[np.ndarray]:
        """Delta-log freshness: cached ids + logged appends, live-masked."""
        if e.version < getattr(table, "delta_floor", 0):
            del self.entries[key]   # log compacted past the entry
            return None
        fresh: list = []
        for d in table.deltas:
            if d.version <= e.version:
                continue
            if d.kind == "append":
                fresh.append(np.arange(d.part_lo, d.part_hi, dtype=np.int64))
            elif d.kind == "drop":
                continue            # live mask handles tombstones below
            elif d.kind == "update" and d.column != key[2] \
                    and d.column not in e.pred_cols:
                continue            # touches neither order nor predicate
            else:                   # rewrite / unsafe update / unknown
                del self.entries[key]
                return None
        ids = np.concatenate([e.part_ids] + fresh) if fresh else e.part_ids
        live = np.asarray(table.live_mask, dtype=bool)
        ids = np.unique(ids)
        return ids[live[ids]]

    def record(self, key: Tuple, contributing: np.ndarray,
               tv: TableVersion, pred: Optional[E.Pred] = None,
               table=None) -> None:
        cols = pred.columns() if isinstance(pred, (E.Pred, E.Expr)) else ()
        version = int(table.version) if table is not None else tv.version
        self.entries[key] = CacheEntry(
            np.asarray(contributing, dtype=np.int64), version,
            tv.num_partitions, pred_cols=tuple(cols),
            has_delta_log=table is not None and hasattr(table, "deltas"))
        self.entries.move_to_end(key)
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)

    # ---- DML hooks (the paper's safety analysis) -------------------------

    def on_insert(self, table_name: str) -> None:
        """Safe — handled incrementally in lookup()."""

    def on_update(self, table_name: str, column: str) -> None:
        """Invalidate entries whose *order column* or *predicate* reads
        the updated column — a predicate-only update still changes which
        partitions contribute (the stale set can return a wrong top-k)."""
        stale = [k for k, e in self.entries.items()
                 if k[0] == table_name
                 and (k[2] == column or column in e.pred_cols)]
        for k in stale:
            del self.entries[k]

    def on_delete(self, table_name: str) -> None:
        self._invalidate_table(table_name)

    def _invalidate_table(self, table_name: str) -> None:
        stale = [k for k in self.entries if k[0] == table_name]
        for k in stale:
            del self.entries[k]

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
