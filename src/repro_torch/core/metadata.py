"""Partition-level metadata: the substrate every pruning technique reads.

Mirrors Snowflake's metadata service (Sec. 2): per micro-partition and per
column we keep min / max / null_count, plus per-partition row counts.  The
stats are stored as *packed dense arrays* (``[P, C]``) rather than
per-partition objects so that a pruning pass is a branch-free vectorized
evaluation, on the host here and on the GPU once staged as resident
planes (``core.device_stats``).

All value columns are widened to float64:  int64 values and dictionary
codes are exact in float64 up to 2**53, far beyond any dictionary or
realistic integer-key domain used here; genuinely large int64 key spaces
would use a dedicated int path (not needed for the paper's workloads).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Three-valued match lattice: AND=min, OR=max, NOT=2-x.
NO_MATCH = 0        # no row in the partition can satisfy the predicate
PARTIAL_MATCH = 1   # some row may satisfy it (must scan)
FULL_MATCH = 2      # every row is guaranteed to satisfy it (Sec. 4.2)


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    """Static, table-level column description."""

    name: str
    kind: str                                  # 'int' | 'float' | 'str'
    dictionary: Optional[np.ndarray] = None    # sorted str array (kind='str')

    def __post_init__(self):
        if self.kind not in ("int", "float", "str"):
            raise ValueError(f"unknown column kind {self.kind!r}")
        if self.kind == "str" and self.dictionary is None:
            raise ValueError(f"str column {self.name!r} needs a dictionary")

    def encode(self, values) -> np.ndarray:
        """Encode raw values to the numeric domain used by the metadata."""
        if self.kind != "str":
            return np.asarray(values, dtype=np.float64)
        idx = np.searchsorted(self.dictionary, np.asarray(values, dtype=self.dictionary.dtype))
        idx = np.clip(idx, 0, len(self.dictionary) - 1)
        ok = self.dictionary[idx] == np.asarray(values)
        if not np.all(ok):
            missing = np.asarray(values)[~ok][:3]
            raise KeyError(f"values not in dictionary for {self.name!r}: {missing}")
        return idx.astype(np.float64)

    def prefix_code_range(self, prefix: str):
        """Dictionary-code interval covering every string with ``prefix``.

        Exact because the dictionary is sorted: lexicographic order equals
        code order, and v startswith p  <=>  p <= v < p + chr(maxchar).
        Returns (lo, hi) inclusive, or None if no dictionary entry matches.
        """
        if self.kind != "str":
            raise TypeError("prefix_code_range only valid for str columns")
        d = self.dictionary
        lo = int(np.searchsorted(d, prefix, side="left"))
        hi = int(np.searchsorted(d, prefix + "￿", side="right")) - 1
        if lo > hi:
            return None
        return float(lo), float(hi)


@dataclasses.dataclass(frozen=True)
class TableDelta:
    """One logged DML step, replayable by resident metadata planes.

    The device cache (``core.device_stats.DeviceStatsCache``) consumes
    these to bring staged planes up to the table's current version by
    staging only the changed partitions (appends write ``[C, ΔP]``
    columns, drops scatter no-op sentinels) instead of restaging the
    whole ``[C, P]`` plane.  A ``rewrite`` is the one kind that always
    forces a full restage (arbitrary in-place row changes).
    """

    version: int                       # table version AFTER this step
    kind: str                          # 'append' | 'drop' | 'rewrite' | 'update'
    part_lo: int = 0                   # append: [part_lo, part_hi) new ids
    part_hi: int = 0
    part_ids: Tuple[int, ...] = ()     # drop / rewrite targets
    column: str = ""                   # update: the rewritten column


@dataclasses.dataclass
class PartitionStats:
    """Packed per-partition metadata arrays; the pruning engine's input.

    mins/maxs/null_counts are ``[P, C]``; row_counts is ``[P]``.
    A fully-null column within a partition is encoded with min=+inf,
    max=-inf (an empty interval), which makes every range test evaluate
    to NO_MATCH for that partition — the correct SQL semantics, because
    a NULL never satisfies a comparison.  Dropped partitions reuse the
    same sentinel (plus null/row counts of 0), so every range test and
    the LIMIT cutter see them as empty.
    """

    columns: List[ColumnMeta]
    mins: np.ndarray
    maxs: np.ndarray
    null_counts: np.ndarray
    row_counts: np.ndarray

    _uid_counter = itertools.count()

    def __post_init__(self):
        P, C = self.mins.shape
        assert self.maxs.shape == (P, C) and self.null_counts.shape == (P, C)
        assert self.row_counts.shape == (P,)
        assert len(self.columns) == C
        self._col_index = {c.name: i for i, c in enumerate(self.columns)}
        # Process-unique identity: lets caches (device_stats) distinguish a
        # rebuilt table from the one they staged, even at equal name/shape.
        self.uid = next(PartitionStats._uid_counter)

    @property
    def num_partitions(self) -> int:
        return self.mins.shape[0]

    @property
    def num_columns(self) -> int:
        return self.mins.shape[1]

    def col_id(self, name: str) -> int:
        try:
            return self._col_index[name]
        except KeyError:
            raise KeyError(f"unknown column {name!r}; have {list(self._col_index)}")

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self.col_id(name)]

    def col_min(self, name: str) -> np.ndarray:
        return self.mins[:, self.col_id(name)]

    def col_max(self, name: str) -> np.ndarray:
        return self.maxs[:, self.col_id(name)]

    def col_has_nulls(self, name: str) -> np.ndarray:
        return self.null_counts[:, self.col_id(name)] > 0

    def select(self, part_ids: np.ndarray) -> "PartitionStats":
        """Stats restricted to a subset of partitions (scan-set refinement)."""
        return PartitionStats(
            columns=self.columns,
            mins=self.mins[part_ids],
            maxs=self.maxs[part_ids],
            null_counts=self.null_counts[part_ids],
            row_counts=self.row_counts[part_ids],
        )

    # ---- incremental DML (streaming micro-partition ingest) ---------------
    # These mutate the arrays IN PLACE, preserving ``uid``: the table stays
    # the same identity and resident device planes sync via the delta log
    # (``TableDelta``) instead of restaging from scratch.

    def append_rows(self, other: "PartitionStats") -> None:
        """Append another stats block's partitions (same column schema)."""
        assert [c.name for c in other.columns] == [c.name for c in self.columns]
        self.mins = np.concatenate([self.mins, other.mins], axis=0)
        self.maxs = np.concatenate([self.maxs, other.maxs], axis=0)
        self.null_counts = np.concatenate(
            [self.null_counts, other.null_counts], axis=0)
        self.row_counts = np.concatenate(
            [self.row_counts, other.row_counts], axis=0)

    def drop_rows(self, part_ids: np.ndarray) -> None:
        """Mark partitions dropped: empty-interval sentinel, zero counts.

        The sentinel makes every range test NO_MATCH and contributes no
        rows to LIMIT arithmetic; resident device planes replay the same
        sentinel without reshaping (no partition renumbering)."""
        ids = np.asarray(part_ids, dtype=np.int64)
        self.mins[ids] = np.inf
        self.maxs[ids] = -np.inf
        self.null_counts[ids] = 0
        self.row_counts[ids] = 0

    def rewrite_rows(self, part_ids: np.ndarray,
                     other: "PartitionStats") -> None:
        """Replace the stat rows of ``part_ids`` with ``other``'s rows."""
        ids = np.asarray(part_ids, dtype=np.int64)
        self.mins[ids] = other.mins
        self.maxs[ids] = other.maxs
        self.null_counts[ids] = other.null_counts
        self.row_counts[ids] = other.row_counts

    @staticmethod
    def from_columns(
        columns: Sequence[ColumnMeta],
        encoded: Dict[str, np.ndarray],
        null_masks: Dict[str, np.ndarray],
        part_bounds: np.ndarray,
    ) -> "PartitionStats":
        """Build stats from encoded column data.

        part_bounds: ``[P+1]`` row offsets delimiting each partition.

        One segmented reduction per column (``ufunc.reduceat`` over the
        non-empty partitions' row offsets) instead of a Python loop over
        partitions.  Null rows are replaced by the reduction's identity
        (+inf for min, -inf for max), so an all-null or empty partition
        keeps the empty interval (+inf, -inf), exactly as a per-partition
        loop leaves it.
        """
        bounds = np.asarray(part_bounds, dtype=np.int64)
        P = len(bounds) - 1
        C = len(columns)
        mins = np.full((P, C), np.inf)
        maxs = np.full((P, C), -np.inf)
        nulls = np.zeros((P, C), dtype=np.int64)
        rows = np.diff(bounds).astype(np.int64)
        nonempty = np.nonzero(rows > 0)[0]
        if nonempty.size == 0:
            return PartitionStats(list(columns), mins, maxs, nulls, rows)
        lo, hi = int(bounds[0]), int(bounds[-1])
        # empty partitions hold no rows, so each non-empty partition's
        # segment runs from its start to the next non-empty start
        starts = bounds[nonempty] - lo
        for ci, col in enumerate(columns):
            vals = np.asarray(encoded[col.name], dtype=np.float64)[lo:hi]
            nmask = null_masks.get(col.name)
            if nmask is None:
                vmin = vmax = vals
            else:
                m = np.asarray(nmask, dtype=bool)[lo:hi]
                nulls[nonempty, ci] = np.add.reduceat(m.astype(np.int64),
                                                      starts)
                vmin = np.where(m, np.inf, vals)
                vmax = np.where(m, -np.inf, vals)
            mins[nonempty, ci] = np.minimum.reduceat(vmin, starts)
            maxs[nonempty, ci] = np.maximum.reduceat(vmax, starts)
        return PartitionStats(list(columns), mins, maxs, nulls, rows)


@dataclasses.dataclass
class ScanSet:
    """The set of partitions a table scan must process (Sec. 2).

    ``part_ids`` is ordered — runtime techniques (top-k) are sensitive to
    processing order, and LIMIT pruning reorders fully-matching partitions
    to the front.  ``match`` carries the three-valued result per partition
    (aligned with part_ids) so later stages can reuse it.
    """

    part_ids: np.ndarray
    match: Optional[np.ndarray] = None

    def __post_init__(self):
        self.part_ids = np.asarray(self.part_ids, dtype=np.int64)
        if self.match is not None:
            self.match = np.asarray(self.match, dtype=np.int8)
            assert self.match.shape == self.part_ids.shape

    def __len__(self) -> int:
        return int(self.part_ids.size)

    @staticmethod
    def full(num_partitions: int) -> "ScanSet":
        return ScanSet(
            np.arange(num_partitions, dtype=np.int64),
            np.full(num_partitions, FULL_MATCH, dtype=np.int8),
        )

    def keep(self, mask: np.ndarray) -> "ScanSet":
        return ScanSet(
            self.part_ids[mask],
            None if self.match is None else self.match[mask],
        )

    def reorder(self, order: np.ndarray) -> "ScanSet":
        return ScanSet(
            self.part_ids[order],
            None if self.match is None else self.match[order],
        )


def live_full_scan(table) -> ScanSet:
    """Every *live* partition of a table, FULL-matching.

    The TruePred result under streaming DML: dropped partitions are
    tombstoned in place (partition ids never shift), so a full scan is
    the live mask, not ``range(P)``.  Tables without DML support (no
    ``live`` mask, or one never materialized) are fully live and get the
    classic ``ScanSet.full``.
    """
    live = getattr(table, "live", None)
    if live is None:
        return ScanSet.full(table.num_partitions)
    ids = np.where(np.asarray(live, dtype=bool))[0].astype(np.int64)
    return ScanSet(ids, np.full(ids.size, FULL_MATCH, dtype=np.int8))


def mask_dead_partitions(tv: np.ndarray, table) -> np.ndarray:
    """Force NO_MATCH on dropped partitions of a ``[P]`` match vector.

    Metadata sentinels make most predicates NO_MATCH on dropped
    partitions already, but not all (``NOT (x > 5)`` is FULL on an empty
    interval under the three-valued lattice), so the filter stage masks
    explicitly — identically on the host and device paths, keeping them
    bit-identical.
    """
    live = getattr(table, "live", None)
    if live is None:
        return tv
    return np.where(np.asarray(live, dtype=bool), tv,
                    NO_MATCH).astype(np.int8)


def pruning_ratio(before: int, after: int) -> float:
    """Fraction of partitions removed (the paper's headline metric)."""
    if before == 0:
        return 0.0
    return 1.0 - after / before
