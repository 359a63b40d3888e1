"""Columnar tables split into micro-partitions (paper Sec. 2).

A ``Table`` is a PAX-style columnar store: each column is one contiguous
encoded array, horizontally sliced into micro-partitions at row boundaries
(``part_bounds``).  String columns are dictionary-encoded with an
order-preserving sorted dictionary (code order equals
lexicographic order, so min/max pruning semantics are preserved exactly).

Partition sizing: Snowflake micro-partitions hold 50–500MB uncompressed;
here the row count per partition plays that role and is configurable so
tests stay laptop-sized while benchmarks model realistic partition counts.

Streaming DML (incremental ingest)
----------------------------------
Micro-partitions are immutable in Snowflake: DML creates and drops whole
partitions.  The same model here:

  * ``append_partitions`` adds new partitions at the end (partition ids
    never shift);
  * ``drop_partitions`` tombstones partitions in place — rows stay in the
    arrays but the partition leaves the ``live`` mask and its stats become
    the empty-interval sentinel, so every pruning path sees it as empty;
  * ``rewrite_partitions`` replaces the rows of live partitions in place
    (same row counts, so ``part_bounds`` is stable);
  * ``update_column`` rewrites one column's values across the table.

Each mutation bumps ``version`` and logs a ``TableDelta`` so resident
device metadata planes (``core.device_stats``) can sync by staging only
the changed partitions instead of restaging ``[C, P]`` from scratch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.metadata import ColumnMeta, PartitionStats, TableDelta
from ..core.rowval import RowContext

# Replay horizon: deltas older than this are compacted away; a resident
# plane staged before ``delta_floor`` simply full-restages (always safe).
DELTA_LOG_LIMIT = 256


@dataclasses.dataclass
class Table:
    name: str
    columns: Dict[str, ColumnMeta]
    data: Dict[str, np.ndarray]          # encoded float64, full table
    nulls: Dict[str, np.ndarray]         # bool masks (absent = no nulls)
    part_bounds: np.ndarray              # [P+1] row offsets
    stats: PartitionStats
    # -- streaming-DML state (defaults keep static tables zero-cost) -------
    version: int = 0                     # bumped by every DML method
    live: Optional[np.ndarray] = None    # bool [P]; None = all live
    deltas: List[TableDelta] = dataclasses.field(default_factory=list)
    delta_floor: int = 0                 # oldest version replayable from

    @property
    def num_rows(self) -> int:
        return int(self.part_bounds[-1])

    @property
    def num_partitions(self) -> int:
        return len(self.part_bounds) - 1

    @property
    def live_mask(self) -> np.ndarray:
        """bool [P] of live partitions (materialized on first DML)."""
        if self.live is None:
            return np.ones(self.num_partitions, dtype=bool)
        return self.live

    @property
    def num_live_partitions(self) -> int:
        return int(self.live_mask.sum())

    def partition_rows(self, p: int) -> slice:
        return slice(int(self.part_bounds[p]), int(self.part_bounds[p + 1]))

    def partition_ctx(self, p: int) -> RowContext:
        s = self.partition_rows(p)
        return RowContext(
            self.columns,
            {k: v[s] for k, v in self.data.items()},
            {k: v[s] for k, v in self.nulls.items()},
        )

    def ctx_for(self, part_ids: Sequence[int]) -> RowContext:
        """RowContext over the concatenation of the given partitions."""
        idx = np.concatenate(
            [np.arange(self.part_bounds[p], self.part_bounds[p + 1]) for p in part_ids]
        ) if len(part_ids) else np.zeros(0, dtype=np.int64)
        return RowContext(
            self.columns,
            {k: v[idx] for k, v in self.data.items()},
            {k: v[idx] for k, v in self.nulls.items()},
        )

    def global_ctx(self) -> RowContext:
        return RowContext(self.columns, self.data, self.nulls)

    def decode(self, name: str, codes: np.ndarray):
        cm = self.columns[name]
        if cm.kind != "str":
            return codes
        return cm.dictionary[codes.astype(np.int64)]

    @staticmethod
    def build(
        name: str,
        raw: Dict[str, np.ndarray],
        rows_per_partition: int = 1000,
        nulls: Optional[Dict[str, np.ndarray]] = None,
        part_bounds: Optional[np.ndarray] = None,
    ) -> "Table":
        nulls = {k: np.asarray(v, dtype=bool) for k, v in (nulls or {}).items()}
        n = len(next(iter(raw.values())))
        for k, v in raw.items():
            if len(v) != n:
                raise ValueError(f"column {k!r} length mismatch")
        if part_bounds is None:
            bounds: List[int] = list(range(0, n, rows_per_partition)) + [n]
            if bounds[-2] == n:
                bounds.pop(-2)
            part_bounds = np.asarray(bounds, dtype=np.int64)
        else:
            part_bounds = np.asarray(part_bounds, dtype=np.int64)

        columns: Dict[str, ColumnMeta] = {}
        data: Dict[str, np.ndarray] = {}
        for cname, values in raw.items():
            values = np.asarray(values)
            if values.dtype.kind in ("U", "S", "O"):
                # the sorted unique values are the dictionary, and the
                # inverse index is each row's code: the same codes as
                # ColumnMeta.encode, without a second search over the rows
                dictionary, codes = np.unique(values.astype(str),
                                              return_inverse=True)
                cm = ColumnMeta(cname, "str", dictionary)
                data[cname] = codes.reshape(-1).astype(np.float64)
            elif values.dtype.kind in ("i", "u"):
                cm = ColumnMeta(cname, "int")
                data[cname] = values.astype(np.float64)
            else:
                cm = ColumnMeta(cname, "float")
                data[cname] = values.astype(np.float64)
            columns[cname] = cm

        stats = PartitionStats.from_columns(
            list(columns.values()), data, nulls, part_bounds
        )
        return Table(name, columns, data, nulls, part_bounds, stats)

    @staticmethod
    def from_arrays(
        name: str,
        columns,
        data: Dict[str, np.ndarray],
        nulls: Dict[str, np.ndarray],
        part_bounds: np.ndarray,
    ) -> "Table":
        """A table from already-encoded column arrays.

        ``columns`` maps each column name to an object with ``kind`` and
        ``dictionary`` attributes (this package's ``ColumnMeta`` or any
        equivalent), ``data`` holds the encoded float64 values, ``nulls``
        the bool null masks and ``part_bounds`` the ``[P+1]`` row offsets:
        the fields of a table built elsewhere, carried over as plain
        arrays.  The arrays are copied and the partition stats recomputed.
        """
        cols: Dict[str, ColumnMeta] = {}
        for cname, meta in columns.items():
            d = getattr(meta, "dictionary", None)
            cols[cname] = ColumnMeta(cname, meta.kind,
                                     None if d is None else np.array(d))
        enc = {k: np.array(data[k], dtype=np.float64) for k in cols}
        nmasks = {k: np.array(v, dtype=bool) for k, v in nulls.items()}
        bounds = np.array(part_bounds, dtype=np.int64)
        stats = PartitionStats.from_columns(list(cols.values()), enc, nmasks,
                                            bounds)
        return Table(name, cols, enc, nmasks, bounds, stats)

    # ---- streaming micro-partition DML ------------------------------------

    def _log(self, kind: str, **kw) -> None:
        self.version += 1
        self.deltas.append(TableDelta(version=self.version, kind=kind, **kw))
        while len(self.deltas) > DELTA_LOG_LIMIT:
            self.delta_floor = self.deltas.pop(0).version

    def _encode_batch(self, raw: Dict[str, np.ndarray],
                      nulls: Optional[Dict[str, np.ndarray]]):
        """Encode a row batch against the existing schema/dictionaries.

        String values must already be in the column's dictionary (the
        sorted dictionary is immutable — appending unseen strings would
        renumber codes under every resident plane); ``encode`` raises
        KeyError otherwise.
        """
        if set(raw) != set(self.columns):
            raise ValueError(
                f"append columns {sorted(raw)} != schema {sorted(self.columns)}")
        n = len(next(iter(raw.values())))
        enc: Dict[str, np.ndarray] = {}
        for cname, values in raw.items():
            if len(values) != n:
                raise ValueError(f"column {cname!r} length mismatch")
            enc[cname] = self.columns[cname].encode(values)
        nmasks = {k: np.asarray(v, dtype=bool)
                  for k, v in (nulls or {}).items()}
        return n, enc, nmasks

    def append_partitions(
        self,
        raw: Dict[str, np.ndarray],
        nulls: Optional[Dict[str, np.ndarray]] = None,
        rows_per_partition: Optional[int] = None,
    ) -> np.ndarray:
        """Append rows as new micro-partitions; returns the new ids.

        ``rows_per_partition=None`` packs the whole batch into one new
        partition (the streaming-ingest shape: one flush = one
        micro-partition)."""
        n, enc, nmasks = self._encode_batch(raw, nulls)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        if rows_per_partition is None:
            local_bounds = np.array([0, n], dtype=np.int64)
        else:
            local_bounds = np.asarray(
                list(range(0, n, rows_per_partition)) + [n], dtype=np.int64)
        new_stats = PartitionStats.from_columns(
            list(self.columns.values()), enc, nmasks, local_bounds)

        old_rows = self.num_rows
        old_p = self.num_partitions
        old_live = self.live_mask            # before bounds grow
        for cname in self.columns:
            self.data[cname] = np.concatenate([self.data[cname], enc[cname]])
        for cname in set(self.nulls) | set(nmasks):
            old = self.nulls.get(
                cname, np.zeros(old_rows, dtype=bool))
            new = nmasks.get(cname, np.zeros(n, dtype=bool))
            self.nulls[cname] = np.concatenate([old, new])
        self.part_bounds = np.concatenate(
            [self.part_bounds, old_rows + local_bounds[1:]])
        self.stats.append_rows(new_stats)
        self.live = np.concatenate(
            [old_live, np.ones(len(local_bounds) - 1, dtype=bool)])
        self._log("append", part_lo=old_p, part_hi=self.num_partitions)
        return np.arange(old_p, self.num_partitions, dtype=np.int64)

    def drop_partitions(self, part_ids: Sequence[int]) -> None:
        """Tombstone partitions in place (ids never shift)."""
        ids = np.unique(np.asarray(part_ids, dtype=np.int64))
        if ids.size == 0:
            return
        if ids[0] < 0 or ids[-1] >= self.num_partitions:
            raise IndexError(f"partition ids out of range: {ids}")
        if not self.live_mask[ids].all():
            raise ValueError("dropping an already-dropped partition")
        self.live = self.live_mask.copy()
        self.live[ids] = False
        self.stats.drop_rows(ids)
        self._log("drop", part_ids=tuple(int(i) for i in ids))

    def rewrite_partitions(
        self,
        part_ids: Sequence[int],
        raw: Dict[str, np.ndarray],
        nulls: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        """Replace the rows of live partitions in place.

        The replacement batch must carry exactly as many rows as the
        partitions hold (``part_bounds`` stays fixed); rows are assigned
        to partitions in the given ``part_ids`` order.
        """
        ids = np.asarray(part_ids, dtype=np.int64)
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate partition ids in rewrite")
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_partitions):
            raise IndexError(f"partition ids out of range: {ids}")
        if not self.live_mask[ids].all():
            raise ValueError("rewriting a dropped partition")
        sizes = np.diff(self.part_bounds)[ids]
        n, enc, nmasks = self._encode_batch(raw, nulls)
        if n != int(sizes.sum()):
            raise ValueError(
                f"rewrite rows ({n}) != partition rows ({int(sizes.sum())})")
        local_bounds = np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int64)
        new_stats = PartitionStats.from_columns(
            list(self.columns.values()), enc, nmasks, local_bounds)
        for bi, pid in enumerate(ids):
            src = slice(int(local_bounds[bi]), int(local_bounds[bi + 1]))
            dst = self.partition_rows(int(pid))
            for cname in self.columns:
                self.data[cname][dst] = enc[cname][src]
            for cname in set(self.nulls) | set(nmasks):
                if cname not in self.nulls:
                    self.nulls[cname] = np.zeros(self.num_rows, dtype=bool)
                self.nulls[cname][dst] = nmasks.get(
                    cname, np.zeros(n, dtype=bool))[src]
        self.stats.rewrite_rows(ids, new_stats)
        self._log("rewrite", part_ids=tuple(int(i) for i in ids))

    def update_column(
        self,
        column: str,
        values: np.ndarray,
        nulls: Optional[np.ndarray] = None,
    ) -> None:
        """Rewrite one column's values across the whole table.

        Column-scoped on purpose: resident per-column device planes of
        *other* columns stay valid, and the ``[C, P]`` stat planes sync
        by restaging only this column's rows.
        """
        cm = self.columns[column]
        if len(values) != self.num_rows:
            raise ValueError("update_column needs one value per row")
        self.data[column] = cm.encode(values)
        if nulls is not None:
            self.nulls[column] = np.asarray(nulls, dtype=bool)
        elif column in self.nulls:
            self.nulls[column] = np.zeros(self.num_rows, dtype=bool)
        ci = self.stats.col_id(column)
        vals = self.data[column]
        nmask = self.nulls.get(column)
        # every live partition's non-null min / max and null count, one
        # segmented reduction per statistic; a partition with no non-null
        # row gets the empty interval, a dropped one keeps its sentinel
        P = self.num_partitions
        rows = np.diff(self.part_bounds) > 0
        starts = self.part_bounds[:-1][rows]
        lo, hi = vals, vals
        nulls = np.zeros(P, dtype=np.int64)
        if nmask is not None:
            lo = np.where(nmask, np.inf, vals)
            hi = np.where(nmask, -np.inf, vals)
            nulls[rows] = np.add.reduceat(nmask.astype(np.int64), starts)
        mins = np.full(P, np.inf)
        maxs = np.full(P, -np.inf)
        if starts.size:
            mins[rows] = np.minimum.reduceat(lo, starts)
            maxs[rows] = np.maximum.reduceat(hi, starts)
        live = self.live_mask
        self.stats.null_counts[live, ci] = nulls[live]
        self.stats.mins[live, ci] = mins[live]
        self.stats.maxs[live, ci] = maxs[live]
        self._log("update", column=column)
