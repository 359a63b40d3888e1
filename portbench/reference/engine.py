"""Partition metadata and query semantics, computed from the raw arrays."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .bloom import bloom_keep

NO, PARTIAL, FULL = 0, 1, 2


def identity(x: np.ndarray) -> np.ndarray:
    return x


def to_bfloat16(x) -> np.ndarray:
    """float64 -> bfloat16 (round to nearest even through float32), held
    as float64: the precision of the control."""
    f = np.asarray(x, dtype=np.float64).astype(np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


PRECISIONS: Dict[str, Callable] = {"float64": identity,
                                   "bfloat16": to_bfloat16}


@dataclasses.dataclass
class Stats:
    """One table's per-partition metadata: min and max of every column
    (no nulls are generated), and rows a partition."""

    mins: Dict[str, np.ndarray]
    maxs: Dict[str, np.ndarray]
    rows: np.ndarray

    @property
    def num_partitions(self) -> int:
        return len(self.rows)


def table_stats(raw, rnd=identity) -> Stats:
    bounds = raw.bounds
    starts = bounds[:-1]
    mins = {c: rnd(np.minimum.reduceat(col.values, starts))
            for c, col in raw.columns.items()}
    maxs = {c: rnd(np.maximum.reduceat(col.values, starts))
            for c, col in raw.columns.items()}
    return Stats(mins, maxs, np.diff(bounds))


def interval(raw, col: str, op: str, v, rnd=identity
             ) -> Tuple[float, bool, float, bool]:
    """The constraint as (lo, lo_strict, hi, hi_strict) over the column's
    encoded values (dictionary codes for strings, whose ge / gt / le / lt
    follow the dictionary's order); an empty interval has lo = +inf."""
    inf = np.inf
    c = raw.columns[col]
    if c.kind == "str":
        d = c.dictionary
        if op in ("ge", "gt", "le", "lt"):
            lo, hi = 0, len(d) - 1
            if op in ("ge", "gt"):
                lo = int(np.searchsorted(d, v, "left" if op == "ge"
                                         else "right"))
            else:
                hi = int(np.searchsorted(d, v, "right" if op == "le"
                                         else "left")) - 1
            hit = np.arange(lo, hi + 1)
        elif op == "eq":
            hit = np.flatnonzero(d == v)
        elif op in ("prefix", "like"):
            p = v[:-1] if op == "like" else v
            if op == "like" and (not v.endswith("%") or "%" in p):
                raise ValueError(f"only trailing-% LIKE patterns: {v!r}")
            hit = np.flatnonzero(np.char.startswith(d, p))
        else:
            raise ValueError(f"{op!r} on a string column")
        if hit.size == 0:
            return inf, False, -inf, False
        return float(hit[0]), False, float(hit[-1]), False
    x = float(rnd(np.array([v], dtype=np.float64))[0])
    if op == "ge":
        return x, False, inf, False
    if op == "gt":
        return x, True, inf, False
    if op == "le":
        return -inf, False, x, False
    if op == "lt":
        return -inf, False, x, True
    if op == "eq":
        return x, False, x, False
    raise ValueError(f"unknown op {op!r}")


def in_set(raw, col: str, values, rnd=identity) -> np.ndarray:
    """An ``in`` list as the sorted distinct encoded values it admits
    (strings absent from the dictionary admit nothing)."""
    c = raw.columns[col]
    if c.kind == "str":
        d = c.dictionary
        v = np.asarray(list(values), dtype=str)   # no truncation
        codes = np.minimum(np.searchsorted(d, v), len(d) - 1)
        return np.unique(codes[d[codes] == v]).astype(np.float64)
    return np.unique(rnd(np.asarray(values, dtype=np.float64)))


def _above(x, lo, strict):
    return x > lo if strict else x >= lo


def _below(x, hi, strict):
    return x < hi if strict else x <= hi


def verdicts(raw, stats: Stats, cons, rnd=identity) -> np.ndarray:
    """int8 [P]: each partition's three-valued verdict, AND as the min."""
    v = np.full(stats.num_partitions, FULL, dtype=np.int8)
    for col, op, val in cons:
        pmin, pmax = stats.mins[col], stats.maxs[col]
        if op == "in":
            # NO when no set value lies in [min, max]; FULL when min = max
            # is in the set
            s = in_set(raw, col, val, rnd)
            no = (np.searchsorted(s, pmax, "right")
                  == np.searchsorted(s, pmin, "left"))
            full = (pmin == pmax) & ~no
        else:
            lo, los, hi, his = interval(raw, col, op, val, rnd)
            no = ~_above(pmax, lo, los) | ~_below(pmin, hi, his)
            full = _above(pmin, lo, los) & _below(pmax, hi, his)
        t = np.where(no, NO, np.where(full, FULL, PARTIAL)).astype(np.int8)
        np.minimum(v, t, out=v)
    return v


def row_mask(raw, cons, rnd=identity, idx=None) -> np.ndarray:
    """bool [rows]: the rows (or the rows ``idx``) that satisfy the
    constraints."""
    m = np.ones(raw.num_rows if idx is None else len(idx), dtype=bool)
    for col, op, val in cons:
        x = raw.columns[col].values
        x = rnd(x if idx is None else x[idx])
        if op == "in":
            m &= np.isin(x, in_set(raw, col, val, rnd))
            continue
        lo, los, hi, his = interval(raw, col, op, val, rnd)
        m &= _above(x, lo, los) & _below(x, hi, his)
    return m


def probe_joins(q) -> Dict[str, List[tuple]]:
    """The query's joins by probe scan.  A star join only: a scan that is
    a build side may not be a probe."""
    joins = q.all_joins
    builds = {j[0] for j in joins}
    out: Dict[str, List[tuple]] = {}
    for j in joins:
        if j[1] in builds:
            raise ValueError(f"query {q.index} ({q.kind}): scan {j[1]!r} is "
                             f"both a build side and a probe; only star "
                             f"joins are judged")
        out.setdefault(j[1], []).append(j)
    return out


def rows_of(bounds: np.ndarray, parts: np.ndarray) -> np.ndarray:
    """The row indices of partitions ``parts``, in their order."""
    lengths = bounds[parts + 1] - bounds[parts]
    offsets = np.cumsum(lengths) - lengths
    return (np.repeat(bounds[parts] - offsets, lengths)
            + np.arange(int(lengths.sum())))


class Reference:
    """Per-run cache of stats, verdicts and join keys over the raw tables,
    in one precision (``float64`` is the truth, ``bfloat16`` the
    control)."""

    def __init__(self, tables: Dict[str, object], config: dict,
                 precision: str = "float64"):
        self.tables = tables
        self.rnd = PRECISIONS[precision]
        g = config.get("guarantees", {})
        self.exact_ndv = int(g.get("join_exact_ndv", 0))
        self.bloom = g.get("join_bloom", {})
        self._stats: Dict[str, Stats] = {}
        self._keys: Dict[Tuple, np.ndarray] = {}
        self._join: Dict[Tuple, Tuple] = {}

    def stats(self, table: str) -> Stats:
        if table not in self._stats:
            self._stats[table] = table_stats(self.tables[table], self.rnd)
        return self._stats[table]

    def verdicts(self, table: str, cons) -> np.ndarray:
        return verdicts(self.tables[table], self.stats(table), cons,
                        self.rnd)

    def rows(self, table: str, cons) -> np.ndarray:
        return row_mask(self.tables[table], cons, self.rnd)

    def _build_key(self, q, j) -> Tuple:
        table, cons = q.scans[j[0]]
        return (table, tuple(cons), j[2])

    def build_keys(self, q, j=None) -> np.ndarray:
        """Sorted distinct join keys of the build side's matching rows (of
        join ``j``, by default the query's one join)."""
        j = j or q.join
        table, cons = q.scans[j[0]]
        key = self._build_key(q, j)
        if key not in self._keys:
            vals = self.rnd(self.tables[table].columns[j[2]].values)
            self._keys[key] = np.unique(vals[self.rows(table, cons)])
        return self._keys[key]

    def key_ranges(self, q, j=None) -> Tuple[np.ndarray, np.ndarray]:
        j = j or q.join
        st = self.stats(q.scans[j[1]][0])
        return st.mins[j[3]], st.maxs[j[3]]

    def join_sets(self, q, j=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Over the probe's partitions, for join ``j`` (by default the
        query's one join): in the build keys' range, holding a build key,
        and kept by the build side's summary (the distinct keys up to
        ``join_exact_ndv`` of them, else the Bloom summary).  Cached by
        join, so a build predicate that repeats is summarised once."""
        j = j or q.join
        ck = (self._build_key(q, j), q.scans[j[1]][0], j[3])
        if ck not in self._join:
            self._join[ck] = self._join_sets(q, j)
        return self._join[ck]

    def probe_sets(self, q, probe: str
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``join_sets`` for the scan ``probe`` over all its joins, each
        set the AND of the joins' sets: a partition is kept only where
        every join's summary keeps it."""
        sets = [self.join_sets(q, j) for j in probe_joins(q)[probe]]
        if len(sets) == 1:
            return sets[0]
        return tuple(np.logical_and.reduce([s[i] for s in sets])
                     for i in range(3))

    def _join_sets(self, q, j) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        keys = self.build_keys(q, j)
        pmin, pmax = self.key_ranges(q, j)
        if keys.size == 0:
            none = np.zeros(len(pmin), dtype=bool)
            return none, none, none
        in_range = (pmax >= keys[0]) & (pmin <= keys[-1])
        holds = (np.searchsorted(keys, pmax, side="right")
                 > np.searchsorted(keys, pmin, side="left"))
        if keys.size <= self.exact_ndv:
            return in_range, holds, holds
        probe, col = q.scans[j[1]][0], j[3]
        integer = self.tables[probe].columns[col].kind != "float"
        kept = bloom_keep(keys, pmin, pmax, in_range, integer,
                          int(self.bloom["bits_per_key"]),
                          int(self.bloom["enum_limit"]))
        return in_range, holds, kept

    def topk_truth(self, q) -> Tuple[np.ndarray, float, np.ndarray]:
        """(the true top-k values best first, the signed k-th value or -inf
        when fewer rows match, every partition's signed best value).

        Only rows of partitions whose best value can reach the k-th are
        read: the partitions the filter keeps, best first, are taken in
        doubling prefixes until their matching rows hold k values; the
        k-th of those bounds the true k-th from below, so every row that
        can be in the top k lies in a kept partition whose best is at
        least that bound, and the top k is taken over all of those."""
        alias, col, desc = q.order_by
        table, cons = q.scans[alias]
        raw = self.tables[table]
        sign = 1.0 if desc else -1.0
        st = self.stats(table)
        best = st.maxs[col] if desc else -st.mins[col]
        k = int(q.limit) + int(q.offset)
        live = np.flatnonzero(self.verdicts(table, cons) > NO)
        live = live[np.argsort(-best[live], kind="stable")]
        m = min(64, len(live))
        while True:
            signed = self._signed(q, raw, col, sign, live[:m])
            if signed.size >= k or m == len(live):
                break
            m = min(2 * m, len(live))
        if signed.size >= k and k > 0:
            bound = float(np.partition(signed, signed.size - k)
                          [signed.size - k])
            signed = self._signed(q, raw, col, sign, live[best[live] >= bound])
        if signed.size >= k:
            kth = float(np.partition(signed, signed.size - k)
                        [signed.size - k]) if k > 0 else np.inf
            top = np.sort(signed[signed >= kth])[::-1][:k]
        else:
            kth = -np.inf
            top = np.sort(signed)[::-1]
        return sign * top, kth, best

    def _signed(self, q, raw, col: str, sign: float,
                parts: np.ndarray) -> np.ndarray:
        """Signed order values of the matching rows of ``parts`` (through
        each join's build keys where the ordered scan is its probe)."""
        alias = q.order_by[0]
        table, cons = q.scans[alias]
        idx = rows_of(raw.bounds, np.sort(parts))
        mask = row_mask(raw, cons, self.rnd, idx)
        for j in probe_joins(q).get(alias, ()):
            kv = self.rnd(raw.columns[j[3]].values[idx])
            mask &= np.isin(kv, self.build_keys(q, j))
        return sign * self.rnd(raw.columns[col].values[idx][mask])

    # -- the reference's own answers (the control runs these in bfloat16) --

    def answer(self, q) -> dict:
        """This precision's answer to the query, in the form ``judge`` reads:
        kept scan sets with their verdicts, technique counts, top-k."""
        scans, tech = {}, {}
        for alias, (table, cons) in q.scans.items():
            v = self.verdicts(table, cons)
            ids = np.flatnonzero(v > NO)
            scans[alias] = (ids, v[ids])
            tech[alias] = {"filter": (len(v), len(ids), {})}
        joins = probe_joins(q)
        if q.limit is not None and q.order_by is None and not joins:
            for alias, (table, _cons) in q.scans.items():
                ids, match = scans[alias]
                keep = self._limit_keep(table, ids, match,
                                        q.limit + q.offset)
                scans[alias] = (ids[keep], match[keep])
                tech[alias]["limit"] = (len(ids), int(keep.sum()), {})
        for probe, js in joins.items():
            ids, match = scans[probe]
            in_range, _holds, kept = self.probe_sets(q, probe)
            keep = kept[ids]
            scans[probe] = (ids[keep], match[keep])
            tech[probe]["join"] = (
                len(ids), int(keep.sum()),
                {"by_range": int((~in_range[ids]).sum())} if len(js) == 1
                else {})
        topk = None
        if q.order_by is not None and q.limit is not None:
            alias = q.order_by[0]
            values, kth, best = self.topk_truth(q)
            ids = scans[alias][0]
            skipped = ids[best[ids] < kth]
            tech[alias]["topk"] = (len(ids), len(ids) - len(skipped), {})
            topk = {"values": values, "skipped": skipped, "scan": alias}
        return {"scans": scans, "tech": tech, "topk": topk}

    def _limit_keep(self, table: str, ids, match, k: int) -> np.ndarray:
        keep = np.ones(len(ids), dtype=bool)
        if k == 0:
            return ~keep
        if len(ids) <= 1:
            return keep
        rows = self.stats(table).rows[ids]
        full = np.flatnonzero(match == FULL)
        if full.size == 0 or rows[full].sum() < k:
            return keep
        order = full[np.lexsort((ids[full], -rows[full]))]
        need = int(np.searchsorted(np.cumsum(rows[order]), k) + 1)
        keep[:] = False
        keep[order[:need]] = True
        return keep


def min_limit_partitions(rows_full: np.ndarray, k: int) -> Optional[int]:
    """Fewest fully-matching partitions whose rows reach k (None: cannot)."""
    if rows_full.size == 0 or rows_full.sum() < k:
        return None
    return int(np.searchsorted(np.cumsum(np.sort(rows_full)[::-1]), k) + 1)

