"""The comparison that decides ``correct``: each answer against the float64
reference, check by check.

An answer is ``{"scans": {alias: (part_ids, match)}, "tech": {alias:
{technique: (before, after, detail)}}, "topk": None | {"values",
"skipped", "scan"}}``, read from the program's report or made by
``Reference.answer``.  A failed check names the stage at fault: filter,
limit, join or topk.  Every check is exact, so each count's limit is 0.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .engine import FULL, NO, min_limit_partitions, probe_joins

CHECKS = ("unanswered", "filter", "limit", "join", "topk")


def _mask(ids: np.ndarray, P: int) -> np.ndarray:
    m = np.zeros(P, dtype=bool)
    m[ids] = True
    return m


def _same(ids: np.ndarray, want: np.ndarray, P: int) -> bool:
    """The same partitions (``ids`` already known to be distinct)."""
    return len(ids) == len(want) and bool(_mask(ids, P)[want].all())


def judge(ref, q, served) -> List[str]:
    """The checks this answer fails (empty: it is right)."""
    if served is None:
        return ["unanswered"]
    bad = set()
    scans, tech = served["scans"], served["tech"]
    if set(scans) != set(q.scans):
        return ["filter"]
    joins = probe_joins(q)
    plain_limit = (q.limit is not None and q.order_by is None
                   and not joins)
    for alias, (table, cons) in q.scans.items():
        v = ref.verdicts(table, cons)
        f_ids = np.flatnonzero(v > NO)
        ids, match = scans[alias]
        t = tech.get(alias, {})
        if (len(ids) and (ids.min() < 0 or ids.max() >= len(v)
                          or int(_mask(ids, len(v)).sum()) != len(ids)
                          or np.any(v[ids] == NO)
                          or not np.array_equal(v[ids], match))):
            bad.add("filter")
            continue
        if tuple(t.get("filter", (None, None))[:2]) != (len(v), len(f_ids)):
            bad.add("filter")
        if plain_limit:
            if not _limit_ok(ref, q, table, v, f_ids, ids, t):
                bad.add("limit")
        elif alias in joins:
            if not _join_ok(ref, q, alias, len(joins[alias]), f_ids, ids, t):
                bad.add("join")
        elif not _same(ids, f_ids, len(v)):
            bad.add("filter")
    if q.order_by is not None and q.limit is not None:
        if not _topk_ok(ref, q, served):
            bad.add("topk")
    return sorted(bad)


def _limit_ok(ref, q, table, v, f_ids, ids, t) -> bool:
    k = int(q.limit) + int(q.offset)
    if tuple(t.get("limit", (None, None))[:2]) != (len(f_ids), len(ids)):
        return False
    if k == 0:
        return len(ids) == 0
    if len(f_ids) <= 1:
        return _same(ids, f_ids, len(v))
    rows = ref.stats(table).rows
    need = min_limit_partitions(rows[f_ids[v[f_ids] == FULL]], k)
    if need is None:
        return _same(ids, f_ids, len(v))
    return (len(ids) == need and bool(np.all(v[ids] == FULL))
            and int(rows[ids].sum()) >= k)


def _join_ok(ref, q, probe, n_joins, f_ids, ids, t) -> bool:
    """The probe's kept set is the filter's less what its joins prune:
    every join's summary keeps each partition left (``probe_sets``); the
    report says (filter-kept, kept), and with one join its ``by_range``."""
    in_range, holds, kept = ref.probe_sets(q, probe)
    rep = t.get("join")
    if rep is None or tuple(rep[:2]) != (len(f_ids), len(ids)):
        return False
    detail = rep[2] if len(rep) > 2 else {}
    if (n_joins == 1 and "by_range" in detail
            and detail["by_range"] != int((~in_range[f_ids]).sum())):
        return False
    must = f_ids[holds[f_ids]]
    if not np.all(in_range[ids]) or not _mask(ids, len(holds))[must].all():
        return False
    return _same(ids, f_ids[kept[f_ids]], len(holds))


def _topk_ok(ref, q, served) -> bool:
    alias = q.order_by[0]
    top = served.get("topk")
    if top is None or top["scan"] != alias:
        return False
    values, kth, best = ref.topk_truth(q)
    if not np.array_equal(np.asarray(top["values"], dtype=np.float64),
                          values):
        return False
    ids = served["scans"][alias][0]
    skipped = np.asarray(top["skipped"], dtype=np.int64)
    P = len(best)
    if len(skipped) and (skipped.min() < 0 or skipped.max() >= P):
        return False
    sk = _mask(skipped, P)
    if int(sk.sum()) != len(skipped) or not _mask(ids, P)[skipped].all():
        return False
    if np.any(best[skipped] > kth):
        return False                    # skipped a partition it needed
    if not sk[ids[best[ids] < kth]].all():
        return False                    # scanned one the boundary excludes
    rep = served["tech"].get(alias, {}).get("topk")
    return rep is not None and tuple(rep[:2]) == (len(ids),
                                                  len(ids) - len(skipped))
