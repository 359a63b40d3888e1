"""Filter pruning: three-valued predicate evaluation over partition stats.

This is the paper's Sec. 3 engine, with the improvement that a
*single* metadata pass yields both classic pruning (NO_MATCH -> drop) and
Sec. 4.2 fully-matching detection (FULL_MATCH), instead of the paper's
second pass with inverted predicates.  ``tests/test_prune_filter.py``
proves the lattice result equals the paper's two-pass formulation.

Semantics per partition p and predicate q:
  NO_MATCH       no row of p can satisfy q          (safe to prune)
  PARTIAL_MATCH  some row may satisfy q             (must scan)
  FULL_MATCH     every row of p satisfies q         (Sec. 4 fully-matching)

SQL NULL handling: a NULL never satisfies a comparison, so FULL_MATCH is
demoted to PARTIAL wherever an involved column has nulls in the partition;
NO_MATCH decisions are unaffected (null rows fail the predicate too).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import expr as E
from . import intervals as I
from .metadata import FULL_MATCH, NO_MATCH, PARTIAL_MATCH, ColumnMeta, PartitionStats
from .rewrite import Widened, rewrite_for_pruning

_SENTINEL_HI = "￿"


def _find_str_hint(node, stats: PartitionStats) -> Optional[ColumnMeta]:
    """Locate a string-typed column in an expression to give a dictionary
    context for encoding string literals."""
    for name in node.columns() if hasattr(node, "columns") else ():
        cm = stats.column(name)
        if cm.kind == "str":
            return cm
    return None


def encode_literal(value, hint: Optional[ColumnMeta]) -> float:
    """Encode a literal into the numeric metadata domain.

    Unseen string literals map to fractional positions between dictionary
    codes (order-preserving), so range comparisons against them stay exact.
    """
    if not isinstance(value, str):
        return float(value)
    if hint is None or hint.dictionary is None:
        raise TypeError(f"string literal {value!r} needs a str column context")
    d = hint.dictionary
    idx = int(np.searchsorted(d, value, side="left"))
    if idx < len(d) and d[idx] == value:
        return float(idx)
    return float(idx) - 0.5


def derive(expr, stats: PartitionStats, hint: Optional[ColumnMeta] = None) -> I.Interval:
    """Per-partition value interval of a scalar expression (Sec. 3.1)."""
    P = stats.num_partitions
    if isinstance(expr, E.Col):
        c = stats.col_id(expr.name)
        return I.Interval(stats.mins[:, c].copy(), stats.maxs[:, c].copy())
    if isinstance(expr, E.Lit):
        return I.Interval.point(encode_literal(expr.value, hint), P)
    if isinstance(expr, E.Arith):
        a = derive(expr.lhs, stats, hint)
        b = derive(expr.rhs, stats, hint)
        return {"+": I.add, "-": I.sub, "*": I.mul, "/": I.div}[expr.op](a, b)
    if isinstance(expr, E.If):
        tv = eval_tv(expr.cond, stats, _rewrite=False)
        then = derive(expr.then, stats, hint)
        other = derive(expr.other, stats, hint)
        return I.select(tv == FULL_MATCH, tv == NO_MATCH, then, other)
    raise TypeError(f"cannot derive interval for {expr!r}")


def _nullable_mask(node, stats: PartitionStats) -> np.ndarray:
    """True where any column involved in ``node`` has nulls in the partition."""
    m = np.zeros(stats.num_partitions, dtype=bool)
    for name in node.columns():
        m |= stats.col_has_nulls(name)
    return m


def _demote_full(tv: np.ndarray, nullable: np.ndarray) -> np.ndarray:
    return np.where(nullable & (tv == FULL_MATCH), PARTIAL_MATCH, tv).astype(np.int8)


def _cmp_tv(op: str, a: I.Interval, b: I.Interval) -> np.ndarray:
    """Three-valued comparison of two interval batches."""
    P = a.lo.shape[0]
    no = np.zeros(P, dtype=bool)
    full = np.zeros(P, dtype=bool)
    if op == ">":
        full = a.lo > b.hi
        no = a.hi <= b.lo
    elif op == ">=":
        full = a.lo >= b.hi
        no = a.hi < b.lo
    elif op == "<":
        full = a.hi < b.lo
        no = a.lo >= b.hi
    elif op == "<=":
        full = a.hi <= b.lo
        no = a.lo > b.hi
    elif op == "==":
        no = (a.hi < b.lo) | (a.lo > b.hi)
        full = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
    elif op == "!=":
        full = (a.hi < b.lo) | (a.lo > b.hi)
        no = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
    else:
        raise ValueError(f"unknown comparison {op!r}")
    # Empty interval (all-null column in partition): nothing matches.
    empty = a.empty | b.empty
    tv = np.where(full, FULL_MATCH, PARTIAL_MATCH).astype(np.int8)
    tv = np.where(no, NO_MATCH, tv).astype(np.int8)
    tv = np.where(empty, NO_MATCH, tv).astype(np.int8)
    return tv


def eval_tv(pred: E.Pred, stats: PartitionStats, _rewrite: bool = True) -> np.ndarray:
    """Evaluate predicate -> int8 ``[P]`` in {NO, PARTIAL, FULL}_MATCH."""
    if _rewrite:
        pred = rewrite_for_pruning(pred)
    P = stats.num_partitions

    if isinstance(pred, E.TruePred):
        return np.full(P, FULL_MATCH, dtype=np.int8)

    if isinstance(pred, Widened):
        tv = eval_tv(pred.child, stats, _rewrite=False)
        return np.minimum(tv, PARTIAL_MATCH).astype(np.int8)  # never FULL

    if isinstance(pred, E.Cmp):
        hint = _find_str_hint(pred, stats)
        a = derive(pred.lhs, stats, hint)
        b = derive(pred.rhs, stats, hint)
        return _demote_full(_cmp_tv(pred.op, a, b), _nullable_mask(pred, stats))

    if isinstance(pred, E.And):
        tv = np.full(P, FULL_MATCH, dtype=np.int8)
        for c in pred.children:
            tv = np.minimum(tv, eval_tv(c, stats, _rewrite=False))
        return tv

    if isinstance(pred, E.Or):
        tv = np.full(P, NO_MATCH, dtype=np.int8)
        for c in pred.children:
            tv = np.maximum(tv, eval_tv(c, stats, _rewrite=False))
        return tv

    if isinstance(pred, E.Not):
        tv = (FULL_MATCH - eval_tv(pred.child, stats, _rewrite=False)).astype(np.int8)
        return _demote_full(tv, _nullable_mask(pred, stats))

    if isinstance(pred, E.StartsWith):
        cm = stats.column(pred.col.name)
        rng = cm.prefix_code_range(pred.prefix)
        pmin, pmax = stats.col_min(pred.col.name), stats.col_max(pred.col.name)
        if rng is None:  # no dictionary value has this prefix
            return np.full(P, NO_MATCH, dtype=np.int8)
        lo, hi = rng
        no = (pmax < lo) | (pmin > hi)
        full = (pmin >= lo) & (pmax <= hi)
        tv = np.where(full, FULL_MATCH, PARTIAL_MATCH).astype(np.int8)
        tv = np.where(no | (pmin > pmax), NO_MATCH, tv).astype(np.int8)
        return _demote_full(tv, _nullable_mask(pred, stats))

    if isinstance(pred, E.InSet):
        cm = stats.column(pred.col.name)
        hint = cm if cm.kind == "str" else None
        vals = np.array(sorted(encode_literal(v, hint) for v in pred.values))
        pmin, pmax = stats.col_min(pred.col.name), stats.col_max(pred.col.name)
        # any set value inside [pmin, pmax]?
        pos_lo = np.searchsorted(vals, pmin, side="left")
        pos_hi = np.searchsorted(vals, pmax, side="right")
        any_in = pos_hi > pos_lo
        full = (pmin == pmax) & any_in
        tv = np.where(full, FULL_MATCH, PARTIAL_MATCH).astype(np.int8)
        tv = np.where(~any_in | (pmin > pmax), NO_MATCH, tv).astype(np.int8)
        return _demote_full(tv, _nullable_mask(pred, stats))

    if isinstance(pred, E.IsNull):
        nc = stats.null_counts[:, stats.col_id(pred.col.name)]
        rc = stats.row_counts
        all_null, none_null = nc == rc, nc == 0
        if pred.negated:
            all_null, none_null = none_null, all_null
        tv = np.full(P, PARTIAL_MATCH, dtype=np.int8)
        tv = np.where(all_null, FULL_MATCH, tv).astype(np.int8)
        tv = np.where(none_null, NO_MATCH, tv).astype(np.int8)
        return tv

    if isinstance(pred, E.Like):  # only reachable with _rewrite=False
        return eval_tv(rewrite_for_pruning(pred), stats, _rewrite=False)

    raise TypeError(f"cannot evaluate predicate {pred!r}")


# ---------------------------------------------------------------------------
# Conjunctive-range fast path (feeds the batched minmax_prune kernel)
# ---------------------------------------------------------------------------

def extract_ranges(
    pred: E.Pred, stats: PartitionStats
) -> Optional[List[Tuple[int, float, float]]]:
    """Try to lower a predicate to a conjunction of closed column ranges
    ``[(col_id, lo, hi), ...]`` — the hot path in production pruning, which
    the GPU kernel evaluates branch-free.  Returns None when the predicate
    does not have that shape (the general evaluator handles it instead).
    """
    pred = rewrite_for_pruning(pred)
    out: List[Tuple[int, float, float]] = []
    if not _extract(pred, stats, out):
        return None
    return out


def _extract(pred, stats: PartitionStats, out: list) -> bool:
    if isinstance(pred, E.TruePred):
        return True
    if isinstance(pred, E.And):
        return all(_extract(c, stats, out) for c in pred.children)
    if isinstance(pred, E.StartsWith):
        cm = stats.column(pred.col.name)
        rng = cm.prefix_code_range(pred.prefix)
        if rng is None:
            out.append((stats.col_id(pred.col.name), np.inf, -np.inf))
        else:
            out.append((stats.col_id(pred.col.name), rng[0], rng[1]))
        return True
    if isinstance(pred, E.Cmp):
        # col <op> literal  or  literal <op> col
        lhs, rhs, op = pred.lhs, pred.rhs, pred.op
        if isinstance(rhs, E.Col) and isinstance(lhs, E.Lit):
            lhs, rhs = rhs, lhs
            op = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "==": "==", "!=": "!="}[op]
        if not (isinstance(lhs, E.Col) and isinstance(rhs, E.Lit)):
            return False
        cm = stats.column(lhs.name)
        hint = cm if cm.kind == "str" else None
        try:
            v = encode_literal(rhs.value, hint)
        except TypeError:
            return False
        cid = stats.col_id(lhs.name)
        if op == ">":
            out.append((cid, np.nextafter(v, np.inf), np.inf))
        elif op == ">=":
            out.append((cid, v, np.inf))
        elif op == "<":
            out.append((cid, -np.inf, np.nextafter(v, -np.inf)))
        elif op == "<=":
            out.append((cid, -np.inf, v))
        elif op == "==":
            out.append((cid, v, v))
        else:  # '!=' is not a single range
            return False
        return True
    return False


def eval_ranges_tv(
    ranges: List[Tuple[int, float, float]], stats: PartitionStats
) -> np.ndarray:
    """NumPy oracle for the conjunctive-range fast path (kernel ref)."""
    P = stats.num_partitions
    tv = np.full(P, FULL_MATCH, dtype=np.int8)
    for cid, lo, hi in ranges:
        pmin, pmax = stats.mins[:, cid], stats.maxs[:, cid]
        nullable = stats.null_counts[:, cid] > 0
        no = (pmax < lo) | (pmin > hi) | (pmin > pmax)
        full = (pmin >= lo) & (pmax <= hi) & ~nullable & ~(pmin > pmax)
        k = np.where(full, FULL_MATCH, PARTIAL_MATCH).astype(np.int8)
        k = np.where(no, NO_MATCH, k).astype(np.int8)
        tv = np.minimum(tv, k)
    return tv


def fully_matching_two_pass(pred: E.Pred, stats: PartitionStats) -> np.ndarray:
    """The paper's Sec. 4.2 formulation: a second pruning pass with the
    *inverted* predicate; partitions pruned by it are fully matching.
    Kept as the reference/oracle for the one-pass lattice.

    NULL guard: logically inverting a predicate only complements it over
    non-null rows (a NULL satisfies neither ``p`` nor ``NOT p``), so a
    partition with nulls in an involved column can never be declared fully
    matching.  The paper does not spell this out; the one-pass lattice
    handles it via FULL-demotion at comparison nodes.
    """
    rewritten = rewrite_for_pruning(pred)
    inv = E.invert(rewritten)
    tv_inv = eval_tv(inv, stats, _rewrite=False)
    return (tv_inv == NO_MATCH) & ~_nullable_mask(rewritten, stats)
