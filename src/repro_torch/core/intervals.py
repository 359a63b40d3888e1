"""Vectorized interval arithmetic over per-partition metadata.

Implements the paper's Sec. 3.1 "Deriving Min/Max Ranges": every scalar
expression is mapped to a per-partition value interval ``[lo, hi]`` derived
from the partition's column min/max stats.  All operations are conservative
(the derived interval always contains every value the expression can take
on rows of that partition) — the property the no-false-negative guarantee
rests on, and the one our hypothesis tests check.

Intervals are *empty* (lo > hi, encoded +inf/-inf) when the partition has
no non-null value for an involved column; comparisons on empty intervals
evaluate to NO_MATCH (a NULL never satisfies a comparison).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Interval:
    """A batch of per-partition intervals: lo/hi are ``[P]`` float64."""

    lo: np.ndarray
    hi: np.ndarray

    @property
    def empty(self) -> np.ndarray:
        return self.lo > self.hi

    @staticmethod
    def point(value: float, P: int) -> "Interval":
        v = np.full(P, float(value))
        return Interval(v.copy(), v.copy())

    @staticmethod
    def empty_like(P: int) -> "Interval":
        return Interval(np.full(P, np.inf), np.full(P, -np.inf))


def _mask_empty(result: Interval, *inputs: Interval) -> Interval:
    """Any arithmetic involving an empty interval is empty."""
    empty = np.zeros_like(result.lo, dtype=bool)
    for i in inputs:
        empty |= i.empty
    result.lo = np.where(empty, np.inf, result.lo)
    result.hi = np.where(empty, -np.inf, result.hi)
    return result


def add(a: Interval, b: Interval) -> Interval:
    return _mask_empty(Interval(a.lo + b.lo, a.hi + b.hi), a, b)


def sub(a: Interval, b: Interval) -> Interval:
    return _mask_empty(Interval(a.lo - b.hi, a.hi - b.lo), a, b)


def mul(a: Interval, b: Interval) -> Interval:
    # Evaluate the four corner products; NaNs (inf * 0 from empty inputs)
    # are masked out afterwards by _mask_empty.
    with np.errstate(invalid="ignore"):
        p1, p2 = a.lo * b.lo, a.lo * b.hi
        p3, p4 = a.hi * b.lo, a.hi * b.hi
        stack = np.stack([p1, p2, p3, p4])
        stack = np.nan_to_num(stack, nan=0.0)
        return _mask_empty(Interval(stack.min(axis=0), stack.max(axis=0)), a, b)


def div(a: Interval, b: Interval) -> Interval:
    """Conservative division: any divisor interval containing 0 widens the
    result to (-inf, +inf) — cannot prune, never incorrect."""
    contains_zero = (b.lo <= 0.0) & (b.hi >= 0.0)
    safe_b = Interval(
        np.where(contains_zero, 1.0, b.lo), np.where(contains_zero, 1.0, b.hi)
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        q = np.stack(
            [a.lo / safe_b.lo, a.lo / safe_b.hi, a.hi / safe_b.lo, a.hi / safe_b.hi]
        )
        q = np.nan_to_num(q, nan=0.0)
    lo, hi = q.min(axis=0), q.max(axis=0)
    lo = np.where(contains_zero, -np.inf, lo)
    hi = np.where(contains_zero, np.inf, hi)
    return _mask_empty(Interval(lo, hi), a, b)


def hull(a: Interval, b: Interval) -> Interval:
    """Union hull — the paper's conservative IF(...) treatment.  An empty
    branch contributes nothing (min/max against +inf/-inf is identity)."""
    return Interval(np.minimum(a.lo, b.lo), np.maximum(a.hi, b.hi))


def select(cond_full: np.ndarray, cond_no: np.ndarray,
           then: Interval, other: Interval) -> Interval:
    """Interval of IF(c, then, other) given three-valued condition masks.

    Where the condition is conclusively FULL/NO the respective branch's
    interval is used exactly (the paper's "ranges can be adjusted
    accordingly"); elsewhere the hull.
    """
    h = hull(then, other)
    lo = np.where(cond_full, then.lo, np.where(cond_no, other.lo, h.lo))
    hi = np.where(cond_full, then.hi, np.where(cond_no, other.hi, h.hi))
    return Interval(lo, hi)
