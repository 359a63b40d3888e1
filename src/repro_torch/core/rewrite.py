"""Imprecise filter rewrites (paper Sec. 3.1).

Predicates that cannot be evaluated against min/max metadata directly are
*widened* into prunable forms.  Widening is only superset-preserving, so a
widened node may never report FULL_MATCH (that would poison the Sec. 4.2
fully-matching detection); ``Widened`` marks this and the evaluator clamps
FULL -> PARTIAL underneath it.

``LIKE 'Alpine%'`` (single trailing ``%``) is *exactly* a prefix test, so it
rewrites to a non-widened ``StartsWith`` — this is what lets Figure 5's
partition 3 be identified as fully matching.
"""

from __future__ import annotations

import dataclasses

from . import expr as E


@dataclasses.dataclass(frozen=True, eq=False)
class Widened(E.Pred):
    """Marks a pruning predicate that over-approximates the original."""

    child: E.Pred

    def columns(self):
        return self.child.columns()

    def __repr__(self):
        return f"widened({self.child!r})"


def rewrite_like(node: E.Like) -> E.Pred:
    """Rewrite LIKE into a prunable (possibly widened) predicate."""
    pattern = node.pattern
    if "%" not in pattern:
        return E.Cmp("==", node.col, E.Lit(pattern))
    first = pattern.index("%")
    prefix = pattern[:first]
    exact = pattern.endswith("%") and "%" not in pattern[:-1]
    if exact:
        # 'abc%'  <=>  STARTSWITH('abc') — equivalence-preserving.
        return E.StartsWith(node.col, prefix)
    if prefix:
        # 'abc%def' -> widen to STARTSWITH('abc'): drops the suffix
        # constraint, exactly the paper's 'Marked-%-Ridge' example.
        return Widened(E.StartsWith(node.col, prefix))
    # '%abc' — no usable prefix; unprunable.
    return Widened(E.TruePred())


def rewrite_for_pruning(pred: E.Pred) -> E.Pred:
    """Recursively rewrite a predicate tree into its pruning form."""
    if isinstance(pred, E.Like):
        return rewrite_like(pred)
    if isinstance(pred, E.And):
        return E.And(tuple(rewrite_for_pruning(c) for c in pred.children))
    if isinstance(pred, E.Or):
        return E.Or(tuple(rewrite_for_pruning(c) for c in pred.children))
    if isinstance(pred, E.Not):
        return E.Not(rewrite_for_pruning(pred.child))
    if isinstance(pred, Widened):
        return Widened(rewrite_for_pruning(pred.child))
    return pred
