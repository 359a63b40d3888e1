"""Row-level predicate evaluation (the ground-truth oracle).

Used by the scan executor (after pruning, surviving partitions are filtered
row-wise) and by the tests that prove the no-false-negative invariant:
``eval_tv == NO_MATCH`` must imply "no row matches", and ``FULL_MATCH``
must imply "every row matches".

SQL three-valued (Kleene) row semantics: comparisons with NULL are
UNKNOWN; WHERE keeps rows whose predicate is exactly TRUE.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from . import expr as E
from .metadata import ColumnMeta
from .rewrite import Widened

K_FALSE, K_UNKNOWN, K_TRUE = 0, 1, 2


def _like_regex(pattern: str) -> "re.Pattern":
    return re.compile("^" + ".*".join(re.escape(p) for p in pattern.split("%")) + "$")


class RowContext:
    """Column data for one partition (or a whole table) in encoded form."""

    def __init__(
        self,
        columns: Dict[str, ColumnMeta],
        data: Dict[str, np.ndarray],
        nulls: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.columns = columns
        self.data = data
        self.nulls = nulls or {}
        self.n = len(next(iter(data.values()))) if data else 0

    def col(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        v = self.data[name]
        nm = self.nulls.get(name)
        if nm is None:
            nm = np.zeros(self.n, dtype=bool)
        return v, nm

    def _hint_for(self, node) -> Optional[ColumnMeta]:
        for name in node.columns():
            cm = self.columns.get(name)
            if cm is not None and cm.kind == "str":
                return cm
        return None


def eval_expr(node, ctx: RowContext, hint=None) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar expression -> (values, null_mask), both ``[n]``."""
    from .prune_filter import encode_literal

    if isinstance(node, E.Col):
        return ctx.col(node.name)
    if isinstance(node, E.Lit):
        v = encode_literal(node.value, hint)
        return np.full(ctx.n, v), np.zeros(ctx.n, dtype=bool)
    if isinstance(node, E.Arith):
        a, an = eval_expr(node.lhs, ctx, hint)
        b, bn = eval_expr(node.rhs, ctx, hint)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = {"+": np.add, "-": np.subtract, "*": np.multiply,
                 "/": np.divide}[node.op](a, b)
        return v, an | bn
    if isinstance(node, E.If):
        k = eval_pred(node.cond, ctx)
        a, an = eval_expr(node.then, ctx, hint)
        b, bn = eval_expr(node.other, ctx, hint)
        take_then = k == K_TRUE  # UNKNOWN falls through to ELSE (SQL CASE)
        return np.where(take_then, a, b), np.where(take_then, an, bn)
    raise TypeError(f"cannot row-evaluate {node!r}")


def eval_pred(pred, ctx: RowContext) -> np.ndarray:
    """Predicate -> Kleene ``[n]`` in {K_FALSE, K_UNKNOWN, K_TRUE}."""
    from .prune_filter import encode_literal

    if isinstance(pred, E.TruePred):
        return np.full(ctx.n, K_TRUE, dtype=np.int8)
    if isinstance(pred, Widened):
        # Row-level evaluation must use the ORIGINAL semantics; a widened
        # node only exists in pruning trees.  Evaluate the widened child —
        # callers comparing against pruning decisions want the superset.
        return eval_pred(pred.child, ctx)
    if isinstance(pred, E.Cmp):
        hint = ctx._hint_for(pred)
        a, an = eval_expr(pred.lhs, ctx, hint)
        b, bn = eval_expr(pred.rhs, ctx, hint)
        op = {
            ">": np.greater, ">=": np.greater_equal,
            "<": np.less, "<=": np.less_equal,
            "==": np.equal, "!=": np.not_equal,
        }[pred.op]
        k = np.where(op(a, b), K_TRUE, K_FALSE).astype(np.int8)
        return np.where(an | bn, K_UNKNOWN, k).astype(np.int8)
    if isinstance(pred, E.And):
        k = np.full(ctx.n, K_TRUE, dtype=np.int8)
        for c in pred.children:
            k = np.minimum(k, eval_pred(c, ctx))
        return k
    if isinstance(pred, E.Or):
        k = np.full(ctx.n, K_FALSE, dtype=np.int8)
        for c in pred.children:
            k = np.maximum(k, eval_pred(c, ctx))
        return k
    if isinstance(pred, E.Not):
        return (K_TRUE - eval_pred(pred.child, ctx)).astype(np.int8)
    if isinstance(pred, E.StartsWith):
        cm = ctx.columns[pred.col.name]
        v, nm = ctx.col(pred.col.name)
        rng = cm.prefix_code_range(pred.prefix)
        if rng is None:
            k = np.full(ctx.n, K_FALSE, dtype=np.int8)
        else:
            k = np.where((v >= rng[0]) & (v <= rng[1]), K_TRUE, K_FALSE).astype(np.int8)
        return np.where(nm, K_UNKNOWN, k).astype(np.int8)
    if isinstance(pred, E.Like):
        cm = ctx.columns[pred.col.name]
        v, nm = ctx.col(pred.col.name)
        rx = _like_regex(pred.pattern)
        strings = cm.dictionary[v.astype(np.int64)]
        hit = np.fromiter((bool(rx.match(s)) for s in strings), dtype=bool, count=ctx.n)
        k = np.where(hit, K_TRUE, K_FALSE).astype(np.int8)
        return np.where(nm, K_UNKNOWN, k).astype(np.int8)
    if isinstance(pred, E.InSet):
        cm = ctx.columns[pred.col.name]
        hint = cm if cm.kind == "str" else None
        vals = np.array(sorted(encode_literal(x, hint) for x in pred.values))
        v, nm = ctx.col(pred.col.name)
        hit = np.isin(v, vals)
        k = np.where(hit, K_TRUE, K_FALSE).astype(np.int8)
        return np.where(nm, K_UNKNOWN, k).astype(np.int8)
    if isinstance(pred, E.IsNull):
        _, nm = ctx.col(pred.col.name)
        hit = ~nm if pred.negated else nm
        return np.where(hit, K_TRUE, K_FALSE).astype(np.int8)
    raise TypeError(f"cannot row-evaluate predicate {pred!r}")


def matches(pred, ctx: RowContext) -> np.ndarray:
    """Boolean row mask: rows the query's WHERE clause keeps."""
    return eval_pred(pred, ctx) == K_TRUE
