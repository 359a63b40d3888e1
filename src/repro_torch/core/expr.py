"""Typed expression trees for predicates and scalar expressions.

The pruning engine never sees SQL text; queries are built from these nodes
(the paper's guiding example becomes
``(col('altit') * 0.3048).if_(col('unit') == 'feet', col('altit')) > 1500``
— see ``If`` below — combined with ``like(col('name'), 'Marked-%-Ridge')``).

Scalar nodes produce value intervals (intervals.py); predicate nodes
produce three-valued match results (prune_filter.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple, Union


class Expr:
    """Base class for scalar-valued expressions."""

    def _wrap(self, other) -> "Expr":
        return other if isinstance(other, Expr) else Lit(other)

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o): return Arith("+", self, self._wrap(o))
    def __radd__(self, o): return Arith("+", self._wrap(o), self)
    def __sub__(self, o): return Arith("-", self, self._wrap(o))
    def __rsub__(self, o): return Arith("-", self._wrap(o), self)
    def __mul__(self, o): return Arith("*", self, self._wrap(o))
    def __rmul__(self, o): return Arith("*", self._wrap(o), self)
    def __truediv__(self, o): return Arith("/", self, self._wrap(o))
    def __neg__(self): return Arith("-", Lit(0.0), self)

    # -- comparisons ------------------------------------------------------
    def __gt__(self, o): return Cmp(">", self, self._wrap(o))
    def __ge__(self, o): return Cmp(">=", self, self._wrap(o))
    def __lt__(self, o): return Cmp("<", self, self._wrap(o))
    def __le__(self, o): return Cmp("<=", self, self._wrap(o))
    def __eq__(self, o): return Cmp("==", self, self._wrap(o))  # type: ignore[override]
    def __ne__(self, o): return Cmp("!=", self, self._wrap(o))  # type: ignore[override]

    __hash__ = object.__hash__

    def columns(self) -> Tuple[str, ...]:
        """All column names referenced by this (sub)expression."""
        out: list = []
        _collect_columns(self, out)
        return tuple(dict.fromkeys(out))


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def __repr__(self):
        return f"col({self.name!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any  # float/int or str (encoded lazily against the dictionary)

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Arith(Expr):
    op: str  # '+', '-', '*', '/'
    lhs: Expr
    rhs: Expr

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class If(Expr):
    """IF(cond, then, else) — the paper's Sec. 3.1 derived-range example."""

    cond: "Pred"
    then: Expr
    other: Expr

    def __repr__(self):
        return f"if_({self.cond!r}, {self.then!r}, {self.other!r})"


class Pred:
    """Base class for boolean-valued predicate nodes."""

    def __and__(self, o): return And((self, o))
    def __or__(self, o): return Or((self, o))
    def __invert__(self): return Not(self)

    __hash__ = object.__hash__

    def columns(self) -> Tuple[str, ...]:
        out: list = []
        _collect_columns(self, out)
        return tuple(dict.fromkeys(out))


@dataclasses.dataclass(frozen=True, eq=False)
class Cmp(Pred):
    op: str  # '>', '>=', '<', '<=', '==', '!='
    lhs: Expr
    rhs: Expr

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class And(Pred):
    children: Tuple[Pred, ...]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))

    def __repr__(self):
        return "(" + " & ".join(map(repr, self.children)) + ")"


@dataclasses.dataclass(frozen=True, eq=False)
class Or(Pred):
    children: Tuple[Pred, ...]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))

    def __repr__(self):
        return "(" + " | ".join(map(repr, self.children)) + ")"


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Pred):
    child: Pred

    def __repr__(self):
        return f"~{self.child!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class Like(Pred):
    """SQL LIKE with '%' wildcards (no '_' support needed for the paper)."""

    col: Col
    pattern: str

    def __repr__(self):
        return f"like({self.col!r}, {self.pattern!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class StartsWith(Pred):
    col: Col
    prefix: str

    def __repr__(self):
        return f"startswith({self.col!r}, {self.prefix!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class InSet(Pred):
    col: Col
    values: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))

    def __repr__(self):
        return f"in_({self.col!r}, {self.values!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class IsNull(Pred):
    col: Col
    negated: bool = False

    def __repr__(self):
        return f"is_{'not_' if self.negated else ''}null({self.col!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class TruePred(Pred):
    """WHERE true — matches everything (paper's Sec. 6 example query)."""

    def __repr__(self):
        return "true"


def _collect_columns(node, out: list) -> None:
    if isinstance(node, Col):
        out.append(node.name)
    elif isinstance(node, (Like, StartsWith, InSet, IsNull)):
        out.append(node.col.name)
    elif isinstance(node, Arith):
        _collect_columns(node.lhs, out)
        _collect_columns(node.rhs, out)
    elif isinstance(node, Cmp):
        _collect_columns(node.lhs, out)
        _collect_columns(node.rhs, out)
    elif isinstance(node, If):
        _collect_columns(node.cond, out)
        _collect_columns(node.then, out)
        _collect_columns(node.other, out)
    elif isinstance(node, (And, Or)):
        for c in node.children:
            _collect_columns(c, out)
    elif isinstance(node, Not):
        _collect_columns(node.child, out)


# ---------------------------------------------------------------------------
# Builder API
# ---------------------------------------------------------------------------

def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def if_(cond: Pred, then: Union[Expr, float], other: Union[Expr, float]) -> If:
    w = lambda e: e if isinstance(e, Expr) else Lit(e)
    return If(cond, w(then), w(other))


def like(c: Col, pattern: str) -> Like:
    return Like(c, pattern)


def startswith(c: Col, prefix: str) -> StartsWith:
    return StartsWith(c, prefix)


def in_(c: Col, values: Sequence) -> InSet:
    return InSet(c, tuple(values))


def is_null(c: Col) -> IsNull:
    return IsNull(c)


def is_not_null(c: Col) -> IsNull:
    return IsNull(c, negated=True)


def true() -> TruePred:
    return TruePred()


def and_(*preds: Pred) -> Pred:
    preds = tuple(p for p in preds if not isinstance(p, TruePred))
    if not preds:
        return TruePred()
    return preds[0] if len(preds) == 1 else And(preds)


def or_(*preds: Pred) -> Pred:
    return preds[0] if len(preds) == 1 else Or(tuple(preds))


# ---------------------------------------------------------------------------
# Canonical predicate keys (predicate cache + batch dedupe)
# ---------------------------------------------------------------------------

# Comparison orientation flips for lit-on-left normalization.
_CMP_FLIP = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "==": "==",
             "!=": "!="}


def _canon_value(v) -> str:
    """Normalize a literal so numerically equal constants collide.

    ``1`` and ``1.0`` canonicalize identically; an int too wide for an
    exact f64 keeps its integer spelling (folding it into a float would
    merge *distinct* predicates, which is unsound for a cache key).
    """
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return repr(v)
    f = float(v)
    return repr(f) if f == v else repr(v)


def _canon(node) -> str:
    if isinstance(node, Lit):
        return f"lit({_canon_value(node.value)})"
    if isinstance(node, Col):
        return repr(node)
    if isinstance(node, Arith):
        return f"({_canon(node.lhs)} {node.op} {_canon(node.rhs)})"
    if isinstance(node, If):
        return (f"if_({_canon(node.cond)}, {_canon(node.then)}, "
                f"{_canon(node.other)})")
    if isinstance(node, Cmp):
        lhs, rhs, op = node.lhs, node.rhs, node.op
        if isinstance(lhs, Lit) and not isinstance(rhs, Lit):
            lhs, rhs, op = rhs, lhs, _CMP_FLIP[op]
        return f"({_canon(lhs)} {op} {_canon(rhs)})"
    if isinstance(node, (And, Or)):
        # Commutative + associative + idempotent: flatten same-kind
        # nesting, canonicalize children, then sort and dedupe.
        kind = type(node)
        parts: list = []
        for c in node.children:
            if isinstance(c, kind):
                parts.extend(c.children)
            else:
                parts.append(c)
        keys = sorted(dict.fromkeys(_canon(c) for c in parts))
        if len(keys) == 1:
            return keys[0]
        sep = " & " if kind is And else " | "
        return "(" + sep.join(keys) + ")"
    if isinstance(node, Not):
        return f"~{_canon(node.child)}"
    if isinstance(node, InSet):
        vals = sorted(dict.fromkeys(_canon_value(v) for v in node.values))
        return f"in_({_canon(node.col)}, ({', '.join(vals)}))"
    if isinstance(node, (Like, StartsWith, IsNull, TruePred)):
        return repr(node)
    return repr(node)


def canonical_key(pred) -> str:
    """Canonical string key for a predicate: equal keys imply equivalent
    predicates, and the common syntactic variants of one predicate —
    commutative ``AND``/``OR`` orderings, ``1`` vs ``1.0`` literals,
    lit-on-left comparisons, duplicate conjuncts — collide.

    This is both the ``plan_key`` cache key (Sec. 8.2) and the
    within-batch dedupe key for the device-resident verdict plane.
    Non-predicate inputs (None, prebuilt repr strings from benchmarks)
    fall back to ``repr``.
    """
    if not isinstance(pred, (Pred, Expr)):
        return repr(pred)
    return _canon(pred)


def invert(pred: Pred) -> Pred:
    """Logical negation used for the Sec. 4.2 inverted-predicate pass."""
    if isinstance(pred, Not):
        return pred.child
    if isinstance(pred, And):
        return Or(tuple(invert(c) for c in pred.children))
    if isinstance(pred, Or):
        return And(tuple(invert(c) for c in pred.children))
    if isinstance(pred, Cmp):
        flip = {">": "<=", ">=": "<", "<": ">=", "<=": ">", "==": "!=", "!=": "=="}
        return Cmp(flip[pred.op], pred.lhs, pred.rhs)
    if isinstance(pred, IsNull):
        return IsNull(pred.col, negated=not pred.negated)
    return Not(pred)
