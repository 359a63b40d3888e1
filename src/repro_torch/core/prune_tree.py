"""Adaptive pruning-tree execution: filter reordering + cutoff (Sec. 3.2).

Compile-time pruning is modeled as an incremental, batched process over the
partition population (Snowflake refines pruning "as new filters are
identified"; here batches of partitions stand in for that incremental
refinement).  Per pruning-tree node we track
  - examined: partitions this node was evaluated on,
  - pruned:   partitions this node newly decided NO_MATCH,
  - cost:     simulated evaluation cost units (deterministic — operation
              counts, not wall clock, so tests are reproducible).

After every batch the tree is *locally* re-optimized:
  - AND children reordered by descending pruned/cost (fast, selective
    filters first); OR children by descending full/cost (fast,
    low-selectivity filters first — they saturate the OR early).
  - Cutoff: a child of an AND whose projected benefit (partitions it would
    prune on the remaining population x per-partition scan cost) is below
    its projected evaluation cost is disabled; a disabled node contributes
    PARTIAL_MATCH (conservative: "assume every partition passes").  Per the
    paper, children of an OR are never cut off — removing one poisons the
    whole OR branch.

Invariant (tested): the adaptive result never prunes a partition that exact
evaluation would keep, and with cutoff disabled it is bit-identical to
``prune_filter.eval_tv``.

Host NumPy f64, as in the JAX package: the pipeline's ``adaptive=True`` is
a host pipeline by the caller's choice, and launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import expr as E
from .metadata import FULL_MATCH, NO_MATCH, PARTIAL_MATCH, PartitionStats
from .prune_filter import eval_tv
from .rewrite import Widened, rewrite_for_pruning


def _expr_cost(node) -> float:
    """Deterministic per-partition evaluation cost: expression node count."""
    if isinstance(node, (E.Col, E.Lit, E.TruePred)):
        return 1.0
    if isinstance(node, E.Arith):
        return 1.0 + _expr_cost(node.lhs) + _expr_cost(node.rhs)
    if isinstance(node, E.Cmp):
        return 1.0 + _expr_cost(node.lhs) + _expr_cost(node.rhs)
    if isinstance(node, E.If):
        return 1.0 + _expr_cost(node.cond) + _expr_cost(node.then) + _expr_cost(node.other)
    if isinstance(node, (E.And, E.Or)):
        return 1.0 + sum(_expr_cost(c) for c in node.children)
    if isinstance(node, E.Not):
        return 1.0 + _expr_cost(node.child)
    if isinstance(node, Widened):
        return 1.0 + _expr_cost(node.child)
    if isinstance(node, (E.Like, E.StartsWith, E.InSet, E.IsNull)):
        return 2.0
    return 2.0


@dataclasses.dataclass
class NodeStats:
    examined: int = 0
    pruned: int = 0
    full: int = 0
    cost_units: float = 0.0
    disabled: bool = False

    @property
    def prune_ratio(self) -> float:
        return self.pruned / self.examined if self.examined else 0.0

    @property
    def full_ratio(self) -> float:
        return self.full / self.examined if self.examined else 0.0


class _Node:
    def __init__(self):
        self.stats = NodeStats()


class _Leaf(_Node):
    def __init__(self, pred: E.Pred):
        super().__init__()
        self.pred = pred
        self.cost = _expr_cost(pred)

    def describe(self) -> str:
        return repr(self.pred)


class _Bool(_Node):
    def __init__(self, op: str, children: List[_Node]):
        super().__init__()
        self.op = op  # 'and' | 'or'
        self.children = children
        self.cost = sum(c.cost for c in children)

    def describe(self) -> str:
        sep = " & " if self.op == "and" else " | "
        return "(" + sep.join(c.describe() for c in self.children) + ")"


def _build(pred: E.Pred) -> _Node:
    if isinstance(pred, E.And):
        return _Bool("and", [_build(c) for c in pred.children])
    if isinstance(pred, E.Or):
        return _Bool("or", [_build(c) for c in pred.children])
    return _Leaf(pred)


@dataclasses.dataclass
class PruneRunResult:
    tv: np.ndarray                 # [P] three-valued result
    work_units: float              # total simulated evaluation cost
    leaf_report: List[dict]        # per-leaf stats snapshots


class AdaptivePruner:
    """Batched, self-reordering, self-cutting pruning-tree executor."""

    def __init__(
        self,
        pred: E.Pred,
        scan_cost: float = 1000.0,
        reorder: bool = True,
        cutoff: bool = True,
    ):
        self.pred = rewrite_for_pruning(pred)
        self.root = _build(self.pred)
        self.scan_cost = scan_cost
        self.reorder = reorder
        self.cutoff = cutoff
        self.work_units = 0.0

    # -- evaluation -------------------------------------------------------

    def _eval(self, node: _Node, stats: PartitionStats, active: np.ndarray) -> np.ndarray:
        P = stats.num_partitions
        if node.stats.disabled:
            return np.full(P, PARTIAL_MATCH, dtype=np.int8)
        if isinstance(node, _Leaf):
            n_active = int(active.sum())
            tv = eval_tv(node.pred, stats, _rewrite=False)
            node.stats.examined += n_active
            node.stats.pruned += int(((tv == NO_MATCH) & active).sum())
            node.stats.full += int(((tv == FULL_MATCH) & active).sum())
            cost = n_active * node.cost
            node.stats.cost_units += cost
            self.work_units += cost
            return tv
        assert isinstance(node, _Bool)
        if node.op == "and":
            tv = np.full(P, FULL_MATCH, dtype=np.int8)
            for child in node.children:
                # short-circuit: partitions already NO skip further children
                ctv = self._eval(child, stats, active & (tv > NO_MATCH))
                tv = np.minimum(tv, ctv)
        else:
            tv = np.full(P, NO_MATCH, dtype=np.int8)
            for child in node.children:
                # saturation: partitions already FULL skip further children
                ctv = self._eval(child, stats, active & (tv < FULL_MATCH))
                tv = np.maximum(tv, ctv)
        return tv

    # -- adaptation -------------------------------------------------------

    def _reorder(self, node: _Node) -> None:
        if not isinstance(node, _Bool):
            return
        for c in node.children:
            self._reorder(c)
        if not self.reorder:
            return
        if node.op == "and":
            key = lambda c: -(c.stats.prune_ratio / max(c.cost, 1e-9))
        else:
            key = lambda c: -(c.stats.full_ratio / max(c.cost, 1e-9))
        node.children.sort(key=key)

    def _apply_cutoff(self, node: _Node, remaining: int) -> None:
        """Disable AND children whose projected cost exceeds their benefit.

        Benefit of keeping child c: remaining * prune_ratio * scan_cost
        (partitions it would remove never get scanned).  Cost of keeping:
        remaining * c.cost.  This is the paper's "two scenarios" model.
        """
        if not isinstance(node, _Bool):
            return
        if node.op == "and" and self.cutoff:
            for c in node.children:
                if c.stats.disabled or c.stats.examined == 0:
                    continue
                benefit = remaining * c.stats.prune_ratio * self.scan_cost
                cost = remaining * c.cost
                if cost > benefit:
                    c.stats.disabled = True
        # Never cut off below an OR (paper Sec. 3.2).  Recurse either way:
        # an AND nested inside an OR may still cut its own children.
        for c in node.children:
            self._apply_cutoff(c, remaining)

    # -- driver -----------------------------------------------------------

    def run(self, stats: PartitionStats, batch_size: Optional[int] = None) -> PruneRunResult:
        P = stats.num_partitions
        if batch_size is None or batch_size >= P:
            tv = self._eval(self.root, stats, np.ones(P, dtype=bool))
            return PruneRunResult(tv, self.work_units, self.leaf_report())
        tvs = []
        done = 0
        while done < P:
            batch = stats.select(np.arange(done, min(done + batch_size, P)))
            tvs.append(self._eval(self.root, batch, np.ones(batch.num_partitions, dtype=bool)))
            done += batch.num_partitions
            self._reorder(self.root)
            self._apply_cutoff(self.root, remaining=P - done)
        return PruneRunResult(np.concatenate(tvs), self.work_units, self.leaf_report())

    def leaf_report(self) -> List[dict]:
        out: List[dict] = []

        def walk(node: _Node):
            if isinstance(node, _Leaf):
                out.append(
                    dict(
                        pred=node.describe(),
                        cost=node.cost,
                        examined=node.stats.examined,
                        pruned=node.stats.pruned,
                        full=node.stats.full,
                        cost_units=node.stats.cost_units,
                        disabled=node.stats.disabled,
                    )
                )
            else:
                for c in node.children:
                    walk(c)

        walk(self.root)
        return out
