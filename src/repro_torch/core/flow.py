"""The combined pruning flow (paper Sec. 7) as a technique-executor engine.

Techniques execute in Snowflake's order:
    filter pruning (compile time, Sec. 3)
      -> LIMIT pruning (compile time, extends filter pruning, Sec. 4)
      -> JOIN pruning  (runtime, Sec. 6)
      -> top-k pruning (runtime, Sec. 5)

This slice of the port carries the first two.  A query with a JOIN or an
ORDER BY raises ``NotImplementedError`` instead of running a shorter
sequence than the reference would.

Technique-executor contract
---------------------------
Each stage is a ``Technique``.  An executor reads the query's per-scan
``ScanSet``s out of a ``PruneState``, refines them, and records a
``TechniqueReport`` — per scan it is a ``(ScanSet, report) ->
(ScanSet, report)`` transformer, and the pipeline is the ordered
composition of the executors.

The same executors run in two regimes:

  * ``PruningPipeline.run`` drives the sequence for ONE query — each
    executor's ``run(pipeline, state)``;
  * ``serve.prune_service.PruningService.run_batch`` drives the sequence
    over a whole workload — each executor's ``run_batch(pipeline,
    states, service)``, where the filter stage groups its kernel work
    **per table** so launches are bounded by the number of distinct
    tables, not the number of queries.

Both regimes produce bit-identical ``PruningReport``s: the batched path
evaluates exactly the same per-query math, only packed into shared
launches against the resident metadata planes (core/device_stats.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import expr as E
from .metadata import (NO_MATCH, PARTIAL_MATCH, ScanSet, live_full_scan,
                       mask_dead_partitions)
from .prune_filter import eval_tv
from .prune_limit import limit_prune


@dataclasses.dataclass
class TableScanSpec:
    table: object                     # data.table.Table
    pred: E.Pred = dataclasses.field(default_factory=E.true)


@dataclasses.dataclass
class JoinSpec:
    build: str                        # scan name (small side, hashed)
    probe: str                        # scan name (large side, pruned)
    build_key: str
    probe_key: str
    kind: str = "inner"               # 'inner' | 'left_outer' (probe side preserved)


@dataclasses.dataclass
class Query:
    scans: Dict[str, TableScanSpec]
    join: Optional[JoinSpec] = None
    limit: Optional[int] = None
    offset: int = 0
    order_by: Optional[Tuple[str, str, bool]] = None  # (scan, column, desc)
    group_by: Tuple[str, ...] = ()
    order_by_is_aggregate: bool = False

    @property
    def effective_k(self) -> Optional[int]:
        # Fig. 6: OFFSET counts toward the rows that must be produced.
        return None if self.limit is None else self.limit + self.offset

    @property
    def is_plain_limit(self) -> bool:
        return self.limit is not None and self.order_by is None


def check_supported(q: Query) -> None:
    """Raise for the query shapes whose stages this slice lacks."""
    if q.join is not None:
        raise NotImplementedError(
            "JOIN pruning is not ported yet: queries with a join are refused")
    if q.order_by is not None:
        raise NotImplementedError(
            "top-k pruning is not ported yet: queries with ORDER BY are "
            "refused")


@dataclasses.dataclass
class TechniqueReport:
    before: int
    after: int
    applied: bool
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PruningReport:
    per_scan: Dict[str, Dict[str, TechniqueReport]]
    scan_sets: Dict[str, ScanSet]
    counters: Optional[dict] = None   # this batch's ServiceCounters delta
                                      # (attached by PruningService.run_batch)


@dataclasses.dataclass
class PruneState:
    """Mutable per-query state threaded through the technique sequence."""

    query: Query
    scan_sets: Dict[str, ScanSet] = dataclasses.field(default_factory=dict)
    per_scan: Dict[str, Dict[str, TechniqueReport]] = dataclasses.field(
        default_factory=dict)
    filter_sets: Optional[Dict[str, ScanSet]] = None  # injected filter results


class Technique:
    """One pruning stage.  ``run`` executes it for a single query;
    ``run_batch`` executes it across a workload, and device-eligible
    subclasses override it to batch kernel work per table group via the
    ``service`` (a ``serve.prune_service.PruningService``)."""

    name = "?"

    def run(self, pipe: "PruningPipeline", state: PruneState) -> None:
        raise NotImplementedError

    def run_batch(self, pipe: "PruningPipeline", states: List[PruneState],
                  service=None) -> None:
        for st in states:
            self.run(pipe, st)


class FilterTechnique(Technique):
    """Sec. 3 filter pruning (+ Sec. 4.2 fully-matching, one pass)."""

    name = "filter"

    def run(self, pipe, state):
        q = state.query
        for name, spec in q.scans.items():
            if state.filter_sets is not None and name in state.filter_sets:
                ss = state.filter_sets[name]
                P = spec.table.num_partitions
                rep = TechniqueReport(
                    P, len(ss),
                    applied=pipe.enable_filter
                    and not isinstance(spec.pred, E.TruePred))
            else:
                ss, rep = self._prune_scan(pipe, spec)
            state.scan_sets[name] = ss
            state.per_scan[name]["filter"] = rep

    def _prune_scan(self, pipe, spec: TableScanSpec
                    ) -> Tuple[ScanSet, TechniqueReport]:
        table = spec.table
        P = table.num_partitions
        if not pipe.enable_filter or isinstance(spec.pred, E.TruePred):
            ss = live_full_scan(table)
            if not isinstance(spec.pred, E.TruePred):
                # Filter disabled but a predicate exists: no partition is
                # *certified* fully matching — FULL here would let the
                # LIMIT cutter trust uncertified rows and drop true
                # results.
                ss = ScanSet(ss.part_ids,
                             np.full(len(ss), PARTIAL_MATCH, dtype=np.int8))
            return ss, TechniqueReport(P, len(ss), applied=False)
        tv = None
        if pipe.filter_mode == "device":
            # Delegate to the PruningService: resident device stats
            # (staged once per table version) + the batched kernel.
            tv = pipe.device_service().scan_tv(spec)
        if tv is None:
            tv = eval_tv(spec.pred, table.stats)
        # Dropped partitions never enter a scan set, on any path — the
        # same mask the device plane encodes as sentinel slots.
        tv = mask_dead_partitions(tv, table)
        keep = tv > NO_MATCH
        ss = ScanSet(np.where(keep)[0], tv[keep])
        return ss, TechniqueReport(P, len(ss), applied=True)

    def run_batch(self, pipe, states, service=None):
        if (service is not None and pipe.enable_filter
                and pipe.filter_mode == "device"):
            batch_sets = service.prune_batch([st.query for st in states])
            for st, fs in zip(states, batch_sets):
                if st.filter_sets:       # caller-injected sets win
                    fs = {**fs, **st.filter_sets}
                st.filter_sets = fs
        for st in states:
            self.run(pipe, st)


class LimitTechnique(Technique):
    """Sec. 4 LIMIT pruning over fully-matching partitions (host-only:
    compile-time metadata arithmetic, never a kernel launch)."""

    name = "limit"

    def run(self, pipe, state):
        q = state.query
        if not (pipe.enable_limit and q.is_plain_limit):
            return
        for name, spec in q.scans.items():
            res = limit_prune(
                state.scan_sets[name],
                spec.table.stats,
                q.effective_k,
                supported_shape=pipe._limit_supported(q, name),
            )
            state.scan_sets[name] = res.scan
            state.per_scan[name]["limit"] = TechniqueReport(
                res.partitions_before, res.partitions_after,
                res.applied, detail=dict(category=res.category),
            )


class PruningPipeline:
    def __init__(
        self,
        enable_filter: bool = True,
        enable_limit: bool = True,
        filter_mode: str = "host",   # 'host' | 'device': the pipeline's
                                     # execution mode.  'device' routes the
                                     # filter stage through the
                                     # PruningService's resident metadata
                                     # planes and batched kernel.
        service=None,                # serve.prune_service.PruningService;
                                     # built lazily for filter_mode='device'
        budget_bytes: Optional[int] = None,
                                     # device-memory budget for the
                                     # lazily-built service's plane manager
                                     # (None keeps the planes unbounded).
        device=None,                 # the lazily-built service's device:
                                     # None is the GPU (raises without
                                     # one); 'cpu' runs the plain path.
    ):
        if filter_mode not in ("host", "device"):
            raise ValueError(f"unknown filter_mode {filter_mode!r}")
        self.enable_filter = enable_filter
        self.enable_limit = enable_limit
        self.filter_mode = filter_mode
        if service is not None and (budget_bytes is not None
                                    or device is not None):
            # silently dropping these would run the service unbounded or
            # on another device than asked
            raise ValueError(
                "budget_bytes / device configure the lazily-built service; "
                "pass them to the PruningService itself when providing one")
        self._service = service
        self._budget_bytes = budget_bytes
        self._device = device
        self.techniques: List[Technique] = [FilterTechnique(),
                                            LimitTechnique()]

    def device_service(self):
        """The PruningService backing filter_mode='device' (lazy).

        Built on the GPU unless the pipeline was given ``device='cpu'``;
        without a card it raises rather than carrying on on the CPU.
        Sharing one service across pipelines shares its DeviceStatsCache —
        tables are staged once per version, not once per pipeline.
        """
        if self._service is None:
            from ..serve.prune_service import PruningService
            self._service = PruningService(budget_bytes=self._budget_bytes,
                                           device=self._device)
        return self._service

    # -- shape gates shared by executors -------------------------------------

    def _limit_supported(self, q: Query, name: str) -> bool:
        """Sec. 4.3 pushdown rules: row-reducing operators block LIMIT
        pushdown, except through the preserved side of a LEFT OUTER join."""
        if q.group_by or q.order_by is not None:
            return False
        if q.join is None:
            return True
        return q.join.kind == "left_outer" and name == q.join.probe

    # -- running the sequence ----------------------------------------------

    def make_state(self, q: Query,
                   filter_sets: Optional[Dict[str, ScanSet]] = None
                   ) -> PruneState:
        return PruneState(query=q, per_scan={n: {} for n in q.scans},
                          filter_sets=filter_sets)

    def finish(self, state: PruneState) -> PruningReport:
        return PruningReport(state.per_scan, state.scan_sets)

    def run(self, q: Query, filter_sets: Optional[Dict[str, ScanSet]] = None
            ) -> PruningReport:
        """Run the technique sequence for one query; ``filter_sets``
        injects precomputed filter scan sets (PruningService.run_batch
        batches that stage across a workload) — later techniques run
        unchanged on top of them."""
        check_supported(q)
        state = self.make_state(q, filter_sets)
        for tech in self.techniques:
            tech.run(self, state)
        return self.finish(state)
