"""The combined pruning flow (paper Sec. 7) as a technique-executor engine.

Techniques execute in Snowflake's order:
    filter pruning (compile time, Sec. 3)
      -> LIMIT pruning (compile time, extends filter pruning, Sec. 4)
      -> JOIN pruning  (runtime, Sec. 6)
      -> top-k pruning (runtime, Sec. 5)


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
    states, service)``, where device-eligible stages (filter, join
    overlap, top-k boundary init) group their kernel work **per table**
    so launches are bounded by the number of distinct tables, not the
    number of queries.

Both regimes produce bit-identical ``PruningReport``s: the batched path
evaluates exactly the same per-query math, only packed into shared
launches against the resident metadata planes (core/device_stats.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import tracing
from . import expr as E
from .metadata import (NO_MATCH, PARTIAL_MATCH, ScanSet, live_full_scan,
                       mask_dead_partitions, pruning_ratio)
from .prune_filter import eval_tv
from .prune_join import BuildSummary, prune_probe, summarize_build
from .prune_limit import limit_prune
from .prune_topk import TopKResult, run_topk
from .prune_tree import AdaptivePruner
from .rowval import matches


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
    def is_topk(self) -> bool:
        return self.limit is not None and self.order_by is not None

    @property
    def is_plain_limit(self) -> bool:
        return self.limit is not None and self.order_by is None


@dataclasses.dataclass
class TechniqueReport:
    before: int
    after: int
    applied: bool
    detail: dict = dataclasses.field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return pruning_ratio(self.before, self.after)


@dataclasses.dataclass
class PruningReport:
    per_scan: Dict[str, Dict[str, TechniqueReport]]
    scan_sets: Dict[str, ScanSet]
    topk: Optional[TopKResult] = None
    topk_scan: Optional[str] = None   # scan name the top-k technique targeted
    counters: Optional[dict] = None   # this batch's ServiceCounters delta
                                      # (attached by PruningService.run_batch)

    def technique_totals(self) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for scans in self.per_scan.values():
            for tech, rep in scans.items():
                b, a = out.get(tech, (0, 0))
                out[tech] = (b + rep.before, a + rep.after)
        return out

    @property
    def overall_ratio(self) -> float:
        """Partitions removed by ANY technique / total partitions touched
        by the query — the paper's whole-query pruning ratio (Fig. 4
        'relative to the total number of partitions to be processed').

        ``topk.skipped`` partitions are not removed from ``scan_sets`` by
        the engine, so they are subtracted here — but only those still
        *present* in the target scan set, guarding against a caller that
        already removed them (double subtraction would overstate the
        ratio, even past 1.0)."""
        total = sum(s.table.num_partitions for s in self._scan_specs.values())
        remaining = sum(len(ss) for ss in self.scan_sets.values())
        if self.topk is not None and len(self.topk.skipped):
            if self.topk_scan is not None:
                target = self.scan_sets.get(self.topk_scan)
                present = (int(np.isin(self.topk.skipped,
                                       target.part_ids).sum())
                           if target is not None else 0)
            else:
                # Reports without a recorded target scan: the skipped ids
                # all belong to ONE (unknown) table, so take the largest
                # single-scan intersection — partition ids are table-local
                # and comparing against a concatenation of every scan
                # would let another table's ids collide.
                present = max((int(np.isin(self.topk.skipped,
                                           ss.part_ids).sum())
                               for ss in self.scan_sets.values()),
                              default=0)
            remaining -= present
        return pruning_ratio(total, remaining)

    _scan_specs: Dict[str, TableScanSpec] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class PruneState:
    """Mutable per-query state threaded through the technique sequence."""

    query: Query
    scan_sets: Dict[str, ScanSet] = dataclasses.field(default_factory=dict)
    per_scan: Dict[str, Dict[str, TechniqueReport]] = dataclasses.field(
        default_factory=dict)
    filter_sets: Optional[Dict[str, ScanSet]] = None  # injected filter results
    build_keys: Optional[np.ndarray] = None           # join build-side keys
    build_summary: Optional[BuildSummary] = None      # their summary, if
                                                      # made on the card
    topk: Optional[TopKResult] = None
    topk_scan: Optional[str] = None
    rid: Optional[int] = None    # the query's id on its spans: the
                                 # front-end's request id, or its position
                                 # in the batch (set while tracing)


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
                # LIMIT cutter and the Sec. 5.4 boundary initializers
                # (host and device) trust uncertified rows and drop true
                # results.
                ss = ScanSet(ss.part_ids,
                             np.full(len(ss), PARTIAL_MATCH, dtype=np.int8))
            return ss, TechniqueReport(P, len(ss), applied=False)
        if pipe.adaptive:
            # Sec. 3.2's adaptive tree: host f64, whatever the mode
            res = AdaptivePruner(spec.pred).run(table.stats,
                                               batch_size=max(P // 8, 1))
            tv = res.tv
        else:
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
        if (service is not None and pipe.enable_filter and not pipe.adaptive
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


class JoinTechnique(Technique):
    """Sec. 6 JOIN pruning.  The build side is summarized from its runtime
    values: on the card for a large integer build side under a CUDA
    service (``PruningService.summary_on_card``), else on the host; in
    device mode the probe-side matching runs on the resident planes — the
    distinct-key overlap via ``join_overlap_batched`` over the join-key
    plane, the Bloom narrow-range enumeration via
    ``bloom_probe_batched`` over the enumeration plane — one launch per
    (table, key column, summary kind) group in ``run_batch``.
    Non-castable distinct keys and non-integer Bloom key domains fall
    back to the host matcher (counted per technique, never wrong)."""

    name = "join"

    def _build_keys(self, state: PruneState) -> np.ndarray:
        q = state.query
        bspec = q.scans[q.join.build]
        bctx = bspec.table.ctx_for(state.scan_sets[q.join.build].part_ids)
        bmask = matches(bspec.pred, bctx)
        keys, knulls = bctx.col(q.join.build_key)
        return keys[bmask & ~knulls]

    def _prepare(self, pipe, states, service=None) -> None:
        """The stage's build part: each join's build keys (which also feed
        the top-k technique's extra mask) and, for the build sides that
        ``service`` summarises on the card, their summaries, made by one
        ``join_summary_batch`` call inside one ``join.summary`` span."""
        card = []
        for st in states:
            if st.query.join is None:
                continue
            with tracing.span("join.build", rid=st.rid):
                st.build_keys = self._build_keys(st)
            q = st.query
            if pipe.enable_join and service is not None and \
                    service.summary_on_card(st.build_keys,
                                            q.scans[q.join.build].table.stats,
                                            q.join.build_key):
                card.append(st)
        if card:
            with tracing.span("join.summary",
                              rids=tuple(st.rid for st in card)):
                made = service.join_summary_batch(
                    [st.build_keys for st in card], pipe.join_ndv_limit)
            for st, summary in zip(card, made):
                st.build_summary = summary

    def _summarize(self, pipe, state) -> Optional[BuildSummary]:
        """One prepared state's build summary: the card's, else the
        host's ``summarize_build``.  None when the stage is disabled."""
        if state.query.join is None or not pipe.enable_join:
            return None
        if state.build_summary is not None:
            return state.build_summary
        with tracing.span("join.summary", rid=state.rid):
            return summarize_build(state.build_keys,
                                   ndv_limit=pipe.join_ndv_limit)

    def _apply(self, pipe, state, summary: BuildSummary,
               hit: Optional[np.ndarray]) -> None:
        """Overlap + prune the probe scan; ``hit`` is the device result
        [P] — distinct-key overlap or Bloom enumeration, per the summary
        kind (None -> host matcher)."""
        q = state.query
        scan = state.scan_sets[q.join.probe]
        over = None if hit is None else np.asarray(hit)[scan.part_ids] > 0
        with tracing.span("join.match", rid=state.rid):
            res = prune_probe(
                scan, q.scans[q.join.probe].table.stats,
                q.join.probe_key, summary,
                distinct_hit=over if summary.distinct is not None else None,
                bloom_hit=over if summary.bloom is not None else None,
            )
        state.scan_sets[q.join.probe] = res.scan
        state.per_scan[q.join.probe]["join"] = TechniqueReport(
            res.partitions_before, res.partitions_after,
            applied=True,
            detail=dict(
                by_range=res.pruned_by_range,
                by_distinct=res.pruned_by_distinct,
                by_bloom=res.pruned_by_bloom,
                summary_bytes=summary.size_bytes,
                summary_kind=(
                    "distinct" if summary.distinct is not None
                    else "bloom" if summary.bloom is not None else "empty"
                ),
                path="device" if hit is not None else "host",
            ),
        )

    def run(self, pipe, state):
        if state.query.join is None:
            return
        device = pipe.filter_mode == "device" and not pipe.adaptive
        service = pipe.device_service() if device else None
        self._prepare(pipe, [state], service)
        summary = self._summarize(pipe, state)
        if summary is None:
            return
        hit = None
        if device:
            q = state.query
            hit = service.join_hit(
                q.scans[q.join.probe].table, q.join.probe_key, summary,
                part_ids=state.scan_sets[q.join.probe].part_ids)
        self._apply(pipe, state, summary, hit)

    def run_batch(self, pipe, states, service=None):
        if service is None:
            return super().run_batch(pipe, states, service)
        # (table id, probe key) -> (table, key_col, [(state, summary)]),
        # one group dict per summary kind: distinct overlaps and Bloom
        # enumerations are different kernels, each one launch per group.
        groups: Dict[Tuple, Tuple] = {}
        bloom_groups: Dict[Tuple, Tuple] = {}
        host_jobs = []
        self._prepare(pipe, states, service)
        for st in states:
            summary = self._summarize(pipe, st)
            if summary is None:
                continue
            q = st.query
            table = q.scans[q.join.probe].table
            if not service.join_device_eligible(summary, table,
                                                q.join.probe_key):
                host_jobs.append((st, summary))
                continue
            g = groups if summary.distinct is not None else bloom_groups
            g.setdefault(
                (id(table), q.join.probe_key),
                (table, q.join.probe_key, []))[2].append((st, summary))
        for batch_fn, group in ((service.join_hit_batch, groups),
                                (service.bloom_hit_batch, bloom_groups)):
            for table, key_col, members in group.values():
                hits = batch_fn(
                    table, key_col, [s for _, s in members],
                    part_ids=[st.scan_sets[st.query.join.probe].part_ids
                              for st, _ in members])
                if hits is None:
                    # the service's ladder degraded this group past the
                    # device rung: the host matcher (hit=None per member)
                    # is the stage's exact terminal rung
                    hits = [None] * len(members)
                for (st, summary), hit in zip(members, hits):
                    self._apply(pipe, st, summary, hit)
        for st, summary in host_jobs:
            if not summary.empty:
                service.counters.bump(
                    "join_bloom" if summary.bloom is not None else self.name,
                    fallbacks=1)
            self._apply(pipe, st, summary, None)


class TopKTechnique(Technique):
    """Sec. 5 top-k boundary pruning.  The scan loop stays on the host
    (it fetches real rows); in device mode the Sec. 5.4 upfront boundary
    is *initialized from the resident block-top-k plane* — the k-th
    largest value over the fully-matching partitions' resident top-k
    rows, a strictly stronger (still witnessed) boundary than the
    stats-only candidates — via one batched ``topk_init_batched`` launch
    per (table, order column, direction) group in ``run_batch``."""

    name = "topk"

    def _extra_mask(self, state: PruneState):
        q = state.query
        scan_name, _col, _desc = q.order_by
        if (q.join is not None and scan_name == q.join.probe
                and q.join.kind == "inner"):
            key_col = q.join.probe_key
            bk = (np.unique(state.build_keys)
                  if state.build_keys is not None else np.zeros(0))

            def extra(ctx, _bk=bk, _kc=key_col):
                v, nm = ctx.col(_kc)
                return np.isin(v, _bk) & ~nm

            return extra
        return None

    def _device_eligible(self, pipe, state, extra) -> bool:
        # Upfront boundaries are only valid without interposed operators
        # (Sec. 5.4) — mirroring run_topk's own use_upfront_init gate.
        # Adaptive pipelines keep their own (host) semantics throughout,
        # like the filter stage.
        q = state.query
        return (pipe.filter_mode == "device" and not pipe.adaptive
                and pipe.topk_upfront_init
                and extra is None and q.effective_k > 0)

    def _apply(self, pipe, state, extra, b_floor: float, path: str) -> None:
        q = state.query
        scan_name, order_col, desc = q.order_by
        spec = q.scans[scan_name]
        with tracing.query(state.rid):
            topk_res = run_topk(
                spec.table, state.scan_sets[scan_name], order_col,
                q.effective_k,
                pred=(spec.pred if not isinstance(spec.pred, E.TruePred)
                      else None),
                desc=desc, strategy=pipe.topk_strategy,
                use_upfront_init=pipe.topk_upfront_init,
                extra_mask_fn=extra, b_init_floor=b_floor,
            )
        before = len(state.scan_sets[scan_name])
        state.per_scan[scan_name]["topk"] = TechniqueReport(
            before, before - len(topk_res.skipped), applied=True,
            detail=dict(rows_scanned=topk_res.rows_scanned, path=path,
                        b_init_floor=b_floor),
        )
        state.topk = topk_res
        state.topk_scan = scan_name

    def run(self, pipe, state):
        q = state.query
        target = pipe._topk_supported(q)
        if not (pipe.enable_topk and target is not None):
            return
        extra = self._extra_mask(state)
        b_floor, path = -np.inf, "host"
        if self._device_eligible(pipe, state, extra):
            scan_name, order_col, desc = q.order_by
            b_floor = pipe.device_service().topk_init(
                q.scans[scan_name].table, state.scan_sets[scan_name],
                order_col, bool(desc), q.effective_k)
            path = "device"
        elif pipe.filter_mode == "device" and not pipe.adaptive:
            pipe.device_service().counters.bump(self.name, fallbacks=1)
        self._apply(pipe, state, extra, b_floor, path)

    def run_batch(self, pipe, states, service=None):
        if service is None:
            return super().run_batch(pipe, states, service)
        # (table id, order col, desc) -> (table, col, desc, [(state, extra, k)])
        groups: Dict[Tuple, Tuple] = {}
        host_jobs = []
        for st in states:
            q = st.query
            target = pipe._topk_supported(q)
            if not (pipe.enable_topk and target is not None):
                continue
            extra = self._extra_mask(st)
            if not self._device_eligible(pipe, st, extra):
                host_jobs.append((st, extra))
                continue
            scan_name, order_col, desc = q.order_by
            table = q.scans[scan_name].table
            groups.setdefault(
                (id(table), order_col, bool(desc)),
                (table, order_col, bool(desc), []))[3].append(
                    (st, extra, q.effective_k))
        for table, col, desc, members in groups.values():
            floors = service.topk_init_batch(
                table, col, desc,
                [(st.scan_sets[st.query.order_by[0]], k)
                 for st, _, k in members])
            for (st, extra, _k), floor in zip(members, floors):
                self._apply(pipe, st, extra, floor, "device")
        for st, extra in host_jobs:
            service.counters.bump(self.name, fallbacks=1)
            self._apply(pipe, st, extra, -np.inf, "host")


class PruningPipeline:
    def __init__(
        self,
        topk_strategy: str = "sort",
        topk_upfront_init: bool = True,
        adaptive: bool = False,
        enable_filter: bool = True,
        enable_limit: bool = True,
        enable_join: bool = True,
        enable_topk: bool = True,
        join_ndv_limit: int = 4096,
        filter_mode: str = "host",   # 'host' | 'device': the pipeline's
                                     # execution mode.  'device' routes every
                                     # device-eligible stage (filter ranges,
                                     # join overlap, top-k boundary init)
                                     # through the PruningService's resident
                                     # metadata planes and batched kernels.
        service=None,                # serve.prune_service.PruningService;
                                     # built lazily for filter_mode='device'
        budget_bytes: Optional[int] = None,
                                     # device-memory budget for the
                                     # lazily-built service's plane manager
                                     # (None keeps the planes unbounded).
        device=None,                 # the lazily-built service's device:
                                     # None is the GPU (raises without
                                     # one); 'cpu' runs the plain path.
        tree_fanout: Optional[int] = None,
                                     # tree-plane group size for the
                                     # lazily-built service (None keeps
                                     # every table on the flat rungs;
                                     # tests shrink it so small tables
                                     # take the tree rung).
        shard_planes: bool = False,  # partition-shard the lazily-built
                                     # service's batched launches over
                                     # launch.mesh.make_plane_mesh().
    ):
        if filter_mode not in ("host", "device"):
            raise ValueError(f"unknown filter_mode {filter_mode!r}")
        self.topk_strategy = topk_strategy
        self.topk_upfront_init = topk_upfront_init
        self.adaptive = adaptive
        self.enable_filter = enable_filter
        self.enable_limit = enable_limit
        self.enable_join = enable_join
        self.enable_topk = enable_topk
        self.join_ndv_limit = join_ndv_limit
        self.filter_mode = filter_mode
        if service is not None and (budget_bytes is not None
                                    or device is not None
                                    or tree_fanout is not None
                                    or shard_planes):
            # silently dropping these would run the service unbounded,
            # unsharded, on another device or with another geometry than
            # asked
            raise ValueError(
                "budget_bytes / device / tree_fanout / shard_planes "
                "configure the lazily-built service; pass them to the "
                "PruningService itself when providing one")
        self._service = service
        self._budget_bytes = budget_bytes
        self._tree_fanout = tree_fanout
        self._device = device
        self._shard_planes = shard_planes
        self.techniques: List[Technique] = [
            FilterTechnique(), LimitTechnique(),
            JoinTechnique(), TopKTechnique(),
        ]

    def device_service(self):
        """The PruningService backing filter_mode='device' (lazy).

        Built on the GPU unless the pipeline was given ``device='cpu'``;
        without a card it raises rather than carrying on on the CPU.
        Sharing one service across pipelines shares its DeviceStatsCache —
        tables are staged once per version, not once per pipeline.  With
        ``shard_planes`` its batched launches partition-shard over the
        plane mesh (on the CPU a one-device mesh: unsharded).
        """
        if self._service is None:
            from ..serve.prune_service import PruningService
            self._service = PruningService(
                budget_bytes=self._budget_bytes, device=self._device,
                tree_fanout=self._tree_fanout,
                shard_mesh=True if self._shard_planes else None)
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

    def _topk_supported(self, q: Query) -> Optional[str]:
        """Fig. 7 shapes: which scan can the TopK boundary prune?"""
        if not q.is_topk:
            return None
        scan_name, _col, _desc = q.order_by
        if q.group_by:
            # Fig. 7d: ORDER BY must be a subset of GROUP BY keys.
            return scan_name if not q.order_by_is_aggregate else None
        if q.join is None:
            return scan_name
        if scan_name == q.join.probe:
            return scan_name                     # Fig. 7b
        if q.join.kind == "left_outer" and scan_name == q.join.build:
            return scan_name                     # Fig. 7c: replicate to build
        return None

    # -- running the sequence ----------------------------------------------

    def make_state(self, q: Query,
                   filter_sets: Optional[Dict[str, ScanSet]] = None
                   ) -> PruneState:
        return PruneState(query=q, per_scan={n: {} for n in q.scans},
                          filter_sets=filter_sets)

    def finish(self, state: PruneState) -> PruningReport:
        report = PruningReport(state.per_scan, state.scan_sets,
                               state.topk, state.topk_scan)
        report._scan_specs = dict(state.query.scans)
        return report

    def run(self, q: Query, filter_sets: Optional[Dict[str, ScanSet]] = None
            ) -> PruningReport:
        """Run the technique sequence for one query; ``filter_sets``
        injects precomputed filter scan sets (PruningService.run_batch
        batches that stage across a workload) — later techniques run
        unchanged on top of them."""
        state = self.make_state(q, filter_sets)
        for tech in self.techniques:
            tech.run(self, state)
        return self.finish(state)
