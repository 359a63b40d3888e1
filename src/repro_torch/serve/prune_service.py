"""PruningService: the workload-facing engine of the device plane.

A production metadata service (paper Sec. 2) answers pruning questions for
*every* query of a heavy workload, not one query at a time.  This service
accepts a batch of ``core.flow.Query`` objects and drives the pipeline's
technique sequence over them — in this slice of the port, filter then
LIMIT:

  * **filter** (``prune_batch``): each scan's predicate is lowered to
    conjunctive ranges; lowered scans are grouped by table and evaluated
    by one ``minmax_prune_batched`` launch per group against the resident
    [C, P] planes (non-lowerable predicates fall back to the host
    evaluator, counted, never wrong);
  * **LIMIT** runs on the host over the filter stage's FULL partitions
    and launches nothing.

A query with a JOIN or an ORDER BY raises ``NotImplementedError`` before
any stage runs: those stages are not ported yet, and running the
reference's sequence without them would answer a different question.

Device: the service runs on the GPU (``device=None``) unless the caller
asks for ``device="cpu"``; without a card it raises.  On the GPU the
kernel library is built and loaded when the service is constructed,
outside any ladder rung, so a build failure raises here instead of
demoting every launch to the host.

Counters: ``ServiceCounters`` tracks launches and host fallbacks both in
aggregate and per technique (``counters.technique``), and ``run_batch``
attaches a snapshot to every report (``PruningReport.counters``) so a run
can show which rung served each stage.

DML: a table's own DML methods bump its ``version``, and the next
launch's ``DeviceStatsCache.get`` restages the plane in full.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import expr as E
from ..core.device_stats import (DeviceStatsCache, PlaneMemoryManager,
                                 resolve_device)
from ..core.flow import check_supported
from ..core.metadata import (NO_MATCH, PARTIAL_MATCH, ScanSet,
                             live_full_scan, mask_dead_partitions)
from ..core.prune_filter import eval_tv, extract_ranges
from ..kernels import ops as kops
from ..kernels.build import KernelError
from ..kernels.minmax_prune_batched import load_kernel
from .resilience import (DegradationLadder, new_resilience_counters,
                         resilience_delta, resilience_snapshot)

# Registered DegradationLadder launch sites: the only methods allowed to
# call ``kops.*_batched_*`` entrypoints.  Each builds a rung list that is
# executed exclusively through ``self.ladder.execute``.
LADDER_LAUNCH_SITES = frozenset({
    "PruningService._filter_rungs",
})


@dataclasses.dataclass
class ServiceCounters:
    queries: int = 0
    scans: int = 0
    launches: int = 0          # batched kernel launches, all techniques
    host_fallbacks: int = 0    # host fallbacks, all techniques
    # per-technique attribution: {'filter': {'launches': n, 'fallbacks': m}}
    technique: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def bump(self, tech: str, launches: int = 0, fallbacks: int = 0) -> None:
        t = self.technique.setdefault(tech, dict(launches=0, fallbacks=0))
        t["launches"] += launches
        t["fallbacks"] += fallbacks
        self.launches += launches
        self.host_fallbacks += fallbacks

    def snapshot(self) -> dict:
        return dict(queries=self.queries, scans=self.scans,
                    launches=self.launches,
                    host_fallbacks=self.host_fallbacks,
                    technique={k: dict(v) for k, v in self.technique.items()})

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """after - before of two snapshots: the activity in between."""
        out = {k: after[k] - before[k]
               for k in ("queries", "scans", "launches", "host_fallbacks")}
        zero = dict(launches=0, fallbacks=0)
        out["technique"] = {
            t: {f: v - before["technique"].get(t, zero)[f]
                for f, v in fields.items()}
            for t, fields in after["technique"].items()}
        return out


class PruningService:
    # bound on the memo of clean (stats, predicate) validations
    VALIDATED_CAP = 1 << 17

    def __init__(
        self,
        mode: str = "auto",            # kernel mode: auto|cuda|torch
        device=None,                   # None: the GPU (raises without
                                       # one); 'cpu': the plain path
        budget_bytes: Optional[int] = None,  # device-memory budget for the
                                             # resident planes (None:
                                             # unbounded)
        fault_injector=None,           # serve.resilience.FaultInjector chaos
                                       # seam (None: zero-overhead disabled)
        backoff=None,                  # resilience.BackoffPolicy for the
                                       # degradation ladder's retries
        deadline_s: Optional[float] = None,  # per-rung deadline (seconds)
        clock=None,                    # injectable monotonic clock (tests)
        sleep=None,                    # injectable sleep (tests: no real
                                       # sleeps under the fake clock)
        integrity_sample: Optional[int] = None,  # cache checksum-verify
                                       # schedule: every n-th read (1 =
                                       # every read; None keeps the
                                       # cache's default)
    ):
        dev = resolve_device(device)
        kops.check_mode(mode, dev)
        self.mode = mode
        self.device = dev
        self.cache = DeviceStatsCache(
            budget_bytes=budget_bytes, fault_injector=fault_injector,
            device=dev,
            **({} if integrity_sample is None
               else dict(integrity_sample=integrity_sample)))
        if dev.type == "cuda":
            # build + bind the kernel now: a build failure must raise
            # here, not inside a ladder rung that would demote past it
            load_kernel()
        self.counters = ServiceCounters()
        self.fault_injector = fault_injector
        # (stats uid, pred repr) pairs that validated clean (_validate_query)
        self._validated: set = set()
        # The resilience layer: every batched launch executes through the
        # degradation ladder (device -> host kernel -> host oracle ->
        # passthrough), so an injected fault, a torn plane, or a deadline
        # costs pruning quality, never correctness and never an exception
        # out of run_batch; a KernelError is let through, never demoted.
        # Demotions and retries surface per batch under
        # ``PruningReport.counters["resilience"]``.
        self.resilience = new_resilience_counters()
        self.ladder = DegradationLadder(
            policy=backoff, deadline_s=deadline_s, clock=clock, sleep=sleep,
            counters=self.resilience)

    def _fire(self, site: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector.fire(site)

    # -- filter stage -------------------------------------------------------

    @staticmethod
    def _scan_set(tv: np.ndarray, table=None) -> ScanSet:
        if table is not None:
            tv = mask_dead_partitions(tv, table)
        keep = tv > NO_MATCH
        return ScanSet(np.where(keep)[0], tv[keep])

    @staticmethod
    def _passthrough_set(table) -> ScanSet:
        """The ladder's bottom rung: keep every live partition, PARTIAL.

        Never FULL — an uncertified partition declared FULL would let the
        LIMIT cutter trust rows the predicate was never checked against
        (the same demotion ``flow._prune_scan`` applies with the filter
        stage disabled)."""
        ss = live_full_scan(table)
        return ScanSet(ss.part_ids,
                       np.full(len(ss), PARTIAL_MATCH, dtype=np.int8))

    def _filter_rungs(self, table, range_lists, preds) -> list:
        """The filter stage's full rung chain for one table group.

        Every rung returns the same contract: tv ``[Q, P]`` int8 rows
        (None from the passthrough rung — the caller keeps every live
        partition as PARTIAL).  The host kernel is exact f64 over the
        same lowered ranges; the host oracle re-evaluates each predicate
        tree — both bit-identical to ``eval_tv`` for lowerable
        predicates, so stopping at any rung costs latency, not pruning
        quality.
        """
        def device():
            self._fire("launch.filter:device")
            # Pin scope: the planes this launch reads must not be evicted
            # (by another table's staging under the budget) while the
            # launch is in flight.
            with self.cache.pin_scope():
                dstats = self.cache.get(table)
                tv = kops.prune_ranges_batched_device(range_lists, dstats,
                                                      self.mode)
                self.counters.bump("filter", launches=1)
            return tv

        def host_kernel():
            self._fire("launch.filter:host_kernel")
            tv = kops.prune_ranges_batched_host(range_lists, table.stats)
            self.counters.bump("filter", fallbacks=1)
            return tv

        def host_oracle():
            self._fire("launch.filter:host_oracle")
            tv = np.stack([np.asarray(eval_tv(pred, table.stats),
                                      dtype=np.int8) for pred in preds])
            self.counters.bump("filter", fallbacks=1)
            return tv

        return [
            ("device", device),
            ("host_kernel", host_kernel),
            ("host_oracle", host_oracle),
            ("passthrough", lambda: None),
        ]

    def scan_tv(self, spec) -> Optional[np.ndarray]:
        """Device tv [P] for one scan, or None when it doesn't lower (or
        when the ladder degraded past the host kernel — the caller's own
        host evaluator takes over either way).

        The single-query path of the batched plane, which
        ``PruningPipeline`` calls for ``filter_mode="device"``.  Counts
        scans/launches/fallbacks like prune_batch.
        """
        self.counters.scans += 1
        ranges = extract_ranges(spec.pred, spec.table.stats)
        if ranges is None:
            self.counters.bump("filter", fallbacks=1)
            return None
        # device rung + host kernel; the terminal rung hands back None
        # so flow's _prune_scan runs its own eval_tv host path
        rungs = self._filter_rungs(spec.table, [ranges], [spec.pred])[:-2]
        rungs.append(("host_oracle", lambda: None))
        tv_rows, _rung = self.ladder.execute(rungs)
        if tv_rows is None:
            self.counters.bump("filter", fallbacks=1)
            return None
        return tv_rows[0]

    def prune_batch(self, queries: Sequence) -> List[Dict[str, ScanSet]]:
        """Filter-prune a batch of queries; per-query scan_name -> ScanSet.

        One batched kernel launch per distinct table (not per query),
        executed through the degradation ladder; queries whose predicates
        don't lower are evaluated on the host, and a scan whose every
        prover failed (malformed spec slipping past validation) degrades
        to a keep-everything PARTIAL set — counted, never raised.
        """
        self.counters.queries += len(queries)
        results: List[Dict[str, ScanSet]] = [dict() for _ in queries]
        # id(table) -> (table, [(query idx, scan name, ranges, pred), ...])
        groups: Dict[int, Tuple[object, list]] = {}
        fallbacks: List[Tuple[int, str, object]] = []
        for qi, q in enumerate(queries):
            for name, spec in q.scans.items():
                self.counters.scans += 1
                if isinstance(spec.pred, E.TruePred):
                    results[qi][name] = live_full_scan(spec.table)
                    continue
                try:
                    ranges = extract_ranges(spec.pred, spec.table.stats)
                except Exception:
                    # malformed spec (unknown column / bad literal):
                    # isolate to this scan, keep the batch on course
                    self.resilience["errors"] += 1
                    results[qi][name] = self._passthrough_set(spec.table)
                    continue
                if ranges is None:
                    fallbacks.append((qi, name, spec))
                    continue
                groups.setdefault(id(spec.table), (spec.table, []))[1].append(
                    (qi, name, ranges, spec.pred))
        for table, jobs in groups.values():
            tv_rows, _rung = self.ladder.execute(self._filter_rungs(
                table, [ranges for _, _, ranges, _ in jobs],
                [pred for _, _, _, pred in jobs]))
            rows = [None] * len(jobs) if tv_rows is None else list(tv_rows)
            for (qi, name, _ranges, _pred), tv in zip(jobs, rows):
                results[qi][name] = (self._passthrough_set(table)
                                     if tv is None
                                     else self._scan_set(tv, table))
        for qi, name, spec in fallbacks:
            self.counters.bump("filter", fallbacks=1)
            try:
                tv = eval_tv(spec.pred, spec.table.stats)
            except Exception:
                self.resilience["errors"] += 1
                results[qi][name] = self._passthrough_set(spec.table)
                continue
            results[qi][name] = self._scan_set(tv, spec.table)
        return results

    # -- workload entry points ----------------------------------------------

    def _validate_query(self, q) -> None:
        """Raise the spec's own error for a malformed query spec.

        Probes each scan's predicate against a one-partition stats slice
        (O(1) per scan, not O(P)) so unknown columns and bad literal
        dtypes surface *here*, at validation time — ``run_batch``
        isolates the raise to this query instead of letting it abort the
        batch mid-launch.  Clean probes are memoized per (stats identity,
        predicate); failed probes are never cached.
        """
        for spec in q.scans.values():
            stats = spec.table.stats
            vkey = (stats.uid, repr(spec.pred))
            if vkey in self._validated:
                continue
            probe = (stats.select(np.zeros(1, dtype=np.int64))
                     if stats.num_partitions > 1 else stats)
            eval_tv(spec.pred, probe)
            if len(self._validated) > self.VALIDATED_CAP:
                self._validated.clear()
            self._validated.add(vkey)

    def _passthrough_report(self, pipeline, q):
        """A no-prune report for a query the engine refused to run
        (malformed spec / unsalvageable failure): every scan keeps all
        live partitions as PARTIAL, no technique applied."""
        from ..core.flow import TechniqueReport
        st = pipeline.make_state(q)
        for name, spec in q.scans.items():
            ss = self._passthrough_set(spec.table)
            st.scan_sets[name] = ss
            st.per_scan[name]["filter"] = TechniqueReport(
                spec.table.num_partitions, len(ss), applied=False,
                detail=dict(path="passthrough"))
        return pipeline.finish(st)

    def run_batch(self, queries: Sequence, pipeline=None) -> List:
        """Filter + LIMIT pruning over a workload, the filter stage
        batched per table group.

        Returns one ``PruningReport`` per query, identical to running
        ``pipeline.run(q)`` per query in the same mode.  Each report
        carries its own copy of THIS batch's counter delta (not the
        service-lifetime totals), including the resilience block
        (``counters["resilience"]``) and the plane-integrity block
        (``counters["integrity"]``).

        A query with a JOIN or an ORDER BY raises ``NotImplementedError``
        before any stage runs.  Otherwise ``run_batch`` never raises for
        a query-shaped problem: malformed specs become no-prune
        passthrough reports (``errors`` counter); launch/staging/plane
        failures degrade through the ladder; an unexpected batch-level
        failure falls back to per-query execution
        (``salvaged_batches``).  A ``kernels.build.KernelError`` (the
        kernel failed to build, to take its inputs or to launch) is not
        such a problem and raises.
        """
        for q in queries:
            check_supported(q)
        from ..core.flow import PruningPipeline
        if pipeline is None:
            pipeline = PruningPipeline(filter_mode="device", service=self)
        # Only batch the filter stage when the pipeline itself declares
        # the device path — a host pipeline keeps its own semantics.
        device = pipeline.filter_mode == "device"
        before = self.counters.snapshot()
        before_staging = self.cache.staging_snapshot()
        before_memory = self.cache.memory.snapshot()
        before_res = resilience_snapshot(self.resilience)
        before_integrity = self.cache.integrity_snapshot()
        # per-query spec validation — one malformed query becomes one
        # passthrough report, the rest stay on the fast path
        invalid: Dict[int, object] = {}
        valid: List[Tuple[int, object]] = []
        for i, q in enumerate(queries):
            try:
                self._validate_query(q)
            except Exception:
                self.resilience["errors"] += 1
                invalid[i] = q
            else:
                valid.append((i, q))
        states = [pipeline.make_state(q) for _, q in valid]
        try:
            for tech in pipeline.techniques:
                tech.run_batch(pipeline, states,
                               service=self if device else None)
            good = [pipeline.finish(s) for s in states]
        except KernelError:
            raise                   # a broken kernel is not salvaged
        except Exception:
            # Last-resort guard: something outside the ladder's reach
            # broke the batched drive.  Salvage per query; a query that
            # still fails degrades to a passthrough report.
            self.resilience["salvaged_batches"] += 1
            good = []
            for _i, q in valid:
                try:
                    good.append(pipeline.run(q))
                except KernelError:
                    raise
                except Exception:
                    self.resilience["errors"] += 1
                    good.append(self._passthrough_report(pipeline, q))
        reports: List = [None] * len(queries)
        for (i, _q), rep in zip(valid, good):
            reports[i] = rep
        for i, q in invalid.items():
            reports[i] = self._passthrough_report(pipeline, q)
        delta = ServiceCounters.delta(before, self.counters.snapshot())
        after_staging = self.cache.staging_snapshot()
        staging = {k: after_staging[k] - before_staging[k]
                   for k in after_staging}
        memory = PlaneMemoryManager.delta(before_memory,
                                          self.cache.memory.snapshot())
        res = resilience_delta(before_res,
                               resilience_snapshot(self.resilience))
        after_integrity = self.cache.integrity_snapshot()
        integrity = {k: after_integrity[k] - before_integrity[k]
                     for k in after_integrity}
        # PlaneEpoch per table touched by the batch: what the launches
        # actually ran against (version, live count, capacity)
        planes: Dict[str, dict] = {}
        for q in queries:
            for spec in q.scans.values():
                epoch = self.cache.plane_epoch(spec.table)
                if epoch is not None:
                    planes[spec.table.name] = dataclasses.asdict(epoch)
        for r in reports:
            # each report owns its copy — mutating one never leaks
            r.counters = {**delta,
                          "technique": {k: dict(v)
                                        for k, v in delta["technique"].items()},
                          "staging": dict(staging),
                          "memory": dict(memory),
                          "resilience": {**res,
                                         "demotions": dict(res["demotions"])},
                          "integrity": dict(integrity),
                          "planes": {k: dict(v) for k, v in planes.items()}}
        return reports

    def run_fleet(self, batches: Sequence[Sequence], pipeline=None) -> List:
        """A sequence of query batches driven through ``run_batch``
        under the configured memory budget; one report list per batch."""
        return [self.run_batch(b, pipeline) for b in batches]

    def fleet_summary(self) -> dict:
        """Service-lifetime memory + staging + launch counters: the
        budget-sizing view (is the budget thrashing? what fraction of
        getter traffic hit resident planes?)."""
        mem = self.cache.memory.snapshot()
        total = mem["hits"] + mem["misses"]
        return dict(memory=mem,
                    staging=self.cache.staging_snapshot(),
                    counters=self.counters.snapshot(),
                    resilience=resilience_snapshot(self.resilience),
                    integrity=self.cache.integrity_snapshot(),
                    plane_hit_rate=(mem["hits"] / total) if total else 0.0)
