"""PruningService: the workload-facing engine of the device plane.

A production metadata service (paper Sec. 2) answers pruning questions for
*every* query of a heavy workload, not one query at a time.  This service
accepts a batch of ``core.flow.Query`` objects and drives the pipeline's
technique sequence over them — filter, LIMIT, JOIN, top-k — with every
device-eligible stage batched per table group:

  * **filter** (``prune_batch``): each scan's predicate is lowered to
    conjunctive ranges; lowered scans are grouped by table and evaluated
    by one ``minmax_prune_batched`` launch per group against the resident
    [C, P] planes (non-lowerable predicates fall back to the host
    evaluator, counted, never wrong);
  * **LIMIT** runs on the host over the filter stage's FULL partitions
    and launches nothing;
  * **JOIN** (``join_hit_batch`` / ``bloom_hit_batch``): build sides are
    summarized on the host; probe-side matching is one
    ``join_overlap_batched`` launch per (probe table, key column) group
    of distinct summaries against the resident join-key plane, and one
    ``bloom_probe_batched`` launch per group of Bloom summaries against
    the resident enumeration plane;
  * **top-k** (``topk_init_batch``): the Sec. 5.4 upfront boundaries of a
    (table, order column, direction) group come from one
    ``topk_init_batched`` launch over the resident block-top-k plane; the
    boundary scan itself stays on the host (it fetches rows).

Device: the service runs on the GPU (``device=None``) unless the caller
asks for ``device="cpu"``; without a card it raises.  On the GPU every
kernel library is built and loaded when the service is constructed,
outside any ladder rung, so a build failure raises here instead of
demoting every launch to the host.

Counters: ``ServiceCounters`` tracks launches and host fallbacks both in
aggregate and per technique (``counters.technique``).  A launch is one
batched kernel launch (off the card, one call of the kernel's plain
version); ``tree_launches`` counts the evaluations that ran a tree rung,
whether or not they launched a kernel (the filter's group pre-pass and
gathered leaves are plain torch and count there alone).  ``run_batch``
attaches a snapshot to every report (``PruningReport.counters``) so a run
can show which rung served each stage.

Verdict cache (``verdict_cache=True``, the default): a table group's
filter jobs are deduped by canonical predicate before any launch, and the
``verdict`` rung on top of the filter chain serves resident verdict rows
(``DeviceStatsCache.verdict_plane``), launching the ordinary chain only
for the predicates it misses; a predicate earns a resident row on its
second sighting (``_verdict_group``).  The rows are repaired on the
table's appends and drops (into a copy that is swapped in).

Fleet scale: ``budget_bytes`` puts every resident plane family under one
device-memory budget (``core.device_stats.PlaneMemoryManager``: LRU
eviction, in-flight pinning around each launch, counters in
``counters["memory"]``); ``cache=`` shares one ``DeviceStatsCache``
between services, and ``shard_mesh`` partition-shards every batched
launch over a plane mesh (``launch.mesh.make_plane_mesh``: the
``sharded`` and ``sharded_tree`` rungs, ``counters.sharded_launches``).
``run_fleet`` drives a many-table workload and ``fleet_summary`` reports
the budget-sizing view.  ``prestage`` is the async front-end's staging
seam (``serve.frontend.ServingFrontend``).

Tree rungs: with ``tree_fanout`` given, for a table of at least
``tree_fanout * TREE_MIN_GROUPS`` partitions every stage enters at the
``tree`` rung, which prunes whole groups of partitions on the resident
tree planes before evaluating what survives (``kops.*_batched_tree``),
bit-identical to the flat ``device`` rung it demotes to on a tree-plane
fault.  Without it every table takes the flat rungs: the tree rung is
opt-in because its dense fallback is priced over capacity groups and
does not fire on a large table's unselective groups, where the pre-pass
costs more than it saves.

DML: mutations made through the Table's own methods
(``append_partitions`` / ``drop_partitions`` / ``rewrite_partitions`` /
``update_column``) log ``TableDelta``s, and the resident planes
*delta-sync* on the next batch — appends stage O(ΔP), drops scatter
sentinels, nothing is invalidated (``notify_append/drop/rewrite`` keep
the ``TableVersion`` bookkeeping aligned).  The legacy ``notify_insert /
notify_delete / notify_update`` path bumps the version and invalidates
outright, forcing a full restage.  Per-batch staging work and the
``PlaneEpoch`` each table's launches ran against are attached to every
report (``counters["staging"]`` / ``counters["planes"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..core import expr as E
from ..core.device_stats import (TREE_MIN_GROUPS, DeviceStatsCache,
                                 PlaneEpoch, PlaneMemoryManager,
                                 resolve_device)
from ..core.metadata import (FULL_MATCH, NO_MATCH, PARTIAL_MATCH, ScanSet,
                             live_full_scan, mask_dead_partitions)
from ..core.predicate_cache import TableVersion
from ..core.prune_filter import eval_tv, extract_ranges
from ..core.prune_join import (DEFAULT_ENUM_LIMIT, BuildSummary,
                               summarize_build)
from ..kernels import ops as kops
from ..kernels.build import KernelError
# Boundary-init k cap: the kernel sorts the values above its threshold of
# at most k - 1 rows in shared memory.  Larger k also gains little from
# the plane (each partition contributes at most KPLANE=64 witnessed
# rows); such queries keep the host-only init.
from ..kernels.topk_boundary import MAX_K as TOPK_INIT_MAX_K
from .resilience import (DegradationLadder, new_latency_counters,
                         new_resilience_counters, resilience_delta,
                         resilience_snapshot)

# Build sides of at least this many keys are summarised on the card by
# ``join_summary_batch``; smaller ones keep the host's ``summarize_build``.
# The crossover, measured on an H100 (PERF.md §6, the summary's sweep): the
# card path costs 0.35-0.6 ms a call at any size up to 65,536 keys (the
# launch and its two round trips), numpy under 0.1 ms up to the default
# 4,096-key distinct limit (``np.unique`` alone) and 1.3 ms or more from
# 6,144 keys, where its summaries turn to Bloom filters.
CARD_SUMMARY_MIN_KEYS = 8192

# Registered DegradationLadder launch sites: the only methods allowed to
# call ``kops.*_batched_*`` entrypoints (the tree forms included).  Each
# builds a rung list that is executed exclusively through
# ``self.ladder.execute``.
LADDER_LAUNCH_SITES = frozenset({
    "PruningService._filter_rungs",
    "PruningService._verdict_group",
    "PruningService.join_hit_batch",
    "PruningService.bloom_hit_batch",
    "PruningService.join_summary_batch",
    "PruningService.topk_init_batch",
    # the async front-end's dispatch (serve/frontend.py): every launch it
    # triggers goes through run_batch, whose stages execute only through
    # the rung builders above
    "ServingFrontend._execute",
})


@dataclasses.dataclass
class ServiceCounters:
    queries: int = 0
    scans: int = 0
    launches: int = 0          # batched kernel launches, all techniques
    host_fallbacks: int = 0    # host fallbacks, all techniques
    sharded_launches: int = 0  # launches that ran partition-sharded
    tree_launches: int = 0     # evaluations that ran a tree rung
    # per-technique attribution: {'filter': {'launches': n, 'fallbacks': m}}
    technique: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # build-side summaries routed to the card (``join_summary_batch``):
    # made there ('device'), or sent to the host by the ladder ('host');
    # summaries, not launches, so they stay out of ``launches``
    join_summary: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(device=0, host=0))

    def bump(self, tech: str, launches: int = 0, fallbacks: int = 0,
             sharded: int = 0, tree: int = 0) -> None:
        t = self.technique.setdefault(tech, dict(launches=0, fallbacks=0))
        t["launches"] += launches
        t["fallbacks"] += fallbacks
        self.launches += launches
        self.host_fallbacks += fallbacks
        self.sharded_launches += sharded
        self.tree_launches += tree

    def snapshot(self) -> dict:
        return dict(queries=self.queries, scans=self.scans,
                    launches=self.launches,
                    host_fallbacks=self.host_fallbacks,
                    sharded_launches=self.sharded_launches,
                    tree_launches=self.tree_launches,
                    technique={k: dict(v) for k, v in self.technique.items()},
                    join_summary=dict(self.join_summary))

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """after - before of two snapshots: the activity in between."""
        out = {k: after[k] - before[k]
               for k in ("queries", "scans", "launches", "host_fallbacks",
                         "sharded_launches", "tree_launches")}
        zero = dict(launches=0, fallbacks=0)
        out["technique"] = {
            t: {f: v - before["technique"].get(t, zero)[f]
                for f, v in fields.items()}
            for t, fields in after["technique"].items()}
        out["join_summary"] = {k: v - before["join_summary"][k]
                               for k, v in after["join_summary"].items()}
        return out


class PruningService:
    # bound on the memo of clean (stats, predicate) validations, and the
    # doorkeeper bound: past this many distinct (table, predicate) keys
    # the seen-set resets rather than grow without bound
    VALIDATED_CAP = 1 << 17
    VERDICT_SEEN_CAP = 1 << 17

    def __init__(
        self,
        mode: str = "auto",            # kernel mode: auto|cuda|torch
        device=None,                   # None: the GPU (raises without
                                       # one); 'cpu': the plain path
        cache: Optional[DeviceStatsCache] = None,  # a cache shared with
                                       # other services (on this device)
        budget_bytes: Optional[int] = None,  # device-memory budget for the
                                             # resident planes (None:
                                             # unbounded)
        shard_mesh=None,               # plane mesh (True: build
                                       # make_plane_mesh()) — partition-
                                       # shards every batched launch
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
        tree_fanout: Optional[int] = None,  # tree-plane group size; None
                                       # keeps every table on the flat
                                       # rungs (tests shrink it so small
                                       # tables take the tree rungs)
        verdict_cache: bool = True,    # resident verdict rows: dedupe
                                       # canonical predicates per batch and
                                       # serve repeats without a launch
    ):
        dev = resolve_device(device)
        kops.check_mode(mode, dev)
        self.mode = mode
        self.device = dev
        self.tree_fanout = tree_fanout
        if cache is None:
            cache = DeviceStatsCache(
                budget_bytes=budget_bytes, fault_injector=fault_injector,
                device=dev,
                **({} if integrity_sample is None
                   else dict(integrity_sample=integrity_sample)),
                **({} if tree_fanout is None
                   else dict(tree_fanout=tree_fanout)))
        else:
            if not kops.same_device(cache.device, dev):
                raise ValueError(f"cache holds its planes on {cache.device}, "
                                 f"the service runs on {dev}")
            if tree_fanout is not None and cache.tree_fanout != tree_fanout:
                # safe on a shared cache: the tree getter's geometry check
                # rebuilds any entry staged under the old fanout
                cache.tree_fanout = int(tree_fanout)
            # adopt the chaos / integrity configuration onto a shared cache
            # only where it has none of its own (as for the budget)
            if fault_injector is not None and cache.fault_injector is None:
                cache.fault_injector = fault_injector
            if integrity_sample is not None:
                cache.integrity_sample = int(integrity_sample)
            if budget_bytes is not None:
                # a shared cache's budget belongs to whoever set it: only
                # adopt ours when none is set — silently re-budgeting a
                # cache other services share would evict planes they sized
                # their budget for
                if cache.memory.budget_bytes is None:
                    cache.memory.budget_bytes = budget_bytes
                elif cache.memory.budget_bytes != budget_bytes:
                    raise ValueError(
                        f"cache already budgeted at "
                        f"{cache.memory.budget_bytes} bytes; refusing to "
                        f"re-budget to {budget_bytes}")
        self.cache = cache
        if shard_mesh is True:
            from ..launch.mesh import make_plane_mesh
            shard_mesh = (make_plane_mesh() if dev.type == "cuda"
                          else make_plane_mesh([dev]))
        if shard_mesh is not None:
            shard_mesh = tuple(shard_mesh)
            if any(d.type != dev.type for d in shard_mesh):
                raise ValueError(f"shard mesh {shard_mesh} is not on the "
                                 f"service's device type ({dev.type})")
        self.shard_mesh = shard_mesh
        # service-side table versions (register / notify_*), handed to the
        # stat-plane getter so a legacy notify forces a restage
        self.versions: Dict[str, TableVersion] = {}
        if dev.type == "cuda":
            # build + bind the kernels now: a build failure must raise
            # here, not inside a ladder rung that would demote past it
            kops.load_kernels()
        self.counters = ServiceCounters()
        self.fault_injector = (fault_injector if fault_injector is not None
                               else cache.fault_injector)
        self.verdict_cache = bool(verdict_cache)
        # doorkeeper of seen-once verdict admission (_verdict_group)
        self._verdict_seen: set = set()
        # (stats uid, pred repr) pairs that validated clean (_validate_query)
        self._validated: set = set()
        # The resilience layer: every batched launch executes through the
        # degradation ladder (verdict -> sharded tree -> tree -> sharded ->
        # device -> host kernel -> host oracle -> passthrough; the verdict
        # rung only with the verdict cache on, the sharded rungs only with
        # a mesh, the tree rungs only for tables large enough to carry a
        # group plane), so an injected fault, a torn plane, or a deadline
        # costs pruning quality, never correctness and never an exception
        # out of run_batch; a KernelError is let through, never demoted.
        # Demotions and retries surface per batch under
        # ``PruningReport.counters["resilience"]``.
        self.resilience = new_resilience_counters()
        # service-lifetime latency / SLO block, written by the async
        # front-end and surfaced through fleet_summary()["latency"]; all
        # zero for synchronous use
        self.latency = new_latency_counters()
        self.ladder = DegradationLadder(
            policy=backoff, deadline_s=deadline_s, clock=clock, sleep=sleep,
            counters=self.resilience)

    def _fire(self, site: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector.fire(site)

    @staticmethod
    def _sharded() -> int:
        """1 when the launch that just returned ran sharded (a wrapper can
        demote a mesh-eligible launch to unsharded: the counter reports
        what ran)."""
        return 1 if kops.last_launch_shards() > 1 else 0

    # -- DML bookkeeping ----------------------------------------------------

    def register(self, table) -> TableVersion:
        tv = self.versions.get(table.name)
        if tv is None:
            tv = TableVersion(table.num_partitions)
            self.versions[table.name] = tv
        return tv

    # Legacy DML notifications (the mutation did not go through the
    # table's own DML methods, so there is no delta log): the version
    # bumps and the planes are invalidated, forcing a full restage.

    def notify_insert(self, table_name: str, n_partitions: int) -> None:
        self.notify_append(table_name, n_partitions)
        self.cache.on_insert(table_name)

    def notify_delete(self, table_name: str) -> None:
        self.notify_drop(table_name)
        self.cache.on_delete(table_name)

    def notify_update(self, table_name: str, column: str) -> None:
        self.notify_drop(table_name)
        self.cache.on_update(table_name, column)

    # Streaming DML (the table's own append_partitions / drop_partitions /
    # rewrite_partitions / update_column logged it): the cache replays the
    # delta log into the resident planes, so nothing is invalidated here —
    # only the TableVersion bookkeeping advances.

    def notify_append(self, table_name: str, n_partitions: int) -> None:
        tv = self.versions.get(table_name)
        if tv is not None:
            tv.insert_partitions(n_partitions)

    def notify_drop(self, table_name: str) -> None:
        tv = self.versions.get(table_name)
        if tv is not None:
            tv.version += 1

    notify_rewrite = notify_drop

    def plane_epoch(self, table) -> Optional[PlaneEpoch]:
        """(version, live count, capacity) of the table's resident plane."""
        return self.cache.plane_epoch(table)

    def _stat_plane(self, table):
        """The table's stat entry, frozen: a launch reads one set of
        planes and the tree plane built from them, even when another
        thread's replay swaps new planes into the resident entry."""
        return dataclasses.replace(
            self.cache.get(table, self.versions.get(table.name)))

    def prestage(self, queries: Sequence) -> int:
        """Prefetch the stat planes a batch of queries will read: the
        front-end's staging seam, run before the batch's launches (a
        delta replay swaps new planes in, so a launch already running
        keeps the planes it got).

        A ``pin_scope`` around the prefetches keeps the memory manager
        from evicting a plane this very call just staged while admitting
        the next table under the budget.  Advisory and never raises;
        returns the number of planes that staged bytes (also counted in
        ``staging_snapshot()["prefetch_stages"]``).
        """
        staged = 0
        seen: set = set()
        with self.cache.pin_scope():
            for q in queries:
                for spec in q.scans.values():
                    if id(spec.table) in seen:
                        continue
                    seen.add(id(spec.table))
                    if self.cache.prefetch(spec.table,
                                           self.versions.get(spec.table.name)):
                        staged += 1
        return staged

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

    def _tree_eligible(self, table) -> bool:
        """Should this table's launches enter at the tree rung?  Never
        without a ``tree_fanout``; below ``tree_fanout * TREE_MIN_GROUPS``
        partitions the flat launch wins (and no tree plane is staged for
        the table)."""
        return (self.tree_fanout is not None
                and table.stats.num_partitions
                >= self.tree_fanout * TREE_MIN_GROUPS)

    def _device_rungs(self, tech: str, launch_fn, table) -> list:
        """The device rungs of a ladder chain: the tree rungs first when
        the table is large enough to carry a resident group plane (the
        sharded one only with a mesh), then the flat sharded / unsharded
        rungs.  ``launch_fn(mesh, site, tree)`` builds the thunk; a
        tree-plane fault (staging failure, torn plane) demotes to the
        flat rungs, which never consult the tree family."""
        rungs = []
        mesh = self.shard_mesh
        if self._tree_eligible(table):
            if mesh is not None:
                rungs.append(("sharded_tree", launch_fn(
                    mesh, f"launch.{tech}:sharded_tree", True)))
            rungs.append(("tree",
                          launch_fn(None, f"launch.{tech}:tree", True)))
        if mesh is not None:
            rungs.append(("sharded", launch_fn(
                mesh, f"launch.{tech}:sharded", False)))
        rungs.append(("device",
                      launch_fn(None, f"launch.{tech}:device", False)))
        return rungs

    def _tree_entry(self, table):
        """The table's current tree plane (its stat plane synced first)."""
        return self.cache.tree_plane(table, self._stat_plane(table))

    def _filter_rungs(self, table, range_lists, preds) -> list:
        """The filter stage's full rung chain for one table group.

        Every rung returns the same contract: tv ``[Q, P]`` int8 rows
        (None from the passthrough rung — the caller keeps every live
        partition as PARTIAL).  The tree rung runs the group pre-pass,
        bit-identical by the hull argument of
        ``kops.prune_ranges_batched_tree``; the host kernel is exact f64
        over the same lowered ranges; the host oracle re-evaluates each
        predicate tree — both bit-identical to ``eval_tv`` for lowerable
        predicates, so stopping at any rung costs latency, not pruning
        quality.
        """
        def launch(mesh, site, tree):
            def thunk():
                self._fire(site)
                # Pin scope: the planes this launch reads must not be
                # evicted (by another table's staging under the budget)
                # while the launch is in flight.
                with self.cache.pin_scope():
                    dstats = self._stat_plane(table)
                    if tree:
                        tv = kops.prune_ranges_batched_tree(
                            range_lists, dstats,
                            self.cache.tree_plane(table, dstats), self.mode,
                            mesh=mesh)
                        # the gathered pre-pass launches no kernel; its
                        # flat fallbacks launch the batched one
                        gathered = kops.last_tree_stats()["path"] == "tree"
                    else:
                        tv = kops.prune_ranges_batched_device(
                            range_lists, dstats, self.mode, mesh=mesh)
                        gathered = False
                    self.counters.bump("filter", launches=int(not gathered),
                                       sharded=self._sharded(),
                                       tree=int(tree))
                return tv
            return thunk

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

        return self._device_rungs("filter", launch, table) + [
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
        # device rungs + host kernel; the terminal rung hands back None
        # so flow's _prune_scan runs its own eval_tv host path
        rungs = self._filter_rungs(spec.table, [ranges], [spec.pred])[:-2]
        rungs.append(("host_oracle", lambda: None))
        tv_rows, _rung = self.ladder.execute(rungs)
        if tv_rows is None:
            self.counters.bump("filter", fallbacks=1)
            return None
        return tv_rows[0]

    def _verdict_plan(self, table, jobs) -> tuple:
        """``_verdict_group``'s dedupe and admission, before any launch:
        (canonical key a job, unique key -> its index, unique ranges,
        unique predicates, admitted a unique key)."""
        ckeys = [E.canonical_key(pred) for _, _, _, pred in jobs]
        uniq: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        u_ranges: list = []
        u_preds: list = []
        for (_, _, ranges, pred), ck in zip(jobs, ckeys):
            counts[ck] = counts.get(ck, 0) + 1
            if ck not in uniq:
                uniq[ck] = len(u_preds)
                u_ranges.append(ranges)
                u_preds.append(pred)
        self.resilience["verdict_deduped"] += len(jobs) - len(u_preds)
        admit = [counts[ck] > 1 or (table.name, ck) in self._verdict_seen
                 for ck in uniq]
        if len(self._verdict_seen) > self.VERDICT_SEEN_CAP:
            self._verdict_seen.clear()      # doorkeeper reset
        self._verdict_seen.update((table.name, ck) for ck in uniq)
        return ckeys, uniq, u_ranges, u_preds, admit

    def _verdict_group(self, table, jobs, plan) -> list:
        """One table group's filter verdicts through the verdict cache.

        Jobs are deduped by canonical predicate key *before any launch*
        (``verdict_deduped`` counts the saved duplicates), then the
        unique predicates run through the ladder with the ``verdict``
        rung on top: it serves resident verdict rows (a full-hit batch
        launches no kernel), launches only the missing predicates through
        the ordinary ``_filter_rungs`` chain, and records the fresh
        verdicts.  A verdict-plane integrity failure fails the rung and
        the ladder demotes to the flat chain — cache-off is a demotion,
        never a wrong answer.  Returns one ``[P]`` int8 row (or None for
        passthrough) per job, duplicates sharing one row object.

        Admission is seen-once (a doorkeeper, as in TinyLFU): a predicate
        earns a resident row only on its *second* sighting — repetition
        within the batch counts — so repeated dashboard traffic is
        admitted on its first batch, while one-shot predicates never pay
        the record cost on top of their launch.

        ``plan`` is ``_verdict_plan(table, jobs)``: ``prune_batch`` makes
        every group's before the first launch, inside ``filter.plan``.
        """
        ckeys, uniq, u_ranges, u_preds, admit = plan
        u_keys = list(uniq)

        def verdict_rung():
            rows: list = [None] * len(u_keys)
            miss: list = []
            # Pin scope: served verdict rows stay resident while the
            # misses' launch reads the stat planes.
            with self.cache.pin_scope():
                for i, (ck, pred) in enumerate(zip(u_keys, u_preds)):
                    row = self.cache.verdict_plane(table, pred, ck)
                    if row is None:
                        miss.append(i)
                    else:
                        rows[i] = row
                self.resilience["verdict_hits"] += len(u_keys) - len(miss)
                self.resilience["verdict_misses"] += len(miss)
                if miss:
                    tv_rows, rung = self.ladder.execute(self._filter_rungs(
                        table, [u_ranges[i] for i in miss],
                        [u_preds[i] for i in miss]))
                    if tv_rows is not None:
                        for mi, tv in zip(miss, tv_rows):
                            row = np.asarray(tv, dtype=np.int8)
                            rows[mi] = row
                            if rung != "passthrough" and admit[mi]:
                                self.cache.verdict_record(
                                    table, u_preds[mi], u_keys[mi], row)
            return rows

        u_rows, _rung = self.ladder.execute(
            [("verdict", verdict_rung)]
            + self._filter_rungs(table, u_ranges, u_preds))
        u_rows = [None] * len(u_keys) if u_rows is None else list(u_rows)
        return [u_rows[uniq[ck]] for ck in ckeys]

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
        plans: Dict[int, tuple] = {}
        with tracing.span("filter.plan"):
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
                    groups.setdefault(id(spec.table),
                                      (spec.table, []))[1].append(
                        (qi, name, ranges, spec.pred))
            if self.verdict_cache:
                for tid, (table, jobs) in groups.items():
                    plans[tid] = self._verdict_plan(table, jobs)
        for tid, (table, jobs) in groups.items():
            if self.verdict_cache:
                rows = self._verdict_group(table, jobs, plans[tid])
            else:
                tv_rows, _rung = self.ladder.execute(self._filter_rungs(
                    table, [ranges for _, _, ranges, _ in jobs],
                    [pred for _, _, _, pred in jobs]))
                rows = ([None] * len(jobs) if tv_rows is None
                        else list(tv_rows))
            # deduped jobs share one row OBJECT: build the O(P) scan set
            # once per unique row and give each query its own ScanSet over
            # the shared (read-only) arrays
            memo: Dict[int, ScanSet] = {}
            with tracing.span("filter.decode"):
                for (qi, name, _ranges, _pred), tv in zip(jobs, rows):
                    if tv is None:
                        results[qi][name] = self._passthrough_set(table)
                        continue
                    ss = memo.get(id(tv))
                    if ss is None:
                        memo[id(tv)] = ss = self._scan_set(tv, table)
                    results[qi][name] = ScanSet(ss.part_ids, ss.match)
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

    # -- join stage ---------------------------------------------------------

    def join_device_eligible(self, summary: BuildSummary, table=None,
                             key_col: Optional[str] = None) -> bool:
        """Can this summary's probe-side matching run on the device plane?

        Distinct summaries need their keys finite in f32 (join-key plane
        overlap).  Bloom summaries need the probe table/key column: the
        kernel's narrow-range enumeration hashes *int32* candidates with
        the shared murmur mixer, so the key column must be an
        integer/dictionary domain wholly inside int32 — fractional or
        out-of-range keys keep the host matcher so batched output stays
        bit-identical to it — and the filter must fit the batched path's
        block cap (``kops.BLOOM_MAX_BLOCKS``).  The int32-domain check is
        the cached ``domain_ok`` of the enumeration plane, so eligibility
        never rescans [P] stats per query.  Empty summaries are host
        short-circuits, not kernel work.
        """
        if summary.empty:
            return False
        if summary.distinct is not None:
            d32 = np.asarray(summary.distinct,
                             dtype=np.float64).astype(np.float32)
            return bool(np.isfinite(d32).all())
        if summary.bloom is None or table is None or key_col is None:
            return False
        if summary.bloom.n_blocks > kops.BLOOM_MAX_BLOCKS:
            return False
        if table.stats.column(key_col).kind == "float":
            return False
        return self.cache.enum_plane(table, key_col)[3]

    def summary_on_card(self, keys: np.ndarray, stats,
                        key_col: str) -> bool:
        """Is this build side summarised on the card?  On a CUDA service,
        for at least ``CARD_SUMMARY_MIN_KEYS`` keys of an integer or
        dictionary column (``stats`` is the build table's metadata): the
        card dedupes and hashes them as int64, as the host's Bloom fold
        does, so encoded float keys also need the column's range inside
        int64.  Any other build side keeps the host's
        ``summarize_build``."""
        if self.device.type != "cuda" or keys.size < CARD_SUMMARY_MIN_KEYS:
            return False
        if keys.dtype.kind == "i":
            return True
        if keys.dtype.kind != "f" or stats.column(key_col).kind == "float":
            return False
        lo, hi = stats.col_min(key_col), stats.col_max(key_col)
        live = lo <= hi                    # all-null partitions: lo > hi
        return bool(not live.any() or (lo[live].min() >= -2.0 ** 63
                                       and hi[live].max() < 2.0 ** 63))

    def join_summary_batch(self, keys_list: Sequence[np.ndarray],
                           ndv_limit: int) -> List[BuildSummary]:
        """``summarize_build`` of each build side's keys, field for field,
        in one ``bloom_build`` launch (the plain version on a CPU service).
        A faulted device rung sends the build sides to the host's
        ``summarize_build``, the exact terminal rung."""
        def device():
            self._fire("launch.join_summary:device")
            out = kops.summarize_build_batched_device(
                keys_list, ndv_limit, device=self.device)
            self.counters.join_summary["device"] += len(keys_list)
            return out

        def host_oracle():
            self.counters.join_summary["host"] += len(keys_list)
            return [summarize_build(k, ndv_limit=ndv_limit)
                    for k in keys_list]

        out, _rung = self.ladder.execute([("device", device),
                                          ("host_oracle", host_oracle)])
        return out

    def join_hit_batch(self, table, key_col: str,
                       summaries: Sequence[BuildSummary],
                       part_ids: Optional[Sequence[np.ndarray]] = None
                       ) -> Optional[np.ndarray]:
        """hit [G, P] for a (table, key column) group — one launch.

        ``part_ids`` optionally restricts the plain version to each
        query's scan set (entries outside it are 0 and must not be read);
        the kernel always evaluates the resident plane dense.  Returns
        None when the ladder degraded past the device rungs — the
        caller's host matcher is this stage's exact terminal rung
        (``prune_probe`` recomputes the overlap from host truth, so a
        degraded join loses latency, never pruning quality).
        """
        def launch(mesh, site, tree):
            def thunk():
                self._fire(site)
                with self.cache.pin_scope():
                    pmin, pmax = self.cache.join_key_plane(table, key_col)
                    dist = [s.distinct for s in summaries]
                    P = table.stats.num_partitions
                    if tree:
                        hit = kops.join_overlap_batched_tree(
                            dist, pmin, pmax, P, self._tree_entry(table),
                            table.stats.col_id(key_col), self.mode,
                            part_ids_lists=part_ids, mesh=mesh)
                    else:
                        hit = kops.join_overlap_batched_device(
                            dist, pmin, pmax, P, self.mode,
                            part_ids_lists=part_ids, mesh=mesh)
                    self.counters.bump("join", launches=1,
                                       sharded=self._sharded(),
                                       tree=int(tree))
                return hit
            return thunk

        def host_oracle():
            self.counters.bump("join", fallbacks=len(summaries))
            return None

        hit, _rung = self.ladder.execute(
            self._device_rungs("join", launch, table)
            + [("host_oracle", host_oracle)])
        return hit

    def bloom_hit_batch(self, table, key_col: str,
                        summaries: Sequence[BuildSummary],
                        part_ids: Optional[Sequence[np.ndarray]] = None
                        ) -> Optional[np.ndarray]:
        """hit [G, P] for a (table, key column) group of Bloom summaries —
        one batched narrow-range enumeration launch over the resident
        enumeration plane (``part_ids`` restricts the plain version to
        each query's scan set, like ``join_hit_batch``).  None when the
        ladder degraded to the exact host matcher.  The enumeration limit
        is the host matcher's (``prune_probe``'s ``DEFAULT_ENUM_LIMIT``),
        so both give the same verdicts."""
        def launch(mesh, site, tree):
            def thunk():
                self._fire(site)
                with self.cache.pin_scope():
                    pmin, width, _wmax, _ok = self.cache.enum_plane(table,
                                                                    key_col)
                    blooms = [s.bloom for s in summaries]
                    P = table.stats.num_partitions
                    if tree:
                        hit = kops.bloom_probe_batched_tree(
                            blooms, pmin, width, DEFAULT_ENUM_LIMIT, P,
                            self._tree_entry(table), self.mode,
                            part_ids_lists=part_ids, mesh=mesh)
                    else:
                        hit = kops.bloom_probe_batched_device(
                            blooms, pmin, width, DEFAULT_ENUM_LIMIT, P,
                            self.mode, part_ids_lists=part_ids, mesh=mesh)
                    self.counters.bump("join_bloom", launches=1,
                                       sharded=self._sharded(),
                                       tree=int(tree))
                return hit
            return thunk

        def host_oracle():
            self.counters.bump("join_bloom", fallbacks=len(summaries))
            return None

        hit, _rung = self.ladder.execute(
            self._device_rungs("join_bloom", launch, table)
            + [("host_oracle", host_oracle)])
        return hit

    def join_hit(self, table, key_col: str, summary: BuildSummary,
                 part_ids: Optional[np.ndarray] = None
                 ) -> Optional[np.ndarray]:
        """hit [P] for one query, or None -> host path (counted per
        technique — ``join`` for distinct, ``join_bloom`` for Bloom —
        unless the summary is empty, which the host handles as a trivial
        wipe)."""
        if not self.join_device_eligible(summary, table, key_col):
            if not summary.empty:
                self.counters.bump(
                    "join_bloom" if summary.bloom is not None else "join",
                    fallbacks=1)
            return None
        pid = None if part_ids is None else [part_ids]
        if summary.distinct is not None:
            hit = self.join_hit_batch(table, key_col, [summary],
                                      part_ids=pid)
        else:
            hit = self.bloom_hit_batch(table, key_col, [summary],
                                       part_ids=pid)
        # None: the ladder degraded to the host matcher terminal rung
        return None if hit is None else hit[0]

    # -- top-k stage --------------------------------------------------------

    def topk_init_batch(self, table, order_col: str, desc: bool,
                        jobs: Sequence[Tuple[ScanSet, int]]) -> List[float]:
        """Per-query upfront boundaries for a (table, column, direction)
        group — one ``topk_init_batched`` launch.

        Each job is ``(scan_set, effective_k)``; the boundary is the k-th
        largest resident block-top-k value over the scan set's
        fully-matching partitions (signed domain), or -inf when fewer
        than k candidates exist.  Launch heaps are sized to the group's
        k bucket; a prefix of a larger heap is the exact smaller-k
        answer, so mixed-k groups share one launch.
        """
        # Jobs whose k is out of the useful range never consult the heap —
        # exclude them up front so they neither widen the group's k bucket
        # nor force a launch alone.
        live: List[Tuple[int, np.ndarray, int]] = []
        for i, (scan, k) in enumerate(jobs):
            if scan.match is None or not (0 < int(k) <= TOPK_INIT_MAX_K):
                continue
            live.append((i, scan.part_ids[scan.match == FULL_MATCH], int(k)))
        out = [-np.inf] * len(jobs)
        if not any(full.size for _, full, _ in live):
            return out                     # nothing to bound; skip the launch
        kb = kops.k_bucket(max(k for _, _, k in live))

        def launch(mesh, site, tree):
            def thunk():
                self._fire(site)
                with self.cache.pin_scope():
                    plane = self.cache.block_topk_plane(table, order_col,
                                                        desc)
                    lists = [full for _, full, _ in live]
                    if tree:
                        heap = kops.topk_init_batched_tree(
                            plane, lists, kb, self._tree_entry(table),
                            self.mode, mesh=mesh)
                    else:
                        heap = kops.topk_init_batched_device(
                            plane, lists, kb, self.mode, mesh=mesh)
                    self.counters.bump("topk", launches=1,
                                       sharded=self._sharded(),
                                       tree=int(tree))
                return heap
            return thunk

        def host_oracle():
            # -inf floors: run_topk's own boundary discovery takes over —
            # a weaker starting boundary, never a wrong result
            self.counters.bump("topk", fallbacks=1)
            return None

        heap, _rung = self.ladder.execute(
            self._device_rungs("topk", launch, table)
            + [("host_oracle", host_oracle)])
        if heap is None:
            return out
        for row, (i, _full, k) in enumerate(live):
            out[i] = float(heap[row, k - 1])
        return out

    def topk_init(self, table, scan: ScanSet, order_col: str, desc: bool,
                  k: int) -> float:
        """One query's upfront boundary from the resident plane (signed)."""
        if (scan.match is None or k <= 0 or k > TOPK_INIT_MAX_K
                or not (scan.match == FULL_MATCH).any()):
            return -np.inf
        return self.topk_init_batch(table, order_col, desc, [(scan, k)])[0]

    # -- workload entry points ----------------------------------------------

    def _validate_query(self, q) -> None:
        """Raise the spec's own error for a malformed query spec.

        Probes each scan's predicate against a one-partition stats slice
        (O(1) per scan, not O(P)) so unknown columns and bad literal
        dtypes surface *here*, at validation time — ``run_batch``
        isolates the raise to this query instead of letting it abort the
        batch mid-launch.  Join/order-by column names are checked the
        same way.  Clean probes are memoized per (stats identity,
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
        if q.join is not None:
            for scan_name, col in ((q.join.build, q.join.build_key),
                                   (q.join.probe, q.join.probe_key)):
                q.scans[scan_name].table.stats.col_id(col)
        if q.order_by is not None:
            scan_name, col, _desc = q.order_by
            q.scans[scan_name].table.stats.col_id(col)

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
        """Full pruning pipelines over a workload, every device-eligible
        stage batched per table group.

        Returns one ``PruningReport`` per query, identical to running
        ``pipeline.run(q)`` per query in the same mode.  Each report
        carries its own copy of THIS batch's counter delta (not the
        service-lifetime totals), including the resilience block
        (``counters["resilience"]``) and the plane-integrity block
        (``counters["integrity"]``).

        ``run_batch`` never raises for a query-shaped problem: malformed specs become no-prune
        passthrough reports (``errors`` counter); launch/staging/plane
        failures degrade through the ladder; an unexpected batch-level
        failure falls back to per-query execution
        (``salvaged_batches``).  A ``kernels.build.KernelError`` (the
        kernel failed to build, to take its inputs or to launch) is not
        such a problem and raises.
        """
        from ..core.flow import PruningPipeline
        if pipeline is None:
            pipeline = PruningPipeline(filter_mode="device", service=self)
        # Only batch device stages when the pipeline itself declares the
        # device path — a host or adaptive pipeline keeps its own
        # semantics (the adaptive tree is host f64: it launches nothing).
        device = not pipeline.adaptive and pipeline.filter_mode == "device"
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
        rids = None
        if tracing.on():
            # each query's rid: the front-end's request id where the
            # enclosing span lists the batch's, else its batch position
            given = tracing.lookup("rids")
            if given is None or len(given) != len(queries):
                given = range(len(queries))
            for st, (i, _q) in zip(states, valid):
                st.rid = given[i]
            rids = tuple(st.rid for st in states)
        try:
            for tech in pipeline.techniques:
                with tracing.span(f"stage.{tech.name}", rids=rids):
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
        """The fleet-scale entry point: a sequence of query batches over
        many tables driven through ``run_batch`` under the configured
        memory budget and shard mesh; one report list per batch (each
        batch's ``counters["memory"]`` shows the hits, misses, evictions
        and restage storms it paid for)."""
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
                    latency=dict(self.latency),
                    plane_hit_rate=(mem["hits"] / total) if total else 0.0)
