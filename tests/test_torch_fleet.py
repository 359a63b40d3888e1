"""Fleet scale in the port against the JAX package, on the same inputs.

* A ``cache=`` shared between services: adoption of the chaos, integrity
  and budget configuration, and the refusal to re-budget a budgeted one.
* The eviction invariants of ``tests/test_fleet_parity.py`` that
  ``test_torch_device_stats.py`` does not cover, each run on the port's
  ``PlaneMemoryManager`` / service and held to the reference's outcome.
* Partition-sharded launches over *logical* meshes (one device repeated,
  ``make_plane_mesh(["cpu"] * n)``) of 1, 2, 4 and 8 shards: each of the
  four batched wrappers and its tree form bit-identical to the unsharded
  port and to the reference's unsharded run, with drop sentinels on the
  shard edges and the logical P on one; whole services through
  ``run_batch``; ``sharded_launches``.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import device_stats as RD
from repro.core import expr as RE
from repro.core.device_stats import PlaneMemoryManager as RManager
from repro.core.flow import JoinSpec as RJoin
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.kernels import ops as rops
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import device_stats as TD
from repro_torch.core import expr as TE
from repro_torch.core.device_stats import PlaneMemoryManager as TManager
from repro_torch.core.flow import JoinSpec as TJoin
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_plane_mesh
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector

from test_fleet_parity import NDV_LIMIT, _rows, build_fleet
from test_torch_engine import _assert_reports_equal
from test_torch_ingest import _pair
from test_torch_tree import (FANOUT, P, _blooms, _enum_plane, _filter_cases,
                             _key_plane, _mask, _planes, _topk_plane)

torch.set_num_threads(1)

CPU = "cpu"
MESHES = [1, 2, 4, 8]
# P = 3000 at capacity 4096: drop sentinels on the edges of 2-, 4- and
# 8-way shards, the last live partition dropped too
EDGE_DROPPED = np.array([0, 511, 512, 1023, 1024, 1535, 1536, 2047, 2048,
                         2559, 2560, 2999])


def _mesh(n):
    return make_plane_mesh([CPU] * n)


# ---------------------------------------------------------------------------
# the fleet: the reference suite's tables and traffic in both packages
# ---------------------------------------------------------------------------

def _fleet(n_tables, seed, rows=48):
    """[(reference, port)] fact tables and the (reference, port) dim."""
    tables, dim = build_fleet(n_tables, seed, rows=rows)
    return [_pair(t) for t in tables], _pair(dim)


def _zipf(n, s=1.2):
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def _fleet_queries(tables, dim, rng, n, i):
    """The reference suite's skewed mix (``fleet_queries``) in package i
    (0: reference, 1: port); the same rng state gives the same traffic."""
    E, Query, Spec, Join = ((RE, RQuery, RSpec, RJoin) if i == 0
                            else (TE, TQuery, TSpec, TJoin))
    qs = []
    for _ in range(n):
        t = tables[int(rng.choice(len(tables), p=_zipf(len(tables))))][i]
        d = dim[i]
        lo = int(rng.integers(-100, 800))
        kind = int(rng.integers(0, 6))
        if kind == 0:
            qs.append(Query(scans={t.name: Spec(
                t, (E.col("v") >= lo) & (E.col("v") <= lo + 300))}))
        elif kind == 1:
            qs.append(Query(scans={t.name: Spec(
                t, E.Not(E.col("v") > lo) | (E.col("g") == 7))}))
        elif kind == 2:
            qs.append(Query(scans={t.name: Spec(t, E.col("v") >= lo)},
                            limit=int(rng.integers(1, 10))))
        elif kind == 3:
            qs.append(Query(scans={t.name: Spec(t, E.col("v") >= -150)},
                            limit=int(rng.integers(1, 6)),
                            order_by=(t.name, "v", bool(rng.integers(0, 2)))))
        elif kind == 4:
            a_lo = int(rng.integers(0, 85))
            qs.append(Query(
                scans={t.name: Spec(t),
                       "dim": Spec(d, (E.col("a") >= a_lo)
                                   & (E.col("a") <= a_lo + 8))},
                join=Join("dim", t.name, "k", "k")))
        else:
            qs.append(Query(
                scans={t.name: Spec(t, E.col("v") >= lo - 300),
                       "dim": Spec(d)},
                join=Join("dim", t.name, "k", "k")))
    return qs


def _warm_queries(tables, dim, i):
    """One query per technique per table: every plane family staged."""
    E, Query, Spec, Join = ((RE, RQuery, RSpec, RJoin) if i == 0
                            else (TE, TQuery, TSpec, TJoin))
    qs = []
    for pair in tables:
        t = pair[i]
        qs.append(Query(scans={t.name: Spec(
            t, (E.col("v") >= 0) & (E.col("v") <= 500))}))
        qs.append(Query(scans={t.name: Spec(t, E.col("v") >= -150)},
                        limit=3, order_by=(t.name, "v", True)))
        qs.append(Query(scans={t.name: Spec(t), "dim": Spec(dim[i])},
                        join=Join("dim", t.name, "k", "k")))
    return qs


def _traffic(tables, dim, seed, n):
    """(reference, port) query lists drawn from one seed."""
    return tuple(_fleet_queries(tables, dim, np.random.default_rng(seed), n,
                                i) for i in (0, 1))


def _run(svc, queries):
    pipe = (TPipeline if isinstance(svc, TService) else RPipeline)(
        filter_mode="device", service=svc, join_ndv_limit=NDV_LIMIT)
    return svc.run_batch(queries, pipe)


def _assert_all_equal(got, want):
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)


def _working_set(tables, dim):
    svc = TService(device=CPU)
    _run(svc, _warm_queries(tables, dim, 1))
    return svc.cache.resident_bytes


# ---------------------------------------------------------------------------
# a shared cache
# ---------------------------------------------------------------------------

def test_shared_cache_adopts_configuration_and_refuses_a_rebudget():
    (a,), _dim = _fleet(1, seed=1)
    first = TService(device=CPU)
    cache = first.cache
    inj = FaultInjector(seed=0)
    second = TService(device=CPU, cache=cache, budget_bytes=1 << 20,
                      fault_injector=inj, integrity_sample=1)
    assert second.cache is cache
    assert cache.memory.budget_bytes == 1 << 20          # adopted: had none
    assert cache.fault_injector is inj and second.fault_injector is inj
    assert cache.integrity_sample == 1
    # the same budget again is no re-budget
    TService(device=CPU, cache=cache, budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="re-budget"):
        TService(device=CPU, cache=cache, budget_bytes=1 << 21)
    assert cache.memory.budget_bytes == 1 << 20
    # a third service inherits the cache's injector, never replaces it
    third = TService(device=CPU, cache=cache,
                     fault_injector=FaultInjector(seed=1))
    assert cache.fault_injector is inj and third.fault_injector is not inj
    # the reference refuses the same re-budget
    rcache = RService(mode="ref", budget_bytes=1 << 20).cache
    with pytest.raises(ValueError, match="re-budget"):
        RService(mode="ref", cache=rcache, budget_bytes=1 << 21)
    # services sharing the cache share its planes: one stage, two hits
    q = [TQuery(scans={a[1].name: TSpec(a[1], TE.col("v") >= 0)})]
    _run(first, q)
    misses = cache.misses
    _run(second, q)
    assert cache.misses == misses


def test_shared_cache_on_another_device_is_refused():
    cache = TD.DeviceStatsCache(device=CPU)
    cache.device = torch.device("cuda", 0)      # as if staged on the card
    with pytest.raises(ValueError, match="cache holds its planes"):
        TService(device=CPU, cache=cache)


def test_shared_cache_tree_fanout_change_rebuilds_the_tree_plane():
    cache = TService(device=CPU, tree_fanout=8).cache
    svc = TService(device=CPU, cache=cache, tree_fanout=4)
    assert cache.tree_fanout == 4 and svc.tree_fanout == 4


# ---------------------------------------------------------------------------
# eviction invariants (tests/test_fleet_parity.py, TestEvictionInvariants)
# ---------------------------------------------------------------------------

def _manager_log(cls, script):
    """Run a manager script on a fresh manager of class ``cls``; the
    evictions it made and its counters."""
    mgr = cls(budget_bytes=100)
    evicted = []
    mgr.bind(lambda fam, key: evicted.append((fam, key)))
    script(mgr)
    return evicted, mgr.snapshot()


def _restage_storm(mgr):
    mgr.admit("stat", ("a",), 80)
    mgr.admit("stat", ("b",), 80)       # evicts a
    mgr.admit("stat", ("a",), 80)       # a returns: thrash


def _oversized(mgr):
    mgr.admit("stat", ("a",), 40)
    mgr.admit("stat", ("b",), 40)
    mgr.admit("stat", ("huge",), 150)   # over budget, no collateral flush
    mgr.reclaim()                       # the unfittable plane goes first


def _pin_debt(mgr):
    mgr.admit("stat", ("x",), 10)
    mgr.pin("stat", ("x",))             # scope A pins
    mgr.release("stat", ("x",))         # invalidate mid-scope
    mgr.admit("stat", ("x",), 10)       # scope B restages
    mgr.pin("stat", ("x",))             # and pins the fresh record
    mgr.unpin("stat", ("x",))           # scope A exits: consumes the debt


@pytest.mark.parametrize("script", [_restage_storm, _oversized, _pin_debt])
def test_manager_scripts_equal_reference(script):
    got = _manager_log(TManager, script)
    assert got == _manager_log(RManager, script)
    if script is _restage_storm:
        assert got[1]["restage_storms"] == 1
    if script is _oversized:
        assert got[0] == [("stat", ("huge",))]
        assert got[1]["over_budget_events"] == 1
        assert got[1]["pin_denied"] == 0
    if script is _pin_debt:
        mgr = TManager(budget_bytes=100)
        mgr.bind(lambda fam, key: None)
        _pin_debt(mgr)
        assert mgr._resident[("stat", ("x",))].pins == 1   # B's pin intact
        mgr.unpin("stat", ("x",))
        assert mgr._resident[("stat", ("x",))].pins == 0
        assert not mgr._orphan_pins


def test_unbudgeted_manager_never_evicts():
    mgr = TManager()
    mgr.bind(lambda fam, key: pytest.fail("evicted without a budget"))
    for i in range(50):
        mgr.admit("stat", (i,), 1 << 20)
    assert mgr.evictions == 0 and mgr.bytes_in_use == 50 << 20


def test_pinned_planes_survive_launch_pressure():
    """A plane taken inside a pin scope stays resident while the scope is
    open even when staging another table would evict it — and goes first
    once the scope closes (the cache off, so a repeat restages)."""
    tables, _dim = _fleet(2, seed=3)
    a, b = (t[1] for t in tables)
    svc = TService(device=CPU, verdict_cache=False)
    q = lambda t: [TQuery(scans={t.name: TSpec(  # noqa: E731
        t, (TE.col("v") >= 0) & (TE.col("v") <= 400))})]
    _run(svc, q(a))
    svc.cache.memory.budget_bytes = int(svc.cache.resident_bytes * 1.5)
    key_a = (a.name, a.stats.uid)
    with svc.cache.pin_scope():
        svc.cache.get(a)
        _run(svc, q(b))
        assert key_a in svc.cache.entries, "pinned plane evicted"
        assert svc.cache.memory.pin_denied >= 1
    _run(svc, q(b) + q(b))
    assert key_a not in svc.cache.entries
    assert svc.cache.memory.evictions >= 1
    assert svc.cache.memory.bytes_in_use == svc.cache.resident_bytes


def test_evicted_plane_restages_current_state_then_deltas():
    """An evicted plane comes back reflecting DML made while it was cold,
    and afterwards delta-replays its log again (equal to the reference
    and the host pipeline throughout)."""
    tables, _dim = _fleet(2, seed=7)
    a, b = tables
    rng = np.random.default_rng(7)
    svcs = (RService(mode="ref"), TService(device=CPU))

    def q(t, lo):
        E, Query, Spec = ((RE, RQuery, RSpec) if isinstance(t, type(a[0]))
                          else (TE, TQuery, TSpec))
        return [Query(scans={t.name: Spec(
            t, (E.col("v") >= lo) & (E.col("v") <= lo + 350))})]

    for i, svc in enumerate(svcs):
        _run(svc, q(a[i], 0))
        svc.cache.memory.budget_bytes = int(svc.cache.resident_bytes * 1.5)
        _run(svc, q(b[i], 0))                    # evicts a's planes
        assert (a[i].name, a[i].stats.uid) not in svc.cache.entries
    raw = _rows(rng, 8)
    for t in a:
        t.append_partitions(raw, rows_per_partition=4)
        t.drop_partitions([1])
    got, want = _run(svcs[1], q(a[1], 100)), _run(svcs[0], q(a[0], 100))
    _assert_all_equal(got, want)
    assert svcs[1].cache.memory.restage_storms >= 1
    svcs[1].cache.memory.budget_bytes = None
    _run(svcs[1], q(a[1], 100))
    for t in a:
        t.append_partitions(_rows(rng, 4), rows_per_partition=4)
    staging = _run(svcs[1], q(a[1], 100))[0].counters["staging"]
    assert staging["full_restages"] == 0 and staging["delta_stages"] >= 1


def test_nested_equal_pin_scopes_unwind_by_identity():
    (a,), _dim = _fleet(1, seed=4)
    cache = TService(device=CPU, budget_bytes=1 << 20).cache
    with cache.pin_scope():
        cache.get(a[1])
        with cache.pin_scope():
            cache.get(a[1])          # a frame equal to the outer one
        cache.get(a[1])              # must land in the OUTER frame
    assert cache.memory.pinned_bytes == 0
    key = (a[1].name, a[1].stats.uid)
    assert cache.memory._resident[("stat", key)].pins == 0


def test_flow_rejects_fleet_args_with_explicit_service():
    svc = TService(device=CPU)
    for kw in (dict(budget_bytes=1 << 20), dict(shard_planes=True)):
        with pytest.raises(ValueError):
            TPipeline(filter_mode="device", service=svc, **kw)


def test_budgeted_fleet_equals_unbudgeted_and_reference():
    """The acceptance cell at test size: 24 tables under 25% of their
    working set and a 4-shard logical mesh — reports bit-identical to the
    unbudgeted unsharded port, the reference and the host pipeline; the
    budget holds, evictions happen, counters surface in the reports."""
    tables, dim = _fleet(24, seed=11)
    budget = int(_working_set(tables, dim) * 0.25)
    budgeted = TService(device=CPU, budget_bytes=budget,
                        shard_mesh=_mesh(4))
    unbounded = TService(device=CPU)
    rsvc = RService(mode="ref")
    rbatches = [_warm_queries(tables, dim, 0)]
    tbatches = [_warm_queries(tables, dim, 1)]
    for s in range(2):
        r, t = _traffic(tables, dim, 5 + s, 12)
        rbatches.append(r)
        tbatches.append(t)
    pipe_b, pipe_u = (TPipeline(filter_mode="device", service=s,
                                join_ndv_limit=NDV_LIMIT)
                      for s in (budgeted, unbounded))
    got = budgeted.run_fleet(tbatches, pipe_b)
    free = unbounded.run_fleet(tbatches, pipe_u)
    want = rsvc.run_fleet(rbatches, RPipeline(
        filter_mode="device", service=rsvc, join_ndv_limit=NDV_LIMIT))
    host = RPipeline(join_ndv_limit=NDV_LIMIT)
    for rq, g, f, w in zip(rbatches, got, free, want):
        _assert_all_equal(g, f)
        _assert_all_equal(g, w)
        for gi, q in zip(g, rq):
            _assert_reports_equal(gi, host.run(q), topk_host=True)
    mem = budgeted.cache.memory
    assert mem.evictions > 0 and mem.peak_bytes <= budget
    assert mem.over_budget_events == 0 and mem.pin_denied == 0
    assert mem.bytes_in_use == budgeted.cache.resident_bytes
    last = got[-1][0].counters["memory"]
    assert last["budget_bytes"] == budget and last["bytes_in_use"] <= budget
    summary = budgeted.fleet_summary()
    assert summary["memory"]["evictions"] == mem.evictions
    assert 0.0 < summary["plane_hit_rate"] < 1.0
    assert budgeted.counters.sharded_launches > 0
    assert unbounded.counters.sharded_launches == 0


def test_getters_atomic_against_concurrent_invalidation():
    tables, _dim = _fleet(3, seed=13)
    ts = [t[1] for t in tables]
    cache = TService(device=CPU, budget_bytes=1 << 20).cache
    errors = []
    stop = threading.Event()

    def reader(t):
        try:
            while not stop.is_set():
                e = cache.get(t)
                assert e.mins.shape[0] == len(t.stats.columns)
                cache.join_key_plane(t, "k")
                cache.block_topk_plane(t, "v", True)
        except Exception as exc:        # pragma: no cover - regression
            errors.append(exc)

    def invalidator():
        try:
            for i in range(100):
                cache.on_update(ts[i % 3].name, "v")
                cache.invalidate(ts[(i + 1) % 3].name)
        except Exception as exc:        # pragma: no cover - regression
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=reader, args=(t,)) for t in ts]
    threads.append(threading.Thread(target=invalidator))
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert cache.memory.bytes_in_use == cache.resident_bytes
    assert cache.memory.pinned_bytes == 0


# ---------------------------------------------------------------------------
# the plane mesh
# ---------------------------------------------------------------------------

def test_make_plane_mesh(monkeypatch):
    assert make_plane_mesh([CPU] * 4) == (torch.device(CPU),) * 4
    with pytest.raises(ValueError):
        make_plane_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_plane_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for visible, n in ((1, 1), (3, 2), (4, 4), (7, 4), (8, 8)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda v=visible: v)
        assert make_plane_mesh() == tuple(torch.device("cuda", i)
                                          for i in range(n))


def test_mesh_shards_needs_a_divisor_of_the_capacity():
    assert tops.mesh_shards(None, 4096) == 1
    assert tops.mesh_shards(_mesh(1), 4096) == 1
    assert tops.mesh_shards(_mesh(8), 4096) == 8
    assert tops.mesh_shards(make_plane_mesh([CPU] * 3), 4096) == 1
    assert tops.mesh_shards(_mesh(8), 4) == 1


def test_service_mesh_on_the_cpu_is_one_device_and_unsharded():
    svc = TService(device=CPU, shard_mesh=True)
    assert svc.shard_mesh == (torch.device(CPU),)
    pipe = TPipeline(filter_mode="device", device=CPU, shard_planes=True)
    assert pipe.device_service().shard_mesh == (torch.device(CPU),)
    tables, dim = _fleet(2, seed=21)
    _rq, tq = _traffic(tables, dim, 0, 8)
    _run(svc, tq)
    assert svc.counters.launches > 0 and svc.counters.sharded_launches == 0
    with pytest.raises(ValueError, match="not on the service's device"):
        TService(device=CPU, shard_mesh=(torch.device("cuda", 0),))


def _same_defined(got, want, ids):
    """Equal everywhere, or (with part-id lists) at the listed entries."""
    if ids is None:
        np.testing.assert_array_equal(got, want)
        return
    for q, i in enumerate(ids):
        np.testing.assert_array_equal(got[q, i], want[q, i])


@pytest.mark.parametrize("n", MESHES)
def test_sharded_filter_equals_unsharded_and_reference(n):
    rd, td, mins, _ = _planes(seed=1, dropped=EDGE_DROPPED)
    for fanout in (FANOUT, 4):
        re, te = (RD.tree_entry_for(rd, fanout=fanout),
                  TD.tree_entry_for(td, fanout=fanout))
        for kind, lists in _filter_cases(mins):
            want = rops.prune_ranges_batched_device(lists, rd, mode="ref")
            flat = tops.prune_ranges_batched_device(lists, td)
            got = tops.prune_ranges_batched_device(lists, td, mesh=_mesh(n))
            assert tops.last_launch_shards() == n
            np.testing.assert_array_equal(got, flat)
            np.testing.assert_array_equal(got, want)
            tree = tops.prune_ranges_batched_tree(lists, td, te,
                                                  mesh=_mesh(n))
            # the gathered pre-pass runs unsharded; its flat fallback not
            assert tops.last_tree_stats()["path"] == kind
            assert tops.last_launch_shards() == (1 if kind == "tree" else n)
            np.testing.assert_array_equal(tree, want)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_join_equals_unsharded_and_reference(n):
    rd, td, mins, maxs = _planes(seed=3, dropped=EDGE_DROPPED)
    pmin, pmax = _key_plane(mins, maxs, 0, td.capacity)
    rng = np.random.default_rng(3)
    dist = [np.unique(rng.integers(a, a + 500, 6)).astype(np.float64)
            for a in (100, 40_000, 99_000)]
    dist.append(np.unique(rng.integers(0, 100_000, 400)).astype(np.float64))
    lists = [np.sort(rng.choice(P, 900, replace=False)) for _ in dist]
    tp, tx = torch.from_numpy(pmin), torch.from_numpy(pmax)
    te = TD.tree_entry_for(td, fanout=FANOUT)
    for ids in (None, lists):
        want = rops.join_overlap_batched_device(dist, pmin, pmax, mode="ref",
                                                part_ids_lists=ids)[:, :P]
        flat = tops.join_overlap_batched_device(dist, tp, tx, P,
                                                part_ids_lists=ids)
        got = tops.join_overlap_batched_device(dist, tp, tx, P,
                                               part_ids_lists=ids,
                                               mesh=_mesh(n))
        assert tops.last_launch_shards() == n
        assert got.shape == (len(dist), P)
        _same_defined(got, flat, ids)
        _same_defined(got, want, ids)
        tree = tops.join_overlap_batched_tree(dist, tp, tx, P, te, 0,
                                              part_ids_lists=ids,
                                              mesh=_mesh(n))
        _same_defined(tree, want, ids)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_bloom_equals_unsharded_and_reference(n):
    rd, td, mins, maxs = _planes(seed=4, dropped=EDGE_DROPPED)
    rng = np.random.default_rng(4)
    rblooms, tblooms = _blooms(rng, 64, [rng.integers(0, 500, 40)
                                         for _ in range(3)])
    ids = [np.sort(rng.choice(P, 1200, replace=False)) for _ in range(3)]
    pmin, width = _enum_plane(mins, maxs, td.capacity)
    tp, tw = torch.from_numpy(pmin), torch.from_numpy(width)
    te = TD.tree_entry_for(td, fanout=FANOUT)
    for pid in (None, ids):
        want = rops.bloom_probe_batched_device(
            rblooms, pmin, width, int(width.max()), 1024, mode="ref",
            part_ids_lists=pid)[:, :P]
        flat = tops.bloom_probe_batched_device(tblooms, tp, tw, 1024, P,
                                               part_ids_lists=pid)
        got = tops.bloom_probe_batched_device(tblooms, tp, tw, 1024, P,
                                              part_ids_lists=pid,
                                              mesh=_mesh(n))
        assert tops.last_launch_shards() == n
        _same_defined(got, flat, pid)
        _same_defined(got, want, pid)
        tree = tops.bloom_probe_batched_tree(tblooms, tp, tw, 1024, P, te,
                                             part_ids_lists=pid,
                                             mesh=_mesh(n))
        _same_defined(tree, want, pid)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_topk_equals_unsharded_and_reference(n):
    """Per-shard heaps merged by rank equal the unsharded heap: lists
    that cross every shard edge, sit in one shard, hold only dropped
    partitions, or are empty."""
    rd, td, _, _ = _planes(seed=5, dropped=EDGE_DROPPED)
    rng = np.random.default_rng(5)
    cap = td.capacity
    plane = _topk_plane(rng, cap)
    plane[EDGE_DROPPED] = -np.inf
    lists = [np.array([3, 4, 510, 511, 512, 513, 2047, 2048, 2998]),
             np.array([0, 511, 512]),                      # dropped only
             np.array([], dtype=np.int64),
             np.array([600, 601, 602]),                    # one shard
             np.sort(rng.choice(P, 2500, replace=False))]
    te = TD.tree_entry_for(td, fanout=FANOUT)
    tplane = torch.from_numpy(plane)
    for k in (1, 4, 16):
        want = rops.topk_init_batched_device(plane, _mask(lists, cap), k,
                                             mode="ref")
        flat = tops.topk_init_batched_device(tplane, lists, k)
        got = tops.topk_init_batched_device(tplane, lists, k, mesh=_mesh(n))
        assert tops.last_launch_shards() == n
        np.testing.assert_array_equal(got, flat)
        np.testing.assert_array_equal(got, want)
        assert got.view(np.int32).tobytes() == flat.view(np.int32).tobytes()
        tree = tops.topk_init_batched_tree(tplane, lists[:4], k, te,
                                           mesh=_mesh(n))
        np.testing.assert_array_equal(
            tree, rops.topk_init_batched_device(
                plane, _mask(lists[:4], cap), k, mode="ref"))


def test_logical_p_on_a_shard_edge():
    """P = 2048 at capacity 4096: with two shards the second holds only
    capacity tail and launches nothing; the rows still equal."""
    rd, td, mins, maxs = _planes(seed=6, n=2048, dropped=np.array([2047]))
    lists = [[(1, -500.0, 500.0)], [(2, 0.0, 250.0)]]
    want = rops.prune_ranges_batched_device(lists, rd, mode="ref")
    for n in (2, 4):
        assert tops.prune_ranges_batched_device(
            lists, td, mesh=_mesh(n)).shape == (2, 2048)
        np.testing.assert_array_equal(
            tops.prune_ranges_batched_device(lists, td, mesh=_mesh(n)), want)
    assert tops._shard_spans(4096, 2, 2048) == [(0, 2048, 2048),
                                                (2048, 4096, 0)]


def test_split_candidates_rebases_each_shard():
    offsets, ids = (torch.from_numpy(a) for a in tops.pack_candidates(
        [np.array([1, 9, 4, 15]), np.array([], dtype=np.int64),
         np.array([8, 7])]))
    (o0, i0), (o1, i1) = tops.split_candidates(offsets, ids, 16, 2)
    assert i0.dtype == i1.dtype == torch.int32
    np.testing.assert_array_equal(o0, [0, 2, 2, 3])
    np.testing.assert_array_equal(i0, [1, 4, 7])
    np.testing.assert_array_equal(o1, [0, 2, 2, 3])
    np.testing.assert_array_equal(i1, [1, 7, 0])


def test_shard_of_the_planes_is_a_view_never_a_copy(monkeypatch):
    """On the planes' own device a shard is a column block of the [C, cap]
    planes (their row stride kept) or a slice of the rows: no copy."""
    _rd, td, mins, _ = _planes(seed=1, dropped=EDGE_DROPPED)
    seen = []
    real = tops.minmax_prune_batched

    def spy(c, l, h, m, x, d, num_partitions=None):
        seen.append((m.data_ptr(), m.stride(0), num_partitions))
        return real(c, l, h, m, x, d, num_partitions=num_partitions)

    monkeypatch.setattr(tops, "minmax_prune_batched", spy)
    tops.prune_ranges_batched_device(_filter_cases(mins)[0][1], td,
                                     mesh=_mesh(4))
    base, cap = td.mins.data_ptr(), td.capacity
    assert [s[0] for s in seen] == [base + i * 1024 * 4 for i in range(4)]
    assert all(s[1] == cap for s in seen)
    assert [s[2] for s in seen] == [1024, 1024, 952, 0]


def test_shard_on_another_device_is_copied_once_per_plane_write():
    plane = torch.arange(16, dtype=torch.float32)
    meta = torch.device("meta")
    a = tops._shard_of(plane, 0, 4, 8, meta)
    assert a.device.type == "meta" and a.shape == (4,)
    assert tops._shard_of(plane, 0, 4, 8, meta) is a      # cached
    plane[5] = -1.0                                       # an in-place write
    b = tops._shard_of(plane, 0, 4, 8, meta)
    assert b is not a
    assert tops._shard_of(plane, 0, 8, 12, meta) is not b  # another shard
    view = tops._shard_of(plane, 0, 4, 8, torch.device(CPU))
    assert view.data_ptr() == plane.data_ptr() + 16


def test_slab_bound_demotes_a_sharded_plain_body(monkeypatch):
    """Off the card a sharded plain body over the slab bound runs
    unsharded, and the service counts what ran."""
    rd, td, mins, _ = _planes(seed=1)
    lists = _filter_cases(mins)[1][1]
    monkeypatch.setattr(tops, "_REF_SLAB_ELEMS", 1024)
    got = tops.prune_ranges_batched_device(lists, td, mesh=_mesh(4))
    assert tops.last_launch_shards() == 1
    np.testing.assert_array_equal(
        got, rops.prune_ranges_batched_device(lists, rd, mode="ref"))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("tree_fanout", [None, 4])
def test_sharded_service_equals_reference(n, tree_fanout):
    """Whole batches through a service with a logical mesh of n shards
    (and, with a fanout, the sharded tree rung) equal the reference's
    unsharded service; every flat launch counts as sharded.  The fact
    tables have 40 partitions: 10 groups of 4 (tree eligible)."""
    tables, dim = _fleet(3, seed=21, rows=160)
    rq, tq = _traffic(tables, dim, 0, 16)
    rq += _warm_queries(tables, dim, 0)
    tq += _warm_queries(tables, dim, 1)
    kw = {} if tree_fanout is None else dict(tree_fanout=tree_fanout)
    svc = TService(device=CPU, shard_mesh=_mesh(n), **kw)
    got = _run(svc, tq)
    _assert_all_equal(got, _run(RService(mode="ref", **kw), rq))
    _assert_all_equal(got, _run(TService(device=CPU, **kw), tq))
    c = got[0].counters
    assert not any(c["resilience"]["demotions"].values())
    if n == 1:
        assert svc.counters.sharded_launches == 0
    elif tree_fanout is None:
        assert c["sharded_launches"] == c["launches"] > 0
    else:
        assert c["tree_launches"] > 0 and c["sharded_launches"] > 0
