"""Incremental ingest of the PyTorch port against the JAX package.

Streaming DML (append / drop / rewrite / update) goes to a reference
``Table`` and to the port's copy of it with the same rows; after every
step the port's delta-replayed resident planes must be byte-equal to a
fresh stage of the same table state and to the reference's replayed
planes, family by family, and the port's reports equal the reference
service's (``mode="ref"``, verdict cache off) and a fresh port service's.
The counter tests pin the O(ΔP) staging claim against the reference's
own byte counts.  Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core.flow import JoinSpec as RJoin
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.data.table import Table as RTable
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import expr as TE
from repro_torch.core.device_stats import to_host
from repro_torch.core.flow import JoinSpec as TJoin
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.data.table import Table as TTable
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector

from test_torch_engine import _assert_reports_equal

torch.set_num_threads(1)

NDV_LIMIT = 12     # straddled by build sides: small -> distinct, big -> Bloom
STR_DOMAIN = ["Bear", "Duck", "Eagle", "Frog", "Pike", "Wolf"]
TREE_FANOUT = 8    # the tree tests' fact table has 40+ partitions


def _rows(rng, n):
    return {
        "k": rng.integers(0, 60, n).astype(np.int64),
        "v": rng.integers(-200, 1000, n).astype(np.int64),
        "g": rng.integers(0, 50, n).astype(np.int64),
        "s": np.array([STR_DOMAIN[i]
                       for i in rng.integers(0, len(STR_DOMAIN), n)]),
    }


def _pair(t):
    return t, TTable.from_arrays(t.name, t.columns, t.data, t.nulls,
                                 t.part_bounds)


def _base_tables(seed, n=110):
    """(fact, dim) pairs of (reference, port) tables."""
    rng = np.random.default_rng(seed)
    fact = RTable.build("f", _rows(rng, n), rows_per_partition=10,
                        nulls={"v": rng.random(n) < 0.1})
    dim = RTable.build("d", {
        "a": rng.integers(0, 100, 40).astype(np.int64),
        "k": rng.integers(0, 60, 40).astype(np.int64),
    }, rows_per_partition=8)
    return _pair(fact), _pair(dim)


def _queries(fact, dim, lits, E, Query, Spec, Join):
    """One query per technique family (the reference suite's set)."""
    lo, a_lo, lim, k, desc = lits
    return [
        Query(scans={"f": Spec(fact, (E.col("v") >= lo)
                               & (E.col("v") <= lo + 300))}),
        Query(scans={"f": Spec(fact, E.Not(E.col("v") > lo)
                               | (E.col("g") == 7))}),
        Query(scans={"f": Spec(fact)}),
        Query(scans={"f": Spec(fact, E.col("v") >= lo)}, limit=lim),
        Query(scans={"f": Spec(fact, E.col("v") >= -150)}, limit=k,
              order_by=("f", "v", desc)),
        Query(scans={"f": Spec(fact),
                     "d": Spec(dim, (E.col("a") >= a_lo)
                               & (E.col("a") <= a_lo + 10))},
              join=Join("d", "f", "k", "k")),
        Query(scans={"f": Spec(fact, E.col("v") >= lo - 200),
                     "d": Spec(dim)},
              join=Join("d", "f", "k", "k")),
    ]


def _both_queries(fact, dim, rng):
    lits = (int(rng.integers(-100, 800)), int(rng.integers(0, 80)),
            int(rng.integers(1, 12)), int(rng.integers(1, 8)),
            bool(rng.integers(0, 2)))
    return (_queries(fact[0], dim[0], lits, RE, RQuery, RSpec, RJoin),
            _queries(fact[1], dim[1], lits, TE, TQuery, TSpec, TJoin))


def _apply(fact, op, rng):
    """Apply one DML step to the reference and the port table alike."""
    kind = op[0]
    tables = fact
    if kind == "append":
        n, parts = op[1], op[2]
        raw, nulls = _rows(rng, n), {"v": rng.random(n) < 0.1}
        for t in tables:
            t.append_partitions(
                raw, nulls=nulls,
                rows_per_partition=None if parts == 1 else max(1, n // parts))
    elif kind == "drop":
        live = np.where(fact[0].live_mask)[0]
        if live.size > 2:
            ids = rng.choice(live, size=min(2, live.size - 2), replace=False)
            for t in tables:
                t.drop_partitions(ids)
    elif kind == "rewrite":
        live = np.where(fact[0].live_mask)[0]
        pid = int(live[rng.integers(0, live.size)])
        n = int(np.diff(fact[0].part_bounds)[pid])
        raw, nulls = _rows(rng, n), {"v": rng.random(n) < 0.1}
        for t in tables:
            t.rewrite_partitions([pid], raw, nulls=nulls)
    elif kind == "update":
        vals = rng.integers(-300, 1100, fact[0].num_rows).astype(np.int64)
        for t in tables:
            t.update_column(op[1], vals)


def _program(seed):
    """A DML program of 1-5 steps, as the reference suite draws them."""
    rng = np.random.default_rng(1000 + seed)
    steps = []
    for _ in range(int(rng.integers(1, 6))):
        kind = rng.integers(0, 5)
        steps.append([("append", int(rng.integers(5, 36)), 1),
                      ("append", int(rng.integers(8, 31)), 3),
                      ("drop",), ("rewrite",),
                      ("update", str(rng.choice(["v", "g"])))][kind])
    return steps


def _rservice(**kw):
    return RService(mode="ref", verdict_cache=False, **kw)


def _strip(family, key):
    """A store key without the table's uid (and the reference top-k key's
    plane width), so both packages' entries line up."""
    k = (key[0],) + tuple(key[2:])
    return k[:3] if family == "block_topk" else k


# the partition (or group) axis of each family's arrays
PART_AXIS = {"stat": 1, "join_key": 0, "enum": 0, "block_topk": 0,
             "tree_stat": 1}


def _arrays(family, e):
    return e.planes if family == "stat" else e.arrays


def _resident(cache):
    return {(fam, _strip(fam, k)): e for fam, store in cache._stores.items()
            for k, e in store.items()}


def _assert_planes_equal(got_cache, want_cache, label):
    """Every plane resident in ``want_cache`` is resident in ``got_cache``
    and, where both reflect the same table version, byte-equal to it (a
    plane no query read since the last DML replays on its next read)."""
    got = _resident(got_cache)
    compared = 0
    for (fam, key), w in _resident(want_cache).items():
        e = got.get((fam, key))
        assert e is not None, f"{label}: {fam} {key} not resident"
        if e.version != w.version:
            continue
        for i, (a, b) in enumerate(zip(_arrays(fam, e), _arrays(fam, w))):
            a, b = to_host(a), np.asarray(b)
            assert a.dtype == b.dtype, f"{label}: {fam} {key}"
            if a.shape != b.shape:
                # a replayed plane keeps its capacity while P fits, where
                # a fresh stage sizes it anew: the logical partitions
                # (and groups) lie in the common prefix; the coarse level
                # of another capacity has another geometry
                if fam == "tree_stat" and i >= 3:
                    continue
                axis = PART_AXIS[fam]
                n = min(a.shape[axis], b.shape[axis])
                a, b = (np.take(x, np.arange(n), axis=axis) for x in (a, b))
            assert a.shape == b.shape, f"{label}: {fam} {key}"
            assert a.tobytes() == b.tobytes(), f"{label}: {fam} {key} bytes"
        if fam == "enum":
            assert (e.meta["wmax"], e.meta["domain_ok"]) == \
                (w.meta["wmax"], w.meta["domain_ok"]), label
        compared += 1
    assert compared, f"{label}: no plane compared"


def _run(svc, queries, **pipe_kw):
    pipe_cls = TPipeline if isinstance(svc, TService) else RPipeline
    return svc.run_batch(queries, pipe_cls(filter_mode="device", service=svc,
                                           join_ndv_limit=NDV_LIMIT,
                                           **pipe_kw))


def _dml_parity(seed, tree_fanout=None, n=110):
    rng = np.random.default_rng(seed)
    fact, dim = _base_tables(seed, n=n)
    kw = {} if tree_fanout is None else dict(tree_fanout=tree_fanout)
    tsvc = TService(device="cpu", **kw)
    rsvc = _rservice(**kw)
    for step, op in enumerate([("noop",)] + _program(seed)):
        if op[0] != "noop":
            _apply(fact, op, rng)
        rq, tq = _both_queries(fact, dim, rng)
        label = f"seed {seed} step {step} ({op[0]})"
        got = _run(tsvc, tq)
        want = _run(rsvc, rq)
        fresh_svc = TService(device="cpu", **kw)
        fresh = _run(fresh_svc, tq)
        for g, w, f in zip(got, want, fresh):
            _assert_reports_equal(g, w)
            _assert_reports_equal(g, f)
        _assert_planes_equal(tsvc.cache, fresh_svc.cache, f"{label} fresh")
        _assert_planes_equal(tsvc.cache, rsvc.cache, f"{label} reference")
    return tsvc


@pytest.mark.parametrize("seed", range(6))
def test_dml_program_replays_equal_fresh_stage_and_reference(seed):
    """After every step of a DML program every resident family is
    byte-equal to a fresh stage and to the reference's replayed plane,
    and the reports equal the reference's and a fresh service's."""
    _dml_parity(seed)


@pytest.mark.parametrize("seed", range(3))
def test_tree_dml_program_replays_equal_fresh_stage_and_reference(seed):
    """The same through the tree rung: the fact table (44+ partitions,
    fanout 8) carries a tree plane that replays with the flat planes."""
    svc = _dml_parity(seed, tree_fanout=TREE_FANOUT, n=440)
    assert svc.cache.tree_planes
    assert svc.counters.tree_launches > 0


def _resident_pair(n=240, seed=0, rows_per_partition=10, tree_fanout=None):
    """Both services with the flat (and, with a fanout, tree) planes of a
    fact table staged by one filter and one top-k query."""
    rng = np.random.default_rng(seed)
    fact = _pair(RTable.build("f", _rows(rng, n),
                              rows_per_partition=rows_per_partition))
    kw = {} if tree_fanout is None else dict(tree_fanout=tree_fanout)
    tsvc = TService(device="cpu", verdict_cache=False, **kw)
    rsvc = _rservice(**kw)

    def queries(i, E, Query, Spec):
        return [Query(scans={"f": Spec(fact[i], E.col("v") >= 0)}),
                # every partition FULL: the top-k init reads its plane
                Query(scans={"f": Spec(fact[i], E.col("v") >= -200)},
                      limit=5, order_by=("f", "v", True))]

    rq, tq = queries(0, RE, RQuery, RSpec), queries(1, TE, TQuery, TSpec)
    _run(rsvc, rq)
    _run(tsvc, tq)
    return fact, tsvc, rsvc, tq, rq, rng


def _staging(svc, queries):
    return _run(svc, queries)[0].counters["staging"]


def test_append_stages_the_reference_byte_count():
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair()
    C, P = len(fact[1].columns), fact[1].num_partitions
    _apply(fact, ("append", 30, 3), rng)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    for key in ("staged_bytes", "delta_stages", "full_restages"):
        assert got[key] == want[key], key
    d_p = fact[1].num_partitions - P
    assert len(tsvc.cache.topk_planes) == 1
    assert got["full_restages"] == 0 and got["delta_stages"] == 2
    # [C, ΔP] f32 x 3 stat columns + the [ΔP, KPLANE] top-k rows
    assert got["staged_bytes"] == (3 * C + 64) * 4 * d_p
    planes = _run(tsvc, tq)[0].counters["planes"]["f"]
    assert planes["version"] == fact[1].version
    assert planes["live"] == fact[1].num_live_partitions


def test_many_appends_until_capacity_overflow():
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair()
    cap = tsvc.plane_epoch(fact[1]).capacity
    fulls = 0
    while fact[1].num_partitions <= cap:
        _apply(fact, ("append", 20, 2), rng)
        got, want = _staging(tsvc, tq), _staging(rsvc, rq)
        assert got == want
        fulls += got["full_restages"]
        if fact[1].num_partitions <= cap:
            assert got["full_restages"] == 0     # in capacity: replayed
    # the overflowing append (and only it) restaged, with new headroom
    assert fulls >= 1
    assert tsvc.plane_epoch(fact[1]).capacity > cap
    _assert_planes_equal(tsvc.cache, rsvc.cache, "after overflow")


def test_drop_scatters_sentinels_without_restage():
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair()
    for t in fact:
        t.drop_partitions([1, 5, 9])
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want
    assert got["full_restages"] == 0 and got["delta_stages"] >= 1
    C = len(fact[1].columns)
    assert got["staged_bytes"] == (3 * C + 64) * 4 * 3
    (e,) = tsvc.cache.entries.values()
    mins, maxs, dem = (to_host(a) for a in e.planes)
    assert (mins[:, [1, 5, 9]] == np.finfo(np.float32).max).all()
    assert (maxs[:, [1, 5, 9]] == -np.finfo(np.float32).max).all()
    assert (dem[:, [1, 5, 9]] == 1).all()
    _assert_planes_equal(tsvc.cache, rsvc.cache, "after drop")


def test_rewrite_forces_full_restage():
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair()
    _apply(fact, ("rewrite",), rng)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want and got["full_restages"] >= 1
    _assert_planes_equal(tsvc.cache, rsvc.cache, "after rewrite")


def test_update_restages_only_the_column_rows():
    """An update of a column with no per-column plane restages that
    column's three stat rows only; an update of the top-k plane's own
    column restages that plane in full."""
    rng = np.random.default_rng(3)
    fact = _pair(RTable.build("f", _rows(rng, 240), rows_per_partition=10))
    dim = _pair(RTable.build("d", {
        "a": rng.integers(0, 100, 40).astype(np.int64),
        "k": rng.integers(0, 60, 40).astype(np.int64)},
        rows_per_partition=8))

    def queries(i, E, Query, Spec, Join):
        return [Query(scans={"f": Spec(fact[i], E.col("v") >= 0)}, limit=5,
                      order_by=("f", "v", True)),
                Query(scans={"f": Spec(fact[i]),
                             "d": Spec(dim[i], E.col("a") <= 90)},
                      join=Join("d", "f", "k", "k"))]

    rq = queries(0, RE, RQuery, RSpec, RJoin)
    tq = queries(1, TE, TQuery, TSpec, TJoin)
    tsvc, rsvc = TService(device="cpu", verdict_cache=False), _rservice()
    _run(tsvc, tq)
    _run(rsvc, rq)
    misses = tsvc.cache.plane_misses
    entry = tsvc.cache.entries[("f", fact[1].stats.uid)]
    _apply(fact, ("update", "g"), rng)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want
    assert got["full_restages"] == 0
    assert got["staged_bytes"] == 3 * fact[1].num_partitions * 4
    assert tsvc.cache.plane_misses == misses
    assert tsvc.cache.entries[("f", fact[1].stats.uid)] is entry
    assert entry.version == fact[1].version
    vals = rng.integers(100, 900, fact[1].num_rows).astype(np.int64)
    for t in fact:
        t.update_column("v", vals)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want and got["full_restages"] == 1
    assert tsvc.cache.plane_misses > misses
    _assert_planes_equal(tsvc.cache, rsvc.cache, "after updates")
    for g, w in zip(_run(tsvc, tq), _run(rsvc, rq)):
        _assert_reports_equal(g, w)


def test_legacy_notify_without_table_dml_still_restages():
    """A TableVersion bump with no delta log behind it restages in full
    (never serves a stale plane); the streaming notifications only
    advance the version."""
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair()
    tv = tsvc.register(fact[1])
    _run(tsvc, tq)
    misses = tsvc.cache.misses
    tsvc.notify_insert("f", 0)
    _run(tsvc, tq)
    assert tsvc.cache.misses == misses + 1
    assert tv.version == 1
    for notify in (tsvc.notify_delete, lambda n: tsvc.notify_update(n, "v")):
        notify("f")
        _run(tsvc, tq)
    assert tsvc.cache.misses == misses + 3 and tv.version == 3
    _apply(fact, ("append", 20, 2), rng)
    tsvc.notify_append("f", 2)
    staging = _staging(tsvc, tq)
    assert tv.version == 4 and tv.num_partitions == fact[1].num_partitions
    # the TableVersion moved on with the table's own delta log: the
    # planes replay it, nothing restages
    assert staging["full_restages"] == 0 and staging["delta_stages"] >= 1


def test_prefetch_stages_ahead_of_the_launch():
    """``prefetch`` stages the stat plane ahead of its launch (and replays
    it after DML), counting what the reference counts; the batch that
    follows finds it current (no stat-plane miss)."""
    rng = np.random.default_rng(3)
    fact, dim = _base_tables(3)
    tsvc, rsvc = TService(device="cpu", verdict_cache=False), _rservice()
    rq, tq = _both_queries(fact, dim, rng)
    for step in ("stage", "append"):
        if step == "append":
            _apply(fact, ("append", 30, 3), rng)
        for svc, t in ((tsvc, fact[1]), (rsvc, fact[0])):
            assert svc.cache.prefetch(t) is True, step
            assert svc.cache.prefetch(t) is False, step   # already current
        got = tsvc.cache.staging_snapshot()
        assert got == rsvc.cache.staging_snapshot(), step
        misses = tsvc.cache.misses
        _run(tsvc, [q for q in tq if set(q.scans) == {"f"}])
        _run(rsvc, [q for q in rq if set(q.scans) == {"f"}])
        assert tsvc.cache.misses == misses, step
        assert tsvc.cache.staging_snapshot() \
            == rsvc.cache.staging_snapshot(), step
    assert got["prefetch_stages"] == 2 and got["delta_stages"] == 1


def test_prefetch_failure_surfaces_on_the_launch():
    """A staging failure inside ``prefetch`` is not raised there: the
    batch's own launch meets it and the ladder demotes past the device
    rung, with reports equal to the reference."""
    rng = np.random.default_rng(4)
    fact, dim = _base_tables(4)
    inj = FaultInjector(seed=0).add("stage.stat", kind="error")
    svc = TService(device="cpu", fault_injector=inj)
    assert svc.cache.prefetch(fact[1]) is False
    assert svc.cache.staging_snapshot()["prefetch_stages"] == 0
    fired = len(inj.log)
    assert fired
    rq, tq = _both_queries(fact, dim, rng)
    got = _run(svc, tq)
    for g, w in zip(got, _run(_rservice(), rq)):
        _assert_reports_equal(g, w)
    assert len(inj.log) > fired
    res = got[0].counters["resilience"]
    assert res["demotions"]["host_kernel"] >= 1
    assert res["passthroughs"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_dropped_partitions_never_scanned(seed):
    rng = np.random.default_rng(seed)
    fact, dim = _base_tables(seed)
    drop = rng.choice(fact[0].num_partitions,
                      size=fact[0].num_partitions // 3, replace=False)
    svc = TService(device="cpu")
    rq, tq = _both_queries(fact, dim, rng)
    _run(svc, tq)                        # resident before the drop
    for t in fact:
        t.drop_partitions(drop)
    got = _run(svc, tq)
    for rep, q in zip(got, tq):
        for name, ss in rep.scan_sets.items():
            assert q.scans[name].table.live_mask[ss.part_ids].all()
        if rep.topk is not None:
            assert fact[1].live_mask[rep.topk.scanned].all()
    for g, w in zip(got, _run(_rservice(), rq)):
        _assert_reports_equal(g, w)


def test_tree_plane_append_replays_in_place():
    """An in-capacity append re-aggregates only the tail groups: the tree
    plane replays beside the flat plane, with the reference's bytes, into
    a copy of its group arrays that is swapped in (the arrays handed out
    before stay as they were)."""
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair(
        n=640, tree_fanout=TREE_FANOUT)
    assert tsvc.cache.tree_planes and rsvc.cache.tree_planes
    (te,) = tsvc.cache.tree_planes.values()
    arrays = te.arrays[:3]
    before = [a.clone() for a in arrays]
    _apply(fact, ("append", 30, 3), rng)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want
    assert got["full_restages"] == 0 and got["delta_stages"] >= 2
    assert all(a is not b for a, b in
               zip(arrays, tsvc.cache.tree_planes[
                   ("f", fact[1].stats.uid)].arrays[:3]))
    assert all(torch.equal(a, b) for a, b in zip(arrays, before))
    fresh = TService(device="cpu", tree_fanout=TREE_FANOUT)
    _run(fresh, tq)
    _assert_planes_equal(tsvc.cache, fresh.cache, "tree append fresh")
    _assert_planes_equal(tsvc.cache, rsvc.cache, "tree append reference")
    host = RPipeline().run(rq[0])
    _assert_reports_equal(_run(tsvc, tq)[0], host, topk_host=True)


def test_tree_plane_rewrite_forces_rebuild():
    fact, tsvc, rsvc, tq, rq, rng = _resident_pair(
        n=640, tree_fanout=TREE_FANOUT)
    before = tsvc.cache.staging_snapshot()["full_restages"]
    _apply(fact, ("rewrite",), rng)
    got, want = _staging(tsvc, tq), _staging(rsvc, rq)
    assert got == want
    # the stat, top-k and tree planes all rebuild
    assert tsvc.cache.staging_snapshot()["full_restages"] == before + 3
    _assert_planes_equal(tsvc.cache, rsvc.cache, "tree rewrite")


@pytest.mark.parametrize("with_nulls", [False, True])
def test_update_column_stats_equal_reference(with_nulls):
    """``update_column``'s segmented stats recompute equals the
    reference's per-partition loop: nulls excluded, all-null partitions
    the empty interval, dropped partitions keeping their sentinel."""
    rng = np.random.default_rng(9)
    fact, _dim = _base_tables(9, n=200)
    for t in fact:
        t.drop_partitions([2, 7])
    n = fact[0].num_rows
    vals = rng.integers(-300, 1100, n).astype(np.int64)
    nulls = None
    if with_nulls:
        nulls = rng.random(n) < 0.3
        nulls[fact[0].partition_rows(4)] = True         # all-null partition
    for t in fact:
        t.update_column("v", vals, nulls=nulls)
    for a, b in ((fact[0].stats.mins, fact[1].stats.mins),
                 (fact[0].stats.maxs, fact[1].stats.maxs),
                 (fact[0].stats.null_counts, fact[1].stats.null_counts)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
