"""The port's pruning engine as a whole against the JAX package.

Workloads go through the port's ``PruningService.run_batch`` on the CPU,
the reference's ``PruningService(mode="ref").run_batch`` and the
reference host ``PruningPipeline(filter_mode="host")``: a 64-query
filter + LIMIT workload, and the reference suite's mixed filter / JOIN /
top-k / JOIN + top-k workload with distinct and Bloom build summaries.
Scan sets, per-technique reports and top-k results must be identical
(exact: verdicts and selected values).  The tables are carried across
with ``Table.from_arrays`` so both packages prune the same partitions.
"""

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.data.table import Table as RTable
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import expr as TE
from repro_torch.core.flow import JoinSpec as TJoin
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.data.table import Table as TTable
from repro_torch.serve.prune_service import PruningService as TService
from repro.core.flow import JoinSpec as RJoin

from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import KernelError
from repro_torch.serve.resilience import (BackoffPolicy, DegradationLadder,
                                          FaultInjector, InjectedFault)

from test_torch_host import build_pred

torch.set_num_threads(1)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    n = 4000
    ts = np.sort(rng.integers(0, 1_000_000, n))
    ts[rng.random(n) < 0.02] = rng.integers(0, 1_000_000)   # stragglers
    events = RTable.build("events", {
        "ts": ts.astype(np.int64),
        "uid": rng.integers(0, 400, n).astype(np.int64),
        "val": rng.integers(-500, 500, n).astype(np.int64),
        "status": np.array(["ok-1", "ok-2", "warn-1", "err-3"])[
            np.sort(rng.integers(0, 4, n))],
        "score": rng.random(n),
    }, rows_per_partition=25, nulls={"val": rng.random(n) < 0.05})
    users = RTable.build("users", {
        "id": np.arange(400, dtype=np.int64),
        "grp": rng.integers(0, 8, 400).astype(np.int64),
    }, rows_per_partition=40)
    return [(t, TTable.from_arrays(t.name, t.columns, t.data, t.nulls,
                                   t.part_bounds)) for t in (events, users)]


def _workload(rng, n=64, with_float=False):
    """(table index, pred spec, limit, offset) per query: filter-only and
    plain-LIMIT queries over both tables, some with TruePred."""
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            lo = int(rng.integers(0, 900_000))
            out.append((0, ("range", "ts", lo, lo + int(rng.integers(1, 150_000))),
                        None, 0))
        elif kind == 1:
            spec = ("and", ("ge", "ts", int(rng.integers(0, 1_000_000))),
                    ("startswith", "status", str(rng.choice(["ok", "warn"]))))
            out.append((0, spec, int(rng.choice([0, 1, 10, 100, 5000])),
                        int(rng.integers(0, 3))))
        elif kind == 2:
            spec = (("true",) if rng.random() < 0.3
                    else ("cmp", "==", "grp", int(rng.integers(0, 8))))
            out.append((1, spec, int(rng.choice([0, 1, 20, 1000])), 0))
        elif with_float and rng.random() < 0.5:
            out.append((0, ("ge", "score", float(rng.uniform(0.1, 0.9))),
                        int(rng.choice([1, 50])), 0))
        else:
            # != does not lower to ranges: the host evaluator serves it
            out.append((0, ("or", ("cmp", "!=", "uid", int(rng.integers(0, 400))),
                            ("cmp", "<", "val", 0)), None, 0))
    return out


def _queries(workload, tables, E, Query, Spec):
    return [Query(scans={"s": Spec(tables[ti], build_pred(spec, E))},
                  limit=limit, offset=off)
            for ti, spec, limit, off in workload]


def _assert_reports_equal(a, b, topk_host=False):
    """Identical scan sets and reports; ``topk_host`` holds a device
    report to a host one, whose top-k boundary the device init may only
    strengthen: equal values, a superset of skipped partitions."""
    assert a.scan_sets.keys() == b.scan_sets.keys()
    for name in a.scan_sets:
        np.testing.assert_array_equal(a.scan_sets[name].part_ids,
                                      b.scan_sets[name].part_ids)
        np.testing.assert_array_equal(a.scan_sets[name].match,
                                      b.scan_sets[name].match)
        assert a.per_scan[name].keys() == b.per_scan[name].keys()
        for tech in a.per_scan[name]:
            ra, rb = a.per_scan[name][tech], b.per_scan[name][tech]
            if topk_host and tech in ("join", "topk"):
                # the execution path and the boundary init differ
                strip = {"path", "b_init_floor", "rows_scanned"}
                assert {k: v for k, v in ra.detail.items()
                        if k not in strip} == \
                    {k: v for k, v in rb.detail.items() if k not in strip}
                if tech == "topk":
                    continue
            else:
                assert ra.detail == rb.detail, (name, tech)
            assert (ra.before, ra.after, ra.applied) == \
                (rb.before, rb.after, rb.applied), (name, tech)
    assert (a.topk is None) == (b.topk is None)
    if a.topk is not None:
        np.testing.assert_array_equal(a.topk.values, b.topk.values)
        assert a.topk_scan == b.topk_scan
        if topk_host:
            assert np.isin(b.topk.skipped, a.topk.skipped).all()
        else:
            np.testing.assert_array_equal(a.topk.scanned, b.topk.scanned)
            np.testing.assert_array_equal(a.topk.skipped, b.topk.skipped)


@pytest.fixture(scope="module")
def tables():
    return _tables()


def _run_all(tables, workload):
    rtabs = [r for r, _ in tables]
    ttabs = [t for _, t in tables]
    tq = _queries(workload, ttabs, TE, TQuery, TSpec)
    rq = _queries(workload, rtabs, RE, RQuery, RSpec)
    svc = TService(device="cpu")
    got = svc.run_batch(tq)
    want = RService(mode="ref").run_batch(rq)
    host = [RPipeline(filter_mode="host").run(q) for q in rq]
    return svc, tq, got, want, host


@pytest.mark.parametrize("seed", range(3))
def test_run_batch_equals_reference_service_and_host_pipeline(tables, seed):
    workload = _workload(np.random.default_rng(seed))
    svc, tq, got, want, host = _run_all(tables, workload)
    assert len(got) == 64
    for g, w, h in zip(got, want, host):
        _assert_reports_equal(g, w)
        _assert_reports_equal(g, h)
    c = got[0].counters
    # one launch per table group whose predicates lowered
    assert c["technique"]["filter"]["launches"] == 2
    assert c["launches"] == 2
    # the != / OR predicates do not lower: counted host fallbacks
    assert c["technique"]["filter"]["fallbacks"] == sum(
        1 for w in workload if w[1][0] == "or")
    assert c["resilience"]["salvaged_batches"] == 0
    assert not any(c["resilience"]["demotions"].values())
    assert set(c["planes"]) == {"events", "users"}
    assert any("limit" in r.per_scan["s"] for r in got)


def test_float_predicates_equal_reference_service(tables):
    """Float bounds widen on the f32 planes: the port must reproduce the
    reference's device answer bit for bit and keep every partition the
    host keeps."""
    workload = _workload(np.random.default_rng(11), with_float=True)
    _svc, _tq, got, want, host = _run_all(tables, workload)
    for g, w, h in zip(got, want, host):
        _assert_reports_equal(g, w)
        assert np.isin(h.scan_sets["s"].part_ids,
                       g.scan_sets["s"].part_ids).all()


def test_single_query_device_pipeline_equals_reference(tables):
    workload = _workload(np.random.default_rng(5), n=16)
    rtabs = [r for r, _ in tables]
    ttabs = [t for _, t in tables]
    pipe = TPipeline(filter_mode="device", device="cpu")
    rpipe = RPipeline(filter_mode="device", service=RService(mode="ref"))
    for tq, rq in zip(_queries(workload, ttabs, TE, TQuery, TSpec),
                      _queries(workload, rtabs, RE, RQuery, RSpec)):
        _assert_reports_equal(pipe.run(tq), rpipe.run(rq))
    assert pipe.device_service().counters.launches > 0


@pytest.mark.parametrize("fault", ["error", "corrupt"])
def test_injected_fault_demotes_and_stays_exact(tables, fault):
    workload = _workload(np.random.default_rng(1))
    rtabs = [r for r, _ in tables]
    ttabs = [t for _, t in tables]
    tq = _queries(workload, ttabs, TE, TQuery, TSpec)
    host = [RPipeline(filter_mode="host").run(q)
            for q in _queries(workload, rtabs, RE, RQuery, RSpec)]
    inj = FaultInjector(seed=0)
    if fault == "error":
        inj.add("launch.filter:device", kind="error")
        svc = TService(device="cpu", fault_injector=inj)
    else:
        inj.add("stage.stat", kind="corrupt")       # every stage is torn
        svc = TService(device="cpu", fault_injector=inj, integrity_sample=1)
    got = svc.run_batch(tq)
    for g, h in zip(got, host):
        _assert_reports_equal(g, h)
    c = got[0].counters
    assert c["resilience"]["demotions"]["host_kernel"] == 2
    assert c["technique"]["filter"]["launches"] == 0
    if fault == "corrupt":
        assert c["integrity"]["checksum_failures"] >= 2


def test_transient_fault_is_retried_on_the_same_rung(tables):
    """One injected launch failure: the ladder sleeps its backoff (an
    injected sleep, no real wait), retries the device rung and serves
    the batch from it — no demotion."""
    workload = _workload(np.random.default_rng(4), n=16)
    tq = _queries(workload, [t for _, t in tables], TE, TQuery, TSpec)
    slept = []
    inj = FaultInjector(seed=0).add("launch.filter:device", times=1)
    svc = TService(device="cpu", fault_injector=inj, sleep=slept.append,
                   backoff=BackoffPolicy(retries=2, base_delay=0.125))
    got = svc.run_batch(tq)
    c = got[0].counters
    assert c["resilience"]["retries"] == 1 and slept == [0.125]
    assert not any(c["resilience"]["demotions"].values())
    assert c["technique"]["filter"]["launches"] == 2
    for g, w in zip(got, TService(device="cpu").run_batch(tq)):
        _assert_reports_equal(g, w)


def test_malformed_query_becomes_passthrough(tables):
    ev = tables[0][1]
    good = TQuery(scans={"e": TSpec(ev, TE.col("ts") >= 500_000)})
    bad = TQuery(scans={"e": TSpec(ev, TE.col("nope") >= 1)})
    svc = TService(device="cpu")
    r_good, r_bad = svc.run_batch([good, bad])
    assert r_bad.per_scan["e"]["filter"].detail == dict(path="passthrough")
    assert len(r_bad.scan_sets["e"]) == ev.num_partitions
    assert (r_bad.scan_sets["e"].match == 1).all()
    assert r_good.counters["resilience"]["errors"] == 1
    assert len(r_good.scan_sets["e"]) < ev.num_partitions


def test_dml_between_batches_restages_and_stays_exact():
    (rt, tt), _ = _tables(seed=2)
    workload = [w for w in _workload(np.random.default_rng(3)) if w[0] == 0]
    svc = TService(device="cpu")
    tq = _queries(workload, [tt], TE, TQuery, TSpec)
    svc.run_batch(tq)
    for t in (rt, tt):
        t.drop_partitions([0, 5, 9])
        t.append_partitions({"ts": np.arange(50, dtype=np.int64) * 7,
                             "uid": np.zeros(50, dtype=np.int64),
                             "val": np.ones(50, dtype=np.int64),
                             "status": np.array(["ok-1"] * 50),
                             "score": np.full(50, 0.5)},
                            rows_per_partition=25)
    got = svc.run_batch(tq)
    # the drop and the in-capacity append replay into the resident plane
    staging = got[0].counters["staging"]
    assert staging["full_restages"] == 0 and staging["delta_stages"] == 1
    host = [RPipeline(filter_mode="host").run(q)
            for q in _queries(workload, [rt], RE, RQuery, RSpec)]
    for g, h in zip(got, host):
        _assert_reports_equal(g, h)


def test_service_rejects_arguments_it_cannot_honour():
    with pytest.raises(ValueError):
        TService(device="cpu", mode="cuda")
    with pytest.raises(ValueError):
        TService(device="cpu", mode="pallas")


def _failing_kernel(*_args, **_kw):
    raise KernelError("minmax_prune_batched launch failed: cudaError 1")


def test_kernel_error_raises_out_of_run_batch(tables, monkeypatch):
    """A kernel that fails to launch is not a degradation: run_batch
    raises instead of serving the batch from a host rung."""
    workload = _workload(np.random.default_rng(6), n=16)
    tq = _queries(workload, [t for _, t in tables], TE, TQuery, TSpec)
    monkeypatch.setattr(tops, "minmax_prune_batched", _failing_kernel)
    svc = TService(device="cpu")
    with pytest.raises(KernelError, match="launch failed"):
        svc.run_batch(tq)
    assert not any(svc.resilience["demotions"].values())
    assert svc.resilience["retries"] == 0
    assert svc.resilience["salvaged_batches"] == 0
    assert svc.counters.host_fallbacks == 0


def test_kernel_error_is_not_salvaged_per_query(tables, monkeypatch):
    """A batch drive that breaks for another reason is salvaged query by
    query; a kernel failure met there still raises."""
    workload = _workload(np.random.default_rng(7), n=8)
    tq = _queries(workload, [t for _, t in tables], TE, TQuery, TSpec)
    svc = TService(device="cpu")

    def broken_batch(_queries):
        raise RuntimeError("batch drive broke")

    monkeypatch.setattr(svc, "prune_batch", broken_batch)
    monkeypatch.setattr(tops, "minmax_prune_batched", _failing_kernel)
    with pytest.raises(KernelError):
        svc.run_batch(tq)
    assert svc.resilience["salvaged_batches"] == 1
    assert svc.resilience["errors"] == 0
    assert not any(svc.resilience["demotions"].values())


@pytest.mark.parametrize("exc,demoted", [
    (KernelError("launch failed"), False),
    (InjectedFault("launch.filter:device"), True),
    (RuntimeError("torn plane"), True),
])
def test_ladder_demotes_faults_but_not_kernel_errors(exc, demoted):
    ladder = DegradationLadder(policy=BackoffPolicy(retries=1),
                               sleep=lambda _s: None)

    def device():
        raise exc

    rungs = [("device", device), ("host_kernel", lambda: "host")]
    if demoted:
        assert ladder.execute(rungs) == ("host", "host_kernel")
        assert ladder.counters["demotions"]["host_kernel"] == 1
    else:
        with pytest.raises(KernelError):
            ladder.execute(rungs)
        assert ladder.counters["demotions"]["host_kernel"] == 0
        assert ladder.counters["retries"] == 0


# ---------------------------------------------------------------------------
# JOIN and top-k: the mixed workload of the reference's engine suite
# ---------------------------------------------------------------------------

def _engine_tables(seed=0):
    """The reference suite's engine tables (tests/test_runtime_engine.py),
    built in both packages."""
    rng = np.random.default_rng(seed)
    n = 3000
    events = RTable.build("events", {
        "ts": np.sort(rng.integers(0, 1_000_000, n)).astype(np.int64),
        "uid": rng.integers(0, 400, n).astype(np.int64),
        "val": rng.integers(0, 10_000, n).astype(np.int64),
    }, rows_per_partition=30, nulls={"val": rng.random(n) < 0.03})
    users = RTable.build("users", {
        "id": np.arange(400, dtype=np.int64),
        "grp": rng.integers(0, 8, 400).astype(np.int64),
    }, rows_per_partition=40)
    return [(t, TTable.from_arrays(t.name, t.columns, t.data, t.nulls,
                                   t.part_bounds)) for t in (events, users)]


def _mixed_workload(rng, n=64):
    """(kind, lo, grp, k, desc) per query: filter, join, top-k and
    join + top-k, as the reference suite draws them."""
    out = []
    for i in range(n):
        lo = int(rng.integers(0, 900_000))
        g = int(rng.integers(0, 8))
        kind = i % 4
        k = int(rng.integers(1, 30)) if kind == 2 else 10
        out.append((kind, lo, g, k, bool(i % 8 < 4) if kind == 2 else True))
    return out


def _mixed_queries(workload, tables, E, Query, Spec, Join):
    events, users = tables
    qs = []
    for kind, lo, g, k, desc in workload:
        pred = (E.col("ts") >= lo) & (E.col("ts") <= lo + 150_000)
        scans = {"e": Spec(events, pred)}
        if kind in (1, 3):
            scans["u"] = Spec(users, E.col("grp") == g)
        qs.append(Query(
            scans=scans,
            join=Join("u", "e", "id", "uid") if kind in (1, 3) else None,
            limit=k if kind in (2, 3) else None,
            order_by=("e", "val", desc) if kind in (2, 3) else None))
    return qs


@pytest.fixture(scope="module")
def engine_tables():
    return _engine_tables()


def _run_mixed(tables, workload, ndv_limit=4096):
    rtabs = [r for r, _ in tables]
    ttabs = [t for _, t in tables]
    tq = _mixed_queries(workload, ttabs, TE, TQuery, TSpec, TJoin)
    rq = _mixed_queries(workload, rtabs, RE, RQuery, RSpec, RJoin)
    svc = TService(device="cpu")
    got = svc.run_batch(tq, TPipeline(filter_mode="device", service=svc,
                                      join_ndv_limit=ndv_limit))
    rsvc = RService(mode="ref")
    want = rsvc.run_batch(rq, RPipeline(filter_mode="device", service=rsvc,
                                        join_ndv_limit=ndv_limit))
    host = [RPipeline(filter_mode="host", join_ndv_limit=ndv_limit).run(q)
            for q in rq]
    return svc, tq, got, want, host


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ndv_limit", [4096, 16])
def test_mixed_run_batch_equals_reference_service_and_host(engine_tables,
                                                           seed, ndv_limit):
    """Filter, JOIN (distinct summaries, or Bloom ones under a small NDV
    limit), top-k and JOIN + top-k: bit-identical to the reference's
    batched service, and to the f64 host pipeline up to the device
    boundary init (equal values, a superset of skipped partitions)."""
    workload = _mixed_workload(np.random.default_rng(seed))
    svc, tq, got, want, host = _run_mixed(engine_tables, workload, ndv_limit)
    for g, w, h in zip(got, want, host):
        _assert_reports_equal(g, w)
        _assert_reports_equal(g, h, topk_host=True)
    c = got[0].counters
    assert c["technique"] == want[0].counters["technique"]
    kind = "join" if ndv_limit == 4096 else "join_bloom"
    assert c["technique"][kind] == dict(launches=1, fallbacks=0)
    assert c["technique"]["filter"]["launches"] == 2
    assert 1 <= c["technique"]["topk"]["launches"] <= 2
    # only the join + top-k queries keep the host-only boundary init
    assert c["technique"]["topk"]["fallbacks"] == sum(
        1 for w in workload if w[0] == 3)
    joins = [r.per_scan["e"]["join"].detail for r in got
             if "join" in r.per_scan["e"]]
    assert joins and all(d["path"] == "device" for d in joins)
    assert {d["summary_kind"] for d in joins} == (
        {"distinct"} if ndv_limit == 4096 else {"bloom"})


def test_mixed_single_query_pipeline_equals_reference(engine_tables):
    workload = _mixed_workload(np.random.default_rng(5), n=16)
    rtabs = [r for r, _ in engine_tables]
    ttabs = [t for _, t in engine_tables]
    pipe = TPipeline(filter_mode="device", device="cpu", join_ndv_limit=32)
    rpipe = RPipeline(filter_mode="device", service=RService(mode="ref"),
                      join_ndv_limit=32)
    for tq, rq in zip(_mixed_queries(workload, ttabs, TE, TQuery, TSpec,
                                     TJoin),
                      _mixed_queries(workload, rtabs, RE, RQuery, RSpec,
                                     RJoin)):
        _assert_reports_equal(pipe.run(tq), rpipe.run(rq))
    tech = pipe.device_service().counters.technique
    assert tech["join_bloom"]["launches"] > 0 and tech["topk"]["launches"] > 0


@pytest.mark.parametrize("shape", ["join", "order_by"])
def test_join_and_order_by_run_through_run_batch_and_pipeline(tables, shape):
    """A JOIN or an ORDER BY query is served, not refused: run_batch and
    PruningPipeline.run give the reference's answer."""
    (rev, tev), (rus, tus) = tables
    specs = []
    for E, Query, Spec, Join, ev, us in ((TE, TQuery, TSpec, TJoin, tev, tus),
                                         (RE, RQuery, RSpec, RJoin, rev, rus)):
        ok = Query(scans={"e": Spec(ev, E.col("ts") >= 5)})
        if shape == "join":
            q = Query(scans={"e": Spec(ev), "u": Spec(us, E.col("grp") == 3)},
                      join=Join("u", "e", "id", "uid"))
        else:
            q = Query(scans={"e": Spec(ev, E.col("ts") >= 200_000)},
                      limit=3, order_by=("e", "val", True))
        specs.append((ok, q))
    (tok, tq), (rok, rq) = specs
    svc = TService(device="cpu")
    got = svc.run_batch([tok, tq])
    want = RService(mode="ref").run_batch([rok, rq])
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)
    _assert_reports_equal(TPipeline(filter_mode="device", device="cpu").run(tq),
                          want[1])
    _assert_reports_equal(TPipeline().run(tq), RPipeline().run(rq))
    assert svc.resilience["errors"] == 0


@pytest.mark.parametrize("site,tech", [
    ("launch.join:device", "join"),
    ("launch.join_bloom:device", "join_bloom"),
    ("launch.topk:device", "topk"),
])
def test_runtime_stage_fault_demotes_and_stays_exact(engine_tables, site,
                                                     tech):
    """An injected fault at a JOIN or top-k launch demotes that stage to
    its exact host terminal rung: the answer equals the host pipeline's
    (top-k values; the host boundary then skips exactly as the host)."""
    workload = _mixed_workload(np.random.default_rng(2))
    ndv = 16 if tech == "join_bloom" else 4096
    rtabs = [r for r, _ in engine_tables]
    ttabs = [t for _, t in engine_tables]
    tq = _mixed_queries(workload, ttabs, TE, TQuery, TSpec, TJoin)
    rq = _mixed_queries(workload, rtabs, RE, RQuery, RSpec, RJoin)
    host = [RPipeline(filter_mode="host", join_ndv_limit=ndv).run(q)
            for q in rq]
    inj = FaultInjector(seed=0).add(site, kind="error")
    svc = TService(device="cpu", fault_injector=inj)
    got = svc.run_batch(tq, TPipeline(filter_mode="device", service=svc,
                                      join_ndv_limit=ndv))
    for g, h in zip(got, host):
        _assert_reports_equal(g, h, topk_host=True)
    c = got[0].counters
    assert c["resilience"]["demotions"]["host_oracle"] >= 1
    assert c["technique"][tech]["launches"] == 0
    assert c["technique"][tech]["fallbacks"] >= 1
    assert c["technique"]["filter"]["launches"] == 2
    if tech != "topk":
        assert all(r.per_scan["e"]["join"].detail["path"] == "host"
                   for r in got if "join" in r.per_scan["e"])


@pytest.mark.parametrize("kernel", ["join_overlap_batched",
                                    "bloom_probe_batched",
                                    "topk_init_batched"])
def test_runtime_kernel_error_raises_out_of_run_batch(engine_tables,
                                                      monkeypatch, kernel):
    """A JOIN or top-k kernel that fails to launch is not a degradation:
    run_batch raises, no rung or salvage takes the batch over."""
    workload = _mixed_workload(np.random.default_rng(6), n=16)
    tq = _mixed_queries(workload, [t for _, t in engine_tables], TE, TQuery,
                        TSpec, TJoin)

    def failing(*_a, **_kw):
        raise KernelError(f"{kernel} launch failed: cudaError 1")

    monkeypatch.setattr(tops, kernel, failing)
    svc = TService(device="cpu")
    pipe = TPipeline(filter_mode="device", service=svc,
                     join_ndv_limit=16 if kernel == "bloom_probe_batched"
                     else 4096)
    with pytest.raises(KernelError, match=kernel):
        svc.run_batch(tq, pipe)
    assert not any(svc.resilience["demotions"].values())
    assert svc.resilience["retries"] == 0
    assert svc.resilience["salvaged_batches"] == 0


def test_dml_between_batches_restages_runtime_planes(engine_tables):
    (rt, _), (ru, _) = _engine_tables(seed=4)
    tt = TTable.from_arrays(rt.name, rt.columns, rt.data, rt.nulls,
                            rt.part_bounds)
    tu = TTable.from_arrays(ru.name, ru.columns, ru.data, ru.nulls,
                            ru.part_bounds)
    workload = _mixed_workload(np.random.default_rng(8), n=32)
    svc = TService(device="cpu")
    pipe = TPipeline(filter_mode="device", service=svc, join_ndv_limit=16)
    svc.run_batch(_mixed_queries(workload, [tt, tu], TE, TQuery, TSpec,
                                 TJoin), pipe)
    for t in (rt, tt):
        t.drop_partitions([0, 7, 33])
        t.append_partitions({"ts": np.arange(60, dtype=np.int64) * 11,
                             "uid": np.arange(60, dtype=np.int64) % 400,
                             "val": np.arange(60, dtype=np.int64) * 97},
                            rows_per_partition=30)
    got = svc.run_batch(_mixed_queries(workload, [tt, tu], TE, TQuery, TSpec,
                                       TJoin), pipe)
    # the stat, join-key/enumeration and two block-top-k planes replay
    # the drop and the in-capacity append instead of restaging
    staging = got[0].counters["staging"]
    assert staging["full_restages"] == 0 and staging["delta_stages"] >= 3
    host = [RPipeline(filter_mode="host", join_ndv_limit=16).run(q)
            for q in _mixed_queries(workload, [rt, ru], RE, RQuery, RSpec,
                                    RJoin)]
    for g, h in zip(got, host):
        _assert_reports_equal(g, h, topk_host=True)
