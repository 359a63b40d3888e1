"""The port's filter + LIMIT slice as a whole against the JAX package.

A 64-query filter + LIMIT workload goes through the port's
``PruningService.run_batch`` on the CPU, the reference's
``PruningService(mode="ref").run_batch`` and the reference host
``PruningPipeline(filter_mode="host")``; scan sets and per-technique
reports must be identical.  The tables are carried across with
``Table.from_arrays`` so both packages prune the same partitions.
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


def _assert_reports_equal(a, b):
    assert a.scan_sets.keys() == b.scan_sets.keys()
    for name in a.scan_sets:
        np.testing.assert_array_equal(a.scan_sets[name].part_ids,
                                      b.scan_sets[name].part_ids)
        np.testing.assert_array_equal(a.scan_sets[name].match,
                                      b.scan_sets[name].match)
        assert a.per_scan[name].keys() == b.per_scan[name].keys()
        for tech in a.per_scan[name]:
            ra, rb = a.per_scan[name][tech], b.per_scan[name][tech]
            assert (ra.before, ra.after, ra.applied) == \
                (rb.before, rb.after, rb.applied), (name, tech)
            assert ra.detail == rb.detail, (name, tech)


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


@pytest.mark.parametrize("shape", ["join", "order_by"])
def test_join_and_order_by_raise_before_any_stage(tables, shape):
    ev, us = tables[0][1], tables[1][1]
    ok = TQuery(scans={"e": TSpec(ev, TE.col("ts") >= 5)})
    if shape == "join":
        bad = TQuery(scans={"e": TSpec(ev), "u": TSpec(us)},
                     join=TJoin("u", "e", "id", "uid"))
    else:
        bad = TQuery(scans={"e": TSpec(ev)}, limit=3,
                     order_by=("e", "val", True))
    svc = TService(device="cpu")
    with pytest.raises(NotImplementedError):
        svc.run_batch([ok, bad])
    assert svc.counters.queries == 0 and svc.counters.launches == 0
    assert svc.resilience["errors"] == 0
    with pytest.raises(NotImplementedError):
        TPipeline().run(bad)


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
    assert got[0].counters["staging"]["full_restages"] == 1
    host = [RPipeline(filter_mode="host").run(q)
            for q in _queries(workload, [rt], RE, RQuery, RSpec)]
    for g, h in zip(got, host):
        _assert_reports_equal(g, h)


def test_service_rejects_arguments_it_cannot_honour():
    with pytest.raises(TypeError):
        TService(device="cpu", shard_mesh=True)
    with pytest.raises(TypeError):
        TService(device="cpu", tree_fanout=8)
    with pytest.raises(TypeError):
        TService(device="cpu", verdict_cache=False)
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
