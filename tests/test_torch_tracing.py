"""The port's tracer (``repro_torch.tracing``): off it records nothing and
hands out one shared no-op; on it nests spans by thread, carries each
query's ``rid`` from the front-end down to the stage spans, keeps a
bounded ring, mirrors into ``torch.profiler``, and changes no report."""

import collections

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import expr as E
from repro_torch.core.flow import JoinSpec, Query, TableScanSpec
from repro_torch.data.table import Table
from repro_torch.serve.frontend import ServingFrontend
from repro_torch.serve.prune_service import PruningService

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


def _tables(seed=3):
    rng = np.random.default_rng(seed)
    n = 4_096
    facts = Table.build("facts", {
        "ts": np.arange(n, dtype=np.int64),
        "uid": rng.integers(0, 400, n).astype(np.int64),
        "val": rng.integers(0, 100_000, n).astype(np.int64),
    }, rows_per_partition=64)
    users = Table.build("users", {
        "id": np.arange(400, dtype=np.int64),
        "age": rng.integers(18, 90, 400).astype(np.int64),
    }, rows_per_partition=50)
    return facts, users


def _queries(facts, users):
    """filter, join, top-k, LIMIT: one of each."""
    return [
        Query(scans={"f": TableScanSpec(facts, (E.col("ts") >= 100)
                                        & (E.col("ts") <= 900))}),
        Query(scans={"u": TableScanSpec(users, E.col("age") > 70),
                     "f": TableScanSpec(facts, E.col("ts") < 2_000)},
              join=JoinSpec("u", "f", "id", "uid")),
        Query(scans={"f": TableScanSpec(facts, E.col("ts") > 1_000)},
              limit=5, order_by=("f", "val", True)),
        Query(scans={"f": TableScanSpec(facts, E.col("ts") > 3_000)},
              limit=10),
    ]


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_off_records_nothing_and_hands_out_the_shared_noop():
    assert not tracing.on()
    assert tracing.span("a", rid=1) is tracing.NOOP
    assert tracing.query(3) is tracing.NOOP
    with tracing.span("a") as sp:
        assert not sp
        sp.set(x=1)
    tracing.record("b", 0.0, 1.0)
    svc = PruningService(device="cpu")
    svc.run_batch(_queries(*_tables()))
    assert tracing.records() == [] and tracing.dropped() == 0


def test_on_nests_spans_by_parent_and_self_time():
    tracing.enable()
    with tracing.span("outer", n=2) as a:
        with tracing.span("mid") as b:
            with tracing.query(7):
                with tracing.span("inner") as c:
                    c.set(k=1)
            tracing.record("past", 0.5, 0.75)
        with tracing.span("mid2"):
            pass
    got = {s.name: s for s in tracing.records()}
    assert got["outer"].parent == 0 and got["outer"].attrs == {"n": 2}
    assert got["mid"].parent == a.sid and got["mid2"].parent == a.sid
    # the query frame gives its rid and is no span: inner's parent is mid
    assert got["inner"].parent == b.sid == got["past"].parent
    assert got["inner"].attrs == {"rid": 7, "k": 1}
    assert "rid" not in got["mid"].attrs
    assert got["past"].t0 == 0.5 and got["past"].t1 == 0.75
    assert c.sid != b.sid != a.sid
    own = tracing.self_seconds(list(got.values()))
    outer, mid = got["outer"], got["mid"]
    assert own[outer.sid] == pytest.approx(
        (outer.t1 - outer.t0) - (mid.t1 - mid.t0)
        - (got["mid2"].t1 - got["mid2"].t0))
    # "past" lies before mid opened: it covers none of mid
    assert own[mid.sid] == pytest.approx(
        (mid.t1 - mid.t0) - (got["inner"].t1 - got["inner"].t0))


def test_the_ring_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 8)
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=8))
    tracing.enable()
    for i in range(20):
        tracing.record(f"s{i}", float(i), float(i) + 0.5)
    kept = tracing.records()
    assert [s.name for s in kept] == [f"s{i}" for i in range(12, 20)]
    assert tracing.dropped() == 12
    assert tracing.dropped_through() == 11.5
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0
    assert tracing.dropped_through() == float("-inf")


def test_the_ring_holds_nothing_the_garbage_collector_tracks():
    """A full ring must not lengthen the collector's passes: its entries
    are untracked after the first pass, attributes and rids included."""
    import gc

    tracing.enable()
    with tracing.span("a", rid=1, rids=(1, 2, 3)) as sp:
        sp.set(ok=True, table="t", n=3)
    tracing.record("b", 0.0, 1.0, rid=2, cause="size")
    gc.collect(0)
    assert not any(gc.is_tracked(e) for e in tracing._ring)
    a, b = tracing.records()
    assert a.attrs == {"rid": 1, "rids": (1, 2, 3), "ok": True,
                       "table": "t", "n": 3}
    assert b.attrs == {"rid": 2, "cause": "size"}


def test_a_profiler_session_turns_tracing_on_and_sees_the_spans():
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        svc = PruningService(device="cpu")
        svc.run_batch(_queries(*_tables()))
    assert not tracing.on()
    names = {s.name for s in tracing.records()}
    assert names == {"stage.filter", "stage.limit", "stage.join",
                     "stage.topk", "filter.plan", "filter.decode",
                     "join.build", "join.summary", "join.match",
                     "topk.order", "topk.scan",
                     "launch.minmax_prune_batched",
                     "launch.topk_init_batched", "launch.readback"}
    seen = {e.name for e in prof.events()}
    assert {"stage.filter", "stage.topk", "topk.scan",
            "launch.minmax_prune_batched"} <= seen


@pytest.mark.parametrize("mirror", [False, True])
def test_a_worker_threads_spans_reach_the_trace_when_mirrored(mirror):
    """The front-end runs its batches on a worker thread: a session that
    records every thread shows that thread's spans once they are
    mirrored there, and the ring keeps them either way."""
    import threading

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    def work():
        with tracing.span("worker.span"):
            torch.ones(3).add_(1)

    tracing.mirror_all_threads(mirror)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            t = threading.Thread(target=work)
            t.start()
            t.join()
    finally:
        tracing.mirror_all_threads(False)
    assert [s.name for s in tracing.records()] == ["worker.span"]
    assert ("worker.span" in {e.name for e in prof.events()}) == mirror


def test_rid_flows_from_the_frontend_to_the_stage_spans():
    tracing.enable()
    facts, users = _tables()
    qs = _queries(facts, users)
    svc = PruningService(device="cpu")
    fe = ServingFrontend(svc, max_batch=8, deadline_s=1.0,
                         clock=lambda: 0.0, threaded=False)
    for q in qs:            # a first batch: the rids checked do not start at 0
        fe.submit(q)
    fe.flush()
    tracing.clear()
    futs = [fe.submit(q) for q in qs]
    fe.flush()
    rids = [f.result().rid for f in futs]
    assert rids == list(range(len(qs), 2 * len(qs)))
    by = _by_name(tracing.records())
    (batch,) = by["frontend.batch"]
    assert batch.attrs == {"rids": tuple(rids)}
    queue = by["frontend.queue"]
    assert sorted(s.attrs["rid"] for s in queue) == rids
    # the injected clock times the queue spans
    assert all(s.parent == batch.sid and s.t0 == s.t1 == 0.0
               for s in queue)
    for name in ("stage.filter", "stage.limit", "stage.join", "stage.topk"):
        (stage,) = by[name]
        assert stage.attrs["rids"] == tuple(rids), name
        assert stage.parent == batch.sid, name
    join_rid, topk_rid = rids[1], rids[2]
    for name in ("join.build", "join.summary", "join.match"):
        assert [s.attrs for s in by[name]] == [{"rid": join_rid}], name
    for name in ("topk.order", "topk.scan"):
        assert [s.attrs["rid"] for s in by[name]] == [topk_rid], name
    (stage,) = by["stage.filter"]
    assert all(s.parent == stage.sid for s in by["filter.plan"]
               + by["filter.decode"])
    scan = by["topk.scan"][0].attrs
    assert 0 < scan["improved"] <= scan["read"]
    fe.close()


def test_a_direct_run_batch_gives_each_query_its_position():
    tracing.enable()
    svc = PruningService(device="cpu")
    svc.run_batch(_queries(*_tables()))
    by = _by_name(tracing.records())
    assert [s.attrs["rid"] for s in by["join.build"]] == [1]
    assert [s.attrs["rid"] for s in by["topk.scan"]] == [2]
    (stage,) = by["stage.filter"]
    assert stage.attrs["rids"] == (0, 1, 2, 3)
    launches = by["launch.minmax_prune_batched"]
    assert launches
    for launch in launches:
        assert launch.attrs == {}
        kids = [s for s in tracing.records() if s.parent == launch.sid]
        assert [s.name for s in kids] == ["launch.readback"]
        assert kids[0].t0 >= launch.t0 and kids[0].t1 <= launch.t1


def _plain(reports):
    out = []
    for r in reports:
        scans = {n: (ss.part_ids.tolist(), ss.match.tolist())
                 for n, ss in r.scan_sets.items()}
        tech = {n: {t: (x.before, x.after, x.detail)
                    for t, x in techs.items()}
                for n, techs in r.per_scan.items()}
        topk = None if r.topk is None else (r.topk.values.tolist(),
                                            r.topk.skipped.tolist())
        out.append((scans, tech, topk))
    return out


@pytest.mark.parametrize("via", ["run_batch", "frontend"])
def test_reports_are_equal_with_tracing_on_and_off(via):
    def run():
        facts, users = _tables()
        qs = _queries(facts, users)
        svc = PruningService(device="cpu")
        if via == "run_batch":
            return svc.run_batch(qs)
        fe = ServingFrontend(svc, max_batch=len(qs), deadline_s=1.0,
                             clock=lambda: 0.0, threaded=False)
        futs = [fe.submit(q) for q in qs]
        fe.close()
        return [f.result().report for f in futs]

    off = run()
    tracing.enable()
    on = run()
    assert tracing.records()
    assert _plain(on) == _plain(off)


@pytest.mark.parametrize("pred", [None, "odd"])
def test_topk_scan_counts_the_partitions_whose_rows_entered_the_heap(pred):
    """``improved`` against a replay of the scan that merges each read
    partition's rows and asks whether one of them is in the heap."""
    from repro_torch.core.metadata import live_full_scan
    from repro_torch.core.prune_topk import run_topk
    from repro_torch.core.rowval import matches

    rng = np.random.default_rng(11)
    n = 64 * 96
    t = Table.build("t", {
        "v": rng.integers(0, 50, n).astype(np.int64),     # many ties
        "w": rng.integers(0, 2, n).astype(np.int64),
    }, rows_per_partition=64)
    p = None if pred is None else E.col("w") == 1
    k = 40
    tracing.enable()
    res = run_topk(t, live_full_scan(t), "v", k, pred=p, desc=True)
    (scan,) = [s.attrs for s in tracing.records() if s.name == "topk.scan"]
    heap, want = [], 0
    for pid in res.scanned:
        ctx = t.partition_ctx(int(pid))
        mask = matches(p, ctx) if p is not None else np.ones(ctx.n, bool)
        vals, nm = ctx.col("v")
        new = [(-float(v), 1, int(pid), j) for j, v in
               enumerate(vals[mask & ~nm])]
        # old rows sort before equal new ones (the scan's stable merge)
        heap = sorted([(a, 0, b, c) for a, _z, b, c in heap] + new)[:k]
        want += any(r[1] == 1 for r in heap)
    assert scan["read"] == len(res.scanned)
    assert scan["improved"] == want
