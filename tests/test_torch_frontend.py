"""The port's async front-end against the JAX package's, on the same
queries and the same injected clock.

The cases of ``tests/test_frontend.py``: scheduling (size cap at submit,
deadline at ``poll``, flush, close), parity with a direct ``run_batch``,
observability (timestamps, the ``counters["latency"]`` block,
``fleet_summary()["latency"]``), staging ahead of the launch, and the
threaded mode.  In inline mode under one ``FakeClock`` the port's
responses equal the reference front-end's field for field (cause, rid,
timestamps, queue depth, latencies) and its reports equal the
reference's; the latency counters are equal too.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.data.table import Table as RTable
from repro.serve.frontend import ServingFrontend as RFrontend
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import expr as TE
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.serve.frontend import FrontendResponse, ServingFrontend
from repro_torch.serve.prune_service import (LADDER_LAUNCH_SITES,
                                             PruningService as TService)
from repro_torch.serve.resilience import (COUNTER_REGISTRY,
                                          new_latency_counters)

from test_frontend import FakeClock
from test_torch_engine import _assert_reports_equal
from test_torch_fleet import _fleet, _traffic
from test_torch_ingest import _pair

torch.set_num_threads(1)

CPU = "cpu"


def _table(name="fe_t", rows=240, seed=5):
    rng = np.random.default_rng(seed)
    return _pair(RTable.build(name, {
        "ts": np.sort(rng.integers(0, 10_000, rows)).astype(np.int64),
        "v": rng.integers(0, 1_000, rows).astype(np.int64),
    }, rows_per_partition=8))


def _window(tables, lo, i, width=2_000):
    """A ``ts`` window query on the reference (i = 0) or port (1) table."""
    E, Query, Spec = (RE, RQuery, RSpec) if i == 0 else (TE, TQuery, TSpec)
    t = tables[i]
    return Query(scans={t.name: Spec(
        t, (E.col("ts") >= int(lo)) & (E.col("ts") <= int(lo + width)))})


class _Pair:
    """A reference and a port front-end, inline, on one FakeClock, each
    over a service with the verdict cache off (the reference suite's
    setting); every call goes to both."""

    def __init__(self, max_batch=4, deadline_s=1.0, prefetch=True):
        self.clock = FakeClock()
        self.rsvc = RService(mode="ref", verdict_cache=False)
        self.tsvc = TService(device=CPU, verdict_cache=False)
        self.fes = (
            RFrontend(self.rsvc, RPipeline(filter_mode="device",
                                           service=self.rsvc),
                      max_batch=max_batch, deadline_s=deadline_s,
                      clock=self.clock, threaded=False, prefetch=prefetch),
            ServingFrontend(self.tsvc, TPipeline(filter_mode="device",
                                                 service=self.tsvc),
                            max_batch=max_batch, deadline_s=deadline_s,
                            clock=self.clock, threaded=False,
                            prefetch=prefetch))
        self.futs = ([], [])

    def submit(self, queries):
        """queries: (reference query, port query)."""
        for i, (fe, q) in enumerate(zip(self.fes, queries)):
            self.futs[i].append(fe.submit(q))

    def call(self, name):
        out = [getattr(fe, name)() for fe in self.fes]
        assert out[0] == out[1], (name, out)
        return out[1]

    def check(self):
        """Every resolved response equal field for field, reports equal,
        and the latency counters equal; returns the port's responses."""
        rf, tf = self.futs
        assert [f.done() for f in rf] == [f.done() for f in tf]
        got = []
        for a, b in zip(rf, tf):
            if not b.done():
                continue
            ra, rb = a.result(), b.result()
            for field in ("rid", "cause", "timestamps", "queue_ms",
                          "latency_ms", "queue_depth"):
                assert getattr(ra, field) == getattr(rb, field), field
            _assert_reports_equal(rb.report, ra.report)
            assert rb.report.counters["latency"] \
                == ra.report.counters["latency"]
            got.append(rb)
        assert self.tsvc.latency == self.rsvc.latency
        assert self.tsvc.fleet_summary()["latency"] \
            == self.rsvc.fleet_summary()["latency"]
        return got


def test_size_cap_fires_at_submit():
    t = _table()
    p = _Pair(max_batch=3, deadline_s=5.0)
    for i in range(3):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    got = p.check()
    assert [r.cause for r in got] == ["size"] * 3 and p.clock.t == 0.0


def test_deadline_fires_at_poll_anchored_to_the_oldest():
    t = _table()
    p = _Pair(max_batch=8, deadline_s=5.0)
    p.submit([_window(t, 0, j) for j in (0, 1)])
    p.clock.advance(4.0)
    p.submit([_window(t, 500, j) for j in (0, 1)])
    assert p.call("poll") is None
    p.clock.advance(0.999)
    assert p.call("poll") is None
    p.clock.advance(0.001)
    assert p.call("poll") == "deadline"
    got = p.check()
    assert [r.cause for r in got] == ["deadline"] * 2   # the late one rode


def test_flush_and_close():
    t = _table()
    p = _Pair(max_batch=8, deadline_s=5.0)
    for i in range(2):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    assert p.call("flush") == 2
    assert p.call("flush") == 0
    p.submit([_window(t, 700, j) for j in (0, 1)])
    p.call("close")
    got = p.check()
    assert [r.cause for r in got] == ["flush"] * 3
    with pytest.raises(RuntimeError, match="closed"):
        p.fes[1].submit(_window(t, 100, 1))


def test_oversize_burst_splits_into_capped_batches():
    t = _table()
    p = _Pair(max_batch=2, deadline_s=5.0)
    for i in range(5):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    assert [f.done() for f in p.futs[1]] == [True] * 4 + [False]
    p.call("flush")
    p.check()
    lat = p.tsvc.latency
    assert (lat["batches"], lat["size_fired"], lat["flush_fired"]) == \
        (3, 2, 1)


@pytest.mark.parametrize("max_batch", [3, 24])
def test_frontend_bit_identical_to_reference_and_direct_run_batch(max_batch):
    """Fleet traffic through the front-end, in micro-batches of 3 (and a
    flush) or one full batch, equals a direct ``run_batch`` of the port
    and the reference front-end, response by response."""
    tables, dim = _fleet(6, seed=29)
    rq, tq = _traffic(tables, dim, 29, 24)
    p = _Pair(max_batch=max_batch, deadline_s=60.0)
    for pair in zip(rq, tq):
        p.submit(pair)
    p.call("close")
    got = p.check()
    direct = TService(device=CPU, verdict_cache=False)
    want = direct.run_batch(tq, TPipeline(filter_mode="device",
                                          service=direct))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_reports_equal(g.report, w)


def test_verdict_cache_on_behind_the_frontend():
    """The service's default (verdict cache on): repeated traffic through
    the front-end is served from verdicts and stays equal to run_batch."""
    tables, dim = _fleet(3, seed=30)
    _rq, tq = _traffic(tables, dim, 30, 12)
    svc = TService(device=CPU)
    fe = ServingFrontend(svc, max_batch=6, deadline_s=1.0,
                         clock=FakeClock(), threaded=False)
    futs = [fe.submit(q) for q in tq + tq + tq]
    fe.close()
    plain = TService(device=CPU, verdict_cache=False)
    want = plain.run_batch(tq)
    for i, f in enumerate(futs):
        _assert_reports_equal(f.result().report, want[i % len(tq)])
    assert svc.resilience["verdict_hits"] > 0


def test_response_timestamps_and_latency_block():
    t = _table()
    p = _Pair(max_batch=8, deadline_s=5.0)
    p.submit([_window(t, 0, j) for j in (0, 1)])
    p.clock.advance(2.0)
    p.submit([_window(t, 300, j) for j in (0, 1)])
    p.clock.advance(3.0)
    assert p.call("poll") == "deadline"
    resp = p.check()[1]
    assert isinstance(resp, FrontendResponse)
    ts = resp.timestamps
    assert ts["queued"] == 2.0 and ts["staged"] is not None
    assert ts["queued"] <= ts["dispatched"] <= ts["launched"] <= ts["done"]
    assert resp.queue_ms == pytest.approx(3_000.0)
    assert resp.queue_depth == 2
    block = resp.report.counters["latency"]
    assert block["requests"] == 2 and block["deadline_fired"] == 1
    assert block["p50_ms"] <= block["p99_ms"] <= block["max_ms"]
    summary = p.tsvc.fleet_summary()["latency"]
    assert (summary["requests"], summary["batches"],
            summary["queue_depth_peak"]) == (2, 1, 2)


def test_latency_keys_registered_and_dispatch_is_a_launch_site():
    assert "latency" in COUNTER_REGISTRY
    assert all(k in COUNTER_REGISTRY for k in new_latency_counters())
    t = _table()
    p = _Pair(max_batch=2, deadline_s=5.0)
    for i in range(2):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    for key in p.check()[0].report.counters["latency"]:
        assert key in COUNTER_REGISTRY, key
    assert "ServingFrontend._execute" in LADDER_LAUNCH_SITES
    assert "PruningService._verdict_group" in LADDER_LAUNCH_SITES


def test_prestage_then_launch_stages_nothing_new():
    t = _table("fe_cold", seed=7)
    svcs = (RService(mode="ref", verdict_cache=False),
            TService(device=CPU, verdict_cache=False))
    snaps = []
    for i, svc in enumerate(svcs):
        qs = [_window(t, 100 * k, i) for k in range(4)]
        assert svc.prestage(qs) == 1                 # one distinct table
        snap = svc.cache.staging_snapshot()
        svc.run_batch(qs)
        assert svc.cache.staging_snapshot()["staged_bytes"] \
            == snap["staged_bytes"]
        assert svc.prestage(qs) == 0                 # resident: no prefetch
        snaps.append(svc.cache.staging_snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["prefetch_stages"] == 1 and snaps[1]["staged_bytes"] > 0


def test_inline_prefetch_marks_submissions_staged():
    t = _table("fe_cold2", seed=9)
    p = _Pair(max_batch=2, deadline_s=5.0)
    for i in range(2):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    got = p.check()
    assert got[0].timestamps["staged"] is not None
    assert p.tsvc.cache.staging_snapshot()["prefetch_stages"] == 1
    assert p.tsvc.latency["prefetches"] == 2


def test_prefetch_never_raises():
    assert TService(device=CPU).cache.prefetch(object()) is False


def test_dml_between_batches_replays_before_the_next_launch():
    """A table appended to between two micro-batches: the next batch's
    prestage replays the delta into the resident planes in place before
    that batch's launch, and its reports equal the reference's."""
    t = _table("fe_dml", seed=11)
    p = _Pair(max_batch=2, deadline_s=5.0)
    for i in range(2):
        p.submit([_window(t, 100 * i, j) for j in (0, 1)])
    rng = np.random.default_rng(11)
    raw = {"ts": np.sort(rng.integers(10_000, 12_000, 64)).astype(np.int64),
           "v": rng.integers(0, 1_000, 64).astype(np.int64)}
    for tbl in t:
        tbl.append_partitions(raw, rows_per_partition=8)
    for lo in (9_000, 10_500):
        p.submit([_window(t, lo, j) for j in (0, 1)])
    p.check()
    snap = p.tsvc.cache.staging_snapshot()
    assert snap["delta_stages"] == 1 and snap["full_restages"] == 0
    assert snap["prefetch_stages"] == 2                  # stage, then replay


def _threaded(max_batch, deadline_s, svc=None):
    svc = svc or TService(device=CPU, verdict_cache=False)
    return svc, ServingFrontend(svc, max_batch=max_batch,
                                deadline_s=deadline_s, threaded=True)


def test_threaded_deadline_dispatches_partial_batch():
    t = _table()
    svc, fe = _threaded(64, 0.02)
    with fe:
        futs = [fe.submit(_window(t, 100 * i, 1)) for i in range(3)]
        resps = [f.result(timeout=30) for f in futs]
    assert [r.cause for r in resps] == ["deadline"] * 3
    assert svc.latency["deadline_fired"] == 1
    assert fe.stream is None                  # the CPU: no CUDA stream


def test_threaded_prestage_runs_on_the_batcher_thread():
    """Queries waiting for their deadline are staged by the batcher
    thread before the worker launches them."""
    t = _table("fe_stage", seed=13)
    svc, fe = _threaded(64, 1.0)
    staged_on = []
    real = svc.prestage

    def prestage(queries):
        staged_on.append(threading.current_thread().name)
        return real(queries)

    svc.prestage = prestage
    with fe:
        futs = [fe.submit(_window(t, 100 * i, 1)) for i in range(3)]
        resps = [f.result(timeout=60) for f in futs]
    assert staged_on and set(staged_on) == {"frontend-batcher"}
    assert all(r.timestamps["staged"] is not None for r in resps)
    assert svc.cache.staging_snapshot()["prefetch_stages"] == 1


def test_threaded_size_cap_and_drain():
    t = _table()
    svc, fe = _threaded(2, 30.0)
    with fe:
        futs = [fe.submit(_window(t, 70 * i, 1)) for i in range(5)]
        fe.drain()
        assert all(f.done() for f in futs)
    causes = [f.result().cause for f in futs]
    assert causes.count("size") == 4 and causes.count("flush") == 1
    assert svc.latency["requests"] == 5


def test_threaded_concurrent_submitters_equal_run_batch():
    """Four client threads; every response equals a direct run_batch of
    its query, and prestage ran on the batcher thread."""
    t = _table()
    svc, fe = _threaded(4, 0.02)
    staged_on = set()
    real = svc.prestage

    def prestage(queries):
        staged_on.add(threading.current_thread().name)
        return real(queries)

    svc.prestage = prestage
    out, errs = {}, []

    def client(base):
        try:
            fs = [(base + 50 * i, fe.submit(_window(t, base + 50 * i, 1)))
                  for i in range(6)]
            for lo, f in fs:
                out[lo] = f.result(timeout=60)
        except Exception as exc:  # pragma: no cover - failure detail
            errs.append(exc)

    with fe:
        threads = [threading.Thread(target=client, args=(800 * k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        fe.drain()
    assert not errs and len(out) == 24
    assert len({r.rid for r in out.values()}) == 24
    assert staged_on <= {"frontend-batcher"}
    direct = TService(device=CPU, verdict_cache=False)
    los = sorted(out)
    want = direct.run_batch([_window(t, lo, 1) for lo in los])
    for lo, w in zip(los, want):
        _assert_reports_equal(out[lo].report, w)
