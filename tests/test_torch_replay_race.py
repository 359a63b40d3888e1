"""A delta replay never tears a launch running on another thread, and the
reference's public members the port lacked (ROADMAP queue 3, F1 and F2).

F1: table ``t`` holds ``v`` over P partitions of two rows each, version
A's partition p being [10p, 10p+9] and version B's [10p+5, 10p+14];
64 queries ``v BETWEEN 10p+5 AND 10p+9`` are PARTIAL under A and under
B, and FULL only on a torn pair (min_B, max_A).  A launcher takes the
planes, an ``update_column`` to B replays them on another thread, and
the replay is held after its first row write (a patched
``Tensor.__setitem__`` waits on an event: deterministic, no sleeping)
while the launcher launches.  Every verdict row must be A's or B's, and
none FULL.  The threaded front-end case runs DML between submissions
from several threads.

F2: ``TechniqueReport.ratio``, ``PruningReport.technique_totals``,
``DeviceStats.gather``, ``DeviceStatsCache.hit_rate`` and
``FaultInjector.clear`` against the reference on the same inputs.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core.device_stats import DeviceStats as RDeviceStats
from repro.core.device_stats import DeviceStatsCache as RCache
from repro.core.device_stats import plane_capacity as r_capacity
from repro.core.flow import PruningPipeline as RPipeline
from repro.serve.resilience import FaultInjector as RInjector

from repro_torch.core import expr as TE
from repro_torch.core.device_stats import DeviceStats as TDeviceStats
from repro_torch.core.device_stats import DeviceStatsCache as TCache
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.core.metadata import FULL_MATCH
from repro_torch.data.table import Table as TTable
from repro_torch.kernels import ops
from repro_torch.serve.frontend import ServingFrontend
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector as TInjector

from test_system import guiding_query, guiding_tables
from test_torch_host import port_table
from test_torch_scan import port_query

torch.set_num_threads(1)

P = 4096
FANOUT = 16


def versions():
    p = np.arange(P, dtype=np.int64)
    a = np.stack([10 * p, 10 * p + 9], axis=1).reshape(-1)
    return a, a + 5


def race_table():
    a, _ = versions()
    return TTable.build("t", {"v": a, "w": np.arange(2 * P) % 7},
                        rows_per_partition=2)


def ranges(n=64):
    """n queries inside one partition (PARTIAL under A and B, FULL only
    on a torn pair), then n // 2 at a tree group's lower edge, [160g,
    160g+4]: partition 16g's under A, 16g-1's under B, and in no torn
    group hull."""
    rng = np.random.default_rng(0)
    ps = rng.integers(0, P, n)
    gs = rng.integers(1, P // FANOUT, n // 2)
    return ([[(0, float(10 * p + 5), float(10 * p + 9))] for p in ps]
            + [[(0, float(10 * FANOUT * g), float(10 * FANOUT * g + 4))]
               for g in gs])


def rows_of(table):
    """Each query's verdict row from a fresh cache: the version's truth."""
    return ops.prune_ranges_batched_device(
        ranges(), TCache(device="cpu").get(table), mode="torch")


class HeldReplay:
    """Patch ``Tensor.__setitem__`` so the thread that arms it stops after
    its first tensor write until ``resume`` is set."""

    def __init__(self, monkeypatch):
        self.paused, self.resume = threading.Event(), threading.Event()
        self.armed = None
        real = torch.Tensor.__setitem__

        def setitem(t, idx, value):
            real(t, idx, value)
            if threading.current_thread() is self.armed:
                self.armed = None
                self.paused.set()
                assert self.resume.wait(60)

        monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)

    def arm(self):
        self.armed = threading.current_thread()


@pytest.mark.parametrize("family", ["stat", "tree"])
def test_held_replay_never_tears_a_launch(monkeypatch, family):
    t = race_table()
    want_a = rows_of(t)
    cache = TCache(device="cpu", tree_fanout=FANOUT)
    # the launcher's planes, taken as the service takes them
    dstats = dataclasses.replace(cache.get(t))
    tree = cache.tree_plane(t, dstats) if family == "tree" else None
    _, b = versions()
    t.update_column("v", b)
    held = HeldReplay(monkeypatch)
    errors = []

    def replay():
        try:
            if family == "stat":
                held.arm()
            d = dataclasses.replace(cache.get(t))
            if family == "tree":
                held.arm()
                cache.tree_plane(t, d)
        except BaseException as exc:            # pragma: no cover
            errors.append(exc)
            held.paused.set()

    th = threading.Thread(target=replay)
    th.start()
    assert held.paused.wait(60)
    try:
        if family == "stat":
            got = ops.prune_ranges_batched_device(ranges(), dstats,
                                                  mode="torch")
        else:
            got = ops.prune_ranges_batched_tree(ranges(), dstats, tree,
                                                mode="torch")
            assert ops.last_tree_stats()["path"] == "tree"
    finally:
        held.resume.set()
        th.join(60)
    assert not errors
    want_b = rows_of(t)
    assert not (want_a == want_b).all()
    assert not (got == FULL_MATCH).any(), "a torn (min_B, max_A) pair"
    assert (got == want_a).all() or (got == want_b).all(), "a torn plane"
    # the replay finished and serves B's planes, whole
    after = dataclasses.replace(cache.get(t))
    np.testing.assert_array_equal(
        ops.prune_ranges_batched_device(ranges(), after, mode="torch"), want_b)


def test_replay_copy_counts_under_the_budget():
    """While a replay runs its clone is resident too: the budget's peak
    holds both copies, and use falls back after the swap."""
    t = race_table()
    cache = TCache(device="cpu", budget_bytes=1 << 30)
    one = cache.get(t).nbytes
    assert cache.memory.bytes_in_use == one == cache.memory.peak_bytes
    t.update_column("v", versions()[1])
    cache.get(t)
    assert cache.memory.peak_bytes == 2 * one
    assert cache.memory.bytes_in_use == one


def _verdict_row(report, table):
    row = np.zeros(table.num_partitions, dtype=np.int8)
    ss = report.scan_sets["t"]
    row[ss.part_ids] = ss.match
    return row


def test_threaded_frontend_with_dml_between_submissions():
    """The default threaded front-end (prefetch on) serves queries from
    three threads while a fourth alternates the table between versions A
    and B.  The host table's DML holds the cache lock, as the reference's
    probe serialises host work: only the launches' plane reads race the
    replays.  Every answer is A's or B's."""
    t = race_table()
    a, b = versions()
    preds = [(TE.col("v") >= lo) & (TE.col("v") <= hi)
             for ((_c, lo, hi),) in ranges(16)]
    truth = {}
    for name, vals in (("B", b), ("A", a)):
        t.update_column("v", vals)
        svc0 = TService(device="cpu", verdict_cache=False)
        truth[name] = [_verdict_row(r, t) for r in svc0.run_batch(
            [TQuery(scans={"t": TSpec(t, p)}) for p in preds])]
    svc = TService(device="cpu", verdict_cache=False)
    svc.run_batch([TQuery(scans={"t": TSpec(t, preds[0])})])
    seen = {"A": 0, "B": 0}
    bad = []
    lock = threading.Lock()
    with ServingFrontend(svc, max_batch=4, deadline_s=0.002,
                         threaded=True, prefetch=True) as fe:
        stop = threading.Event()

        def dml():
            for i in range(16):
                with svc.cache._lock:
                    t.update_column("v", b if i % 2 == 0 else a)
                stop.wait(0.003)

        def client(k):
            for i in range(16):
                qi = (k * 7 + i) % len(preds)
                resp = fe.submit(TQuery(scans={"t": TSpec(
                    t, preds[qi])})).result(timeout=120)
                row = _verdict_row(resp.report, t)
                with lock:
                    for name in ("A", "B"):
                        if np.array_equal(row, truth[name][qi]):
                            seen[name] += 1
                            break
                    else:
                        bad.append((qi, row))

        threads = [threading.Thread(target=dml)] + [
            threading.Thread(target=client, args=(k,)) for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    assert not bad, f"{len(bad)} answers neither A's nor B's"
    assert seen["A"] + seen["B"] == 48
    assert svc.cache.delta_stages > 0


# ---------------------------------------------------------------------------
# F2: the reference's public members
# ---------------------------------------------------------------------------

def test_technique_ratio_and_totals_equal_reference():
    trails, tracking = guiding_tables()
    for enable_join in (True, False):
        rq = guiding_query(trails, tracking)
        tq = port_query(rq, {})
        want = RPipeline(enable_join=enable_join).run(rq)
        got = TPipeline(enable_join=enable_join).run(tq)
        assert got.technique_totals() == want.technique_totals()
        for scan, techs in want.per_scan.items():
            for tech, rep in techs.items():
                assert got.per_scan[scan][tech].ratio == rep.ratio
    assert got.per_scan["tracking_data"]["filter"].ratio > 0


@pytest.mark.parametrize("cids", [[0], [1, 0], [1, 1, 0], []])
def test_device_stats_gather_equals_reference(cids):
    t = race_table()
    rt = None
    from repro.data.table import Table as RTable
    rt = RTable.build("t", {"v": versions()[0], "w": np.arange(2 * P) % 7},
                      rows_per_partition=2)
    assert port_table(rt).stats.num_partitions == P
    cap = r_capacity(P)
    want = RDeviceStats.stage(rt.stats, capacity=cap).gather(np.array(cids))
    got = TDeviceStats.stage(t.stats, capacity=cap, device="cpu").gather(
        np.array(cids))
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.shape == (len(cids), cap)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cache_hit_rate_equals_reference():
    from repro.data.table import Table as RTable
    rt = RTable.build("t", {"v": versions()[0], "w": np.arange(2 * P) % 7},
                      rows_per_partition=2)
    tt = port_table(rt)
    rc, tc = RCache(), TCache(device="cpu")
    assert tc.hit_rate == rc.hit_rate == 0.0
    for step in range(5):
        rc.get(rt)
        tc.get(tt)
        if step == 2:
            rt.update_column("w", np.arange(2 * P) % 5)
            tt.update_column("w", np.arange(2 * P) % 5)
        assert tc.hit_rate == rc.hit_rate
    assert 0 < tc.hit_rate < 1


def test_fault_injector_clear_equals_reference():
    out = []
    for cls in (TInjector, RInjector):
        inj = cls(seed=3, sleep=lambda s: None)
        inj.add("get.stat", kind="error", times=2)
        inj.add("launch.filter", kind="delay", delay=1.0)
        fired = []
        for site in ("get.stat", "launch.filter:device"):
            try:
                inj.fire(site)
                fired.append((site, "ok"))
            except Exception as exc:
                fired.append((site, type(exc).__name__))
        assert inj.clear() is inj
        inj.fire("get.stat")                 # no rule left: no fault
        log = list(inj.log)
        inj.add("get.stat", kind="error")
        with pytest.raises(Exception):
            inj.fire("get.stat")
        out.append((fired, log, len(inj.log)))
    assert out[0] == out[1]
