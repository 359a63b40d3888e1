"""The port's query executor (``data/scan.py``) against the JAX package's.

The same numpy-seeded tables and queries go through both packages'
pipelines and executors: the answers, the null masks and the scan
metrics (partitions, rows, bytes) must be identical.  The reference
suite's guiding example, LIMIT and join flows run on both.  The port's
own ``run_batch`` reports must also leave every answer as the unpruned
scan gives it: pruning changes I/O, never results.
"""

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core.flow import JoinSpec as RJoin
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.core.metadata import ScanSet as RScanSet
from repro.data import scan as RS
from repro.data.generator import make_events_table, make_users_table
from repro.data.table import Table as RTable

from repro_torch.core import expr as TE
from repro_torch.core.flow import JoinSpec as TJoin
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.core.metadata import ScanSet as TScanSet
from repro_torch.data import scan as TS
from repro_torch.serve.prune_service import PruningService as TService

from test_system import guiding_query, guiding_tables
from test_torch_host import port_pred, port_table

torch.set_num_threads(1)


def port_query(q, tables):
    """The port's copy of a reference query; ``tables`` maps each
    reference table (by id) to its port copy, made once."""
    scans = {}
    for name, spec in q.scans.items():
        t = tables.setdefault(id(spec.table), port_table(spec.table))
        scans[name] = TSpec(t, port_pred(spec.pred))
    join = None if q.join is None else TJoin(
        q.join.build, q.join.probe, q.join.build_key, q.join.probe_key,
        q.join.kind)
    return TQuery(scans=scans, join=join, limit=q.limit, offset=q.offset,
                  order_by=q.order_by, group_by=q.group_by,
                  order_by_is_aggregate=q.order_by_is_aggregate)


def assert_results_equal(got, want):
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        assert got.columns[c].dtype == want.columns[c].dtype, c
        np.testing.assert_array_equal(got.columns[c], want.columns[c],
                                      err_msg=c)
        np.testing.assert_array_equal(got.nulls[c], want.nulls[c],
                                      err_msg=c)
    assert {n: vars(m) for n, m in got.metrics.items()} == \
        {n: vars(m) for n, m in want.metrics.items()}


def _both(rq, **pipe_kw):
    """(port result, reference result) for pruned and unpruned runs."""
    tq = port_query(rq, {})
    rrep = RPipeline(**pipe_kw).run(rq)
    trep = TPipeline(**pipe_kw).run(tq)
    out = []
    for report in (True, False):
        out.append((TS.execute_query(tq, trep if report else None),
                    RS.execute_query(rq, rrep if report else None)))
    return out


@pytest.mark.parametrize("seed,limit", [(0, 3), (1, 10), (2, 1)])
def test_guiding_example_equals_reference(seed, limit):
    trails, tracking = guiding_tables(seed)
    rq = guiding_query(trails, tracking, limit=limit)
    (pruned, rpruned), (full, rfull) = _both(rq)
    assert_results_equal(pruned, rpruned)
    assert_results_equal(full, rfull)
    np.testing.assert_array_equal(
        pruned.columns["tracking_data.num_sightings"],
        full.columns["tracking_data.num_sightings"])
    assert pruned.total_bytes() < full.total_bytes()


@pytest.mark.parametrize("enable_join", [True, False])
def test_guiding_example_techniques_change_io_not_results(enable_join):
    trails, tracking = guiding_tables()
    (pruned, rpruned), _ = _both(guiding_query(trails, tracking),
                                 enable_join=enable_join)
    assert_results_equal(pruned, rpruned)


@pytest.mark.parametrize("seed,k,pred", [
    (1, 50, ("ts", 9_000_000)), (2, 10, None), (3, 1, ("ts", 2_000_000)),
    (4, 200, ("ts", 2_000_000)), (5, 77, ("ts", 9_990_000))])
def test_limit_flow_equals_reference(seed, k, pred):
    events = make_events_table(np.random.default_rng(seed), n_rows=10_000,
                               rows_per_partition=250)
    p = RE.true() if pred is None else RE.col(pred[0]) >= pred[1]
    rq = RQuery(scans={"events": RSpec(events, p)}, limit=k)
    (pruned, rpruned), (full, rfull) = _both(rq)
    assert_results_equal(pruned, rpruned)
    assert_results_equal(full, rfull)
    assert pruned.num_rows == full.num_rows        # == min(k, matching)
    if pred is not None:
        assert (pruned.columns["events.ts"] >= pred[1]).all()


@pytest.mark.parametrize("kind", ["inner", "left_outer"])
def test_join_flow_equals_reference(kind):
    rng = np.random.default_rng(3)
    events = make_events_table(rng, n_rows=20_000, rows_per_partition=500,
                               user_clustering=0.997)
    users = make_users_table(rng, n_rows=2000, rows_per_partition=200)
    rq = RQuery(scans={"users": RSpec(users, RE.col("age") >= 85),
                       "events": RSpec(events)},
                join=RJoin("users", "events", "id", "user_id", kind))
    (pruned, rpruned), (full, rfull) = _both(rq)
    assert_results_equal(pruned, rpruned)
    assert_results_equal(full, rfull)
    if kind == "inner":
        assert pruned.num_rows == full.num_rows
    # left_outer: both packages' JOIN pruning also prunes the preserved
    # probe side, which drops rows the unpruned join keeps (ROADMAP
    # queue 3, a reference-side fault the port mirrors bit for bit)


def test_left_outer_join_pads_unmatched_probe_rows():
    probe = RTable.build("p", {"k": np.arange(20, dtype=np.int64)},
                         rows_per_partition=5)
    build = RTable.build("b", {"k": np.array([3, 4, 5], dtype=np.int64),
                               "v": np.array([30, 40, 50], dtype=np.int64)},
                         rows_per_partition=5)
    rq = RQuery(scans={"b": RSpec(build), "p": RSpec(probe)},
                join=RJoin("b", "p", "k", "k", kind="left_outer"))
    got = TS.execute_query(port_query(rq, {}), None)
    assert_results_equal(got, RS.execute_query(rq, None))
    assert got.num_rows == 20 and got.nulls["b.v"].sum() == 17


@pytest.mark.parametrize("seed", range(6))
def test_join_indices_equal_reference(seed):
    rng = np.random.default_rng(seed)
    nb, npr = int(rng.integers(0, 60)), int(rng.integers(0, 200))
    bk = rng.integers(0, 30, nb).astype(np.float64)
    pk = rng.integers(0, 40, npr).astype(np.float64)
    bn, pn = rng.random(nb) < 0.2, rng.random(npr) < 0.2
    for kind in ("inner", "left_outer"):
        for g, w in zip(TS._join_indices(pk, pn, bk, bn, kind),
                        RS._join_indices(pk, pn, bk, bn, kind)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_scan_partitions_equals_reference(seed):
    rng = np.random.default_rng(seed)
    events = make_events_table(rng, n_rows=4000, rows_per_partition=100)
    tt = port_table(events)
    for stop in (None, 1, 37, 10_000):
        ids = np.sort(rng.choice(events.num_partitions,
                                 size=int(rng.integers(0, 30)),
                                 replace=False))
        rp = RE.col("ts") >= int(rng.integers(0, 10_000_000))
        got = TS.scan_partitions(tt, TScanSet(ids), port_pred(rp), stop)
        want = RS.scan_partitions(events, RScanSet(ids), rp, stop)
        for g, w in zip(got[:2], want[:2]):
            assert list(g) == list(w)
            for c in w:
                np.testing.assert_array_equal(g[c], w[c])
        assert vars(got[2]) == vars(want[2])


def _queries(rng, events, users):
    """(query, ts window) pairs: filters, plain LIMITs and top-k on a
    ``ts`` window, and joins of ``users`` into events."""
    out = []
    for _ in range(6):
        lo = int(rng.integers(0, 9_000_000))
        win = (lo, lo + 800_000)
        pred = (TE.col("ts") >= win[0]) & (TE.col("ts") <= win[1])
        out.append((TQuery(scans={"e": TSpec(events, pred)}), win))
        out.append((TQuery(scans={"e": TSpec(events, pred)},
                           limit=int(rng.integers(1, 300))), win))
        out.append((TQuery(scans={"e": TSpec(events, pred)},
                           limit=int(rng.integers(1, 40)),
                           order_by=("e", "num_sightings",
                                     bool(rng.random() < 0.5))), win))
        age = int(rng.integers(60, 95))
        out.append((TQuery(scans={"u": TSpec(users, TE.col("age") >= age),
                                  "e": TSpec(events)},
                           join=TJoin("u", "e", "id", "user_id")), None))
    return out


def sorted_rows(res) -> np.ndarray:
    """The answer's rows as a matrix in lexicographic order: equal
    matrices are equal multisets of rows."""
    keys = sorted(res.columns)
    rows = np.stack([res.columns[c].astype(np.float64) for c in keys]
                    + [res.nulls[c].astype(np.float64) for c in keys],
                    axis=1)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def test_run_batch_reports_leave_answers_unchanged():
    """``execute_query(q, report) == execute_query(q, None)`` for the
    port's own ``run_batch`` reports: filter and join answers as equal
    multisets of rows, top-k by its ordered values (NULLS LAST), plain
    LIMIT as min(k, matching) rows that each satisfy the predicate."""
    rng = np.random.default_rng(5)
    events = port_table(make_events_table(rng, n_rows=20_000,
                                          rows_per_partition=100,
                                          user_clustering=0.997))
    users = port_table(make_users_table(rng, n_rows=2000,
                                        rows_per_partition=200))
    pairs = _queries(rng, events, users)
    reports = TService(device="cpu").run_batch([q for q, _ in pairs])
    ts = events.data["ts"]
    for (q, win), rep in zip(pairs, reports):
        pruned, full = TS.execute_query(q, rep), TS.execute_query(q, None)
        assert pruned.total_bytes() <= full.total_bytes()
        if q.is_topk:
            col = "e.num_sightings"
            np.testing.assert_array_equal(pruned.columns[col],
                                          full.columns[col])
            np.testing.assert_array_equal(pruned.nulls[col], full.nulls[col])
        elif q.is_plain_limit:
            matching = int(((ts >= win[0]) & (ts <= win[1])).sum())
            assert pruned.num_rows == min(q.limit, matching) == full.num_rows
            got = pruned.columns["e.ts"]
            assert ((got >= win[0]) & (got <= win[1])).all()
        else:
            assert pruned.num_rows == full.num_rows
            np.testing.assert_array_equal(sorted_rows(pruned),
                                          sorted_rows(full))


@pytest.mark.parametrize("first,most", [(1, 1), (3, 50), (16, 16)])
def test_scan_runs_and_halt_equal_reference_at_any_run_size(monkeypatch,
                                                            first, most):
    """The runs the port evaluates at once (down to a partition a run)
    change neither the rows nor the LIMIT halt nor the metrics."""
    monkeypatch.setattr(TS, "FIRST_RUN_ROWS", first)
    monkeypatch.setattr(TS, "MAX_RUN_ROWS", most)
    rng = np.random.default_rng(11)
    raw = {"v": rng.integers(0, 50, 900).astype(np.int64),
           "w": rng.random(900)}
    rt = RTable.build("t", raw, rows_per_partition=7,
                      nulls={"w": rng.random(900) < 0.1})
    tt = port_table(rt)
    ids = rng.permutation(rt.num_partitions)
    for stop in (None, 0, 1, 5, 40, 300, 10_000):
        for rp in (RE.col("v") >= 30, RE.true(), None):
            got = TS.scan_partitions(tt, TScanSet(ids),
                                     None if rp is None else port_pred(rp),
                                     stop)
            want = RS.scan_partitions(rt, RScanSet(ids), rp, stop)
            for g, w in zip(got[:2], want[:2]):
                for c in w:
                    assert g[c].dtype == w[c].dtype
                    np.testing.assert_array_equal(g[c], w[c])
            assert vars(got[2]) == vars(want[2]), (stop, rp)
