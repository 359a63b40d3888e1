"""The port's adaptive filter tree (paper Sec. 3.2) against the JAX
package's, bit for bit.

``AdaptivePruner`` is host f64 in both packages: the same table and
predicate (hypothesis draws over ``tests/helpers.py``'s ``small_tables``
and ``predicates``, carried over into the port) must give the same
three-valued ``tv``, work units and leaf report, and
``PruningPipeline(adaptive=True)`` the same scan sets.  Through the
port's ``run_batch`` an adaptive pipeline is a host pipeline: it launches
no kernel and demotes nothing.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import expr as RE
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.core.prune_tree import AdaptivePruner as RPruner
from repro.data.table import Table as RTable

from repro_torch.core import expr as TE
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.core.metadata import FULL_MATCH
from repro_torch.core.prune_filter import eval_tv
from repro_torch.core.prune_tree import AdaptivePruner as TPruner
from repro_torch.serve.prune_service import PruningService as TService

from helpers import predicates, small_tables
from test_torch_host import port_pred, port_table

torch.set_num_threads(1)


def _assert_runs_equal(got, want):
    assert got.tv.dtype == want.tv.dtype
    np.testing.assert_array_equal(got.tv, want.tv)
    assert got.work_units == want.work_units
    assert got.leaf_report == want.leaf_report


@settings(max_examples=60, deadline=None)
@given(tbl=small_tables(), pred=predicates(),
       batch=st.sampled_from([None, 1, 2, 3, 7]),
       cutoff=st.booleans(), reorder=st.booleans(),
       scan_cost=st.sampled_from([0.1, 2.0, 1000.0]))
def test_run_and_leaf_report_equal_reference(tbl, pred, batch, cutoff,
                                             reorder, scan_cost):
    tt, tp = port_table(tbl), port_pred(pred)
    kw = dict(scan_cost=scan_cost, reorder=reorder, cutoff=cutoff)
    want = RPruner(pred, **kw).run(tbl.stats, batch_size=batch)
    got = TPruner(tp, **kw).run(tt.stats, batch_size=batch)
    _assert_runs_equal(got, want)


@settings(max_examples=40, deadline=None)
@given(tbl=small_tables(), pred=predicates())
def test_adaptive_pipeline_scan_sets_equal_reference(tbl, pred):
    tt, tp = port_table(tbl), port_pred(pred)
    want = RPipeline(adaptive=True).run(
        RQuery(scans={"t": RSpec(tbl, pred)}))
    got = TPipeline(adaptive=True).run(TQuery(scans={"t": TSpec(tt, tp)}))
    for a, b in ((got.scan_sets["t"], want.scan_sets["t"]),):
        np.testing.assert_array_equal(a.part_ids, b.part_ids)
        np.testing.assert_array_equal(a.match, b.match)
    assert got.per_scan["t"]["filter"].before == \
        want.per_scan["t"]["filter"].before
    assert got.per_scan["t"]["filter"].after == \
        want.per_scan["t"]["filter"].after


def _clustered(seed, n, rows_pp):
    rng = np.random.default_rng(seed)
    raw = {"a": np.sort(rng.integers(0, 1000, size=n)),
           "b": rng.integers(0, 10, size=n)}
    rt = RTable.build("t", raw, rows_per_partition=rows_pp)
    return rt, port_table(rt)


def test_reordering_and_cutoff_cases_equal_reference():
    """The reference suite's reordering, AND cutoff and OR cases, run on
    both packages with equal results (``leaf_report``'s ``disabled``
    flags included)."""
    rt, tt = _clustered(3, 20_000, 100)
    for E, tbl, Pruner, out in ((RE, rt, RPruner, []),
                                (TE, tt, TPruner, [])):
        expensive = (E.col("b") * 1.0 + E.col("b") * 2.0
                     + E.col("b") * 3.0) >= 0.0
        pred = E.And((expensive, E.col("a") >= 995))
        for reorder in (True, False):
            out.append(Pruner(pred, reorder=reorder, cutoff=False).run(
                tbl.stats, batch_size=10))
        useless, selective = E.col("b") >= 0, E.col("a") >= 900
        out.append(Pruner(E.And((useless, selective)), scan_cost=5.0,
                          cutoff=True).run(tbl.stats, batch_size=10))
        out.append(Pruner(E.Or((useless, selective)), scan_cost=0.1,
                          cutoff=True).run(tbl.stats, batch_size=10))
        if E is RE:
            want = out
        else:
            got = out
    for g, w in zip(got, want):
        _assert_runs_equal(g, w)
    assert got[0].work_units < got[1].work_units
    report = {r["pred"]: r for r in got[2].leaf_report}
    assert report[repr(TE.col("b") >= 0)]["disabled"]
    assert not any(r["disabled"] for r in got[3].leaf_report)


@settings(max_examples=40, deadline=None)
@given(tbl=small_tables(), pred=predicates())
def test_adaptive_pipeline_sound_vs_exact_pipeline(tbl, pred):
    """Cutoff may only widen the scan set and weaken FULL to PARTIAL."""
    tt, tp = port_table(tbl), port_pred(pred)
    exact = TPipeline().run(TQuery(scans={"t": TSpec(tt, tp)}))
    adapt = TPipeline(adaptive=True).run(TQuery(scans={"t": TSpec(tt, tp)}))
    e, a = exact.scan_sets["t"], adapt.scan_sets["t"]
    assert set(e.part_ids) <= set(a.part_ids)
    e_full = set(e.part_ids[e.match == FULL_MATCH])
    a_full = set(a.part_ids[a.match == FULL_MATCH])
    assert a_full <= e_full


@settings(max_examples=40, deadline=None)
@given(tbl=small_tables(), thresh=st.integers(-60, 60))
def test_adaptive_pipeline_exact_on_uncuttable_predicates(tbl, thresh):
    tt = port_table(tbl)
    pred = TE.col("x") > thresh
    exact = TPipeline().run(TQuery(scans={"t": TSpec(tt, pred)}))
    adapt = TPipeline(adaptive=True).run(TQuery(scans={"t": TSpec(tt, pred)}))
    np.testing.assert_array_equal(adapt.scan_sets["t"].part_ids,
                                  exact.scan_sets["t"].part_ids)
    np.testing.assert_array_equal(adapt.scan_sets["t"].match,
                                  exact.scan_sets["t"].match)


def test_no_cutoff_tree_equals_eval_tv():
    rt, tt = _clustered(9, 4000, 50)
    rng = np.random.default_rng(9)
    for _ in range(8):
        lo = int(rng.integers(0, 1000))
        pred = ((TE.col("a") >= lo) & (TE.col("b") <= int(rng.integers(0, 10)))
                | (TE.col("a") < lo // 3))
        res = TPruner(pred, cutoff=False).run(tt.stats, batch_size=7)
        np.testing.assert_array_equal(res.tv, eval_tv(pred, tt.stats))


def test_adaptive_run_batch_launches_nothing():
    """``run_batch`` with an adaptive pipeline on the device service: the
    reference's scan sets, zero launches and zero demotions — the host
    pipeline is the caller's choice, not a fallback."""
    rng = np.random.default_rng(11)
    n = 3000
    raw = {"a": np.sort(rng.integers(0, 1000, size=n)),
           "b": rng.integers(0, 10, size=n)}
    rt = RTable.build("t", raw, rows_per_partition=25)
    tt = port_table(rt)
    specs = [(int(lo), int(b)) for lo, b in
             zip(rng.integers(0, 1000, 12), rng.integers(0, 10, 12))]

    def queries(E, Query, Spec, tbl):
        out = [Query(scans={"t": Spec(tbl, (E.col("a") >= lo)
                                      & (E.col("b") <= b))})
               for lo, b in specs]
        out.append(Query(scans={"t": Spec(tbl, E.col("a") >= 500)},
                         limit=7))
        out.append(Query(scans={"t": Spec(tbl, E.col("b") >= 3)}, limit=5,
                         order_by=("t", "a", True)))
        return out

    svc = TService(device="cpu")
    pipe = TPipeline(adaptive=True, filter_mode="device", service=svc)
    got = svc.run_batch(queries(TE, TQuery, TSpec, tt), pipeline=pipe)
    want = [RPipeline(adaptive=True).run(q)
            for q in queries(RE, RQuery, RSpec, rt)]
    for g, w in zip(got, want):
        for name in w.scan_sets:
            np.testing.assert_array_equal(g.scan_sets[name].part_ids,
                                          w.scan_sets[name].part_ids)
            np.testing.assert_array_equal(g.scan_sets[name].match,
                                          w.scan_sets[name].match)
        if w.topk is not None:
            np.testing.assert_array_equal(g.topk.values, w.topk.values)
        c = g.counters
        assert c["launches"] == 0 and c["host_fallbacks"] == 0
        assert c["tree_launches"] == 0 and c["sharded_launches"] == 0
        assert not any(v for t in c["technique"].values() for v in t.values())
        assert not any(c["resilience"]["demotions"].values())
        assert c["resilience"]["passthroughs"] == 0
    assert svc.counters.launches == 0
