"""The port's verdict cache against the JAX package's, on the same inputs.

The cases of ``tests/test_verdict_cache.py``: repeated traffic through a
DML program, dedupe before any launch, a full-hit batch that launches no
kernel, append repair in place, a torn row quarantined, persistent
corruption demoted.  Every batch of the port's ``PruningService(
device="cpu")`` (the verdict cache on, its default) is held bit-identical
to the reference's ``PruningService(mode="ref")``, to the port's service
with the cache off and to the f64 host pipeline, and the verdict counters
(``verdict_hits`` / ``verdict_misses`` / ``verdict_deduped`` /
``verdict_repairs``) equal the reference's.
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
from repro.serve.resilience import FaultInjector as RInjector

from repro_torch.core import expr as TE
from repro_torch.core.device_stats import PLANE_FAMILIES
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.kernels import ops as tops
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector as TInjector

from test_torch_engine import _assert_reports_equal
from test_torch_ingest import (NDV_LIMIT, _apply, _base_tables,
                               _both_queries, _pair, _program)

torch.set_num_threads(1)

NO_SLEEP = lambda d: None  # noqa: E731
VERDICT_KEYS = ("verdict_hits", "verdict_misses", "verdict_deduped")


def _run(svc, queries):
    pipe = (TPipeline if isinstance(svc, TService) else RPipeline)(
        filter_mode="device", service=svc, join_ndv_limit=NDV_LIMIT)
    return svc.run_batch(queries, pipe)


def _host(queries):
    pipe = RPipeline(join_ndv_limit=NDV_LIMIT)
    return [pipe.run(q) for q in queries]


def _counters(svc):
    out = {k: svc.resilience[k] for k in VERDICT_KEYS}
    out["verdict_repairs"] = svc.cache.integrity["verdict_repairs"]
    return out


def _small_pair(seed=0, n=110):
    rng = np.random.default_rng(seed)
    return _pair(RTable.build(
        "t", {"v": rng.integers(-200, 1000, n).astype(np.int64),
              "w": rng.integers(0, 100, n).astype(np.int64)},
        rows_per_partition=10))


def _qs(tbl, preds, E, Query, Spec):
    return [Query(scans={tbl.name: Spec(tbl, p(E))}) for p in preds]


def _both(tables, preds):
    return (_qs(tables[0], preds, RE, RQuery, RSpec),
            _qs(tables[1], preds, TE, TQuery, TSpec))


P_VW = lambda E: (E.col("v") >= 100) & (E.col("w") < 50)  # noqa: E731
P_V700 = lambda E: E.col("v") >= 700  # noqa: E731


def _assert_all_equal(got, wants, label, host=None):
    """``got`` equal to each report list of ``wants`` and, where given,
    to the host pipeline's ``host`` (top-k: equal values, skips a
    superset)."""
    for want in wants:
        for g, w in zip(got, want):
            _assert_reports_equal(g, w)
    for g, h in zip(got, host or ()):
        _assert_reports_equal(g, h, topk_host=True)


@pytest.mark.parametrize("seed", range(6))
def test_repeated_batches_under_dml_equal_reference(seed):
    """cached == cache off == reference (cached) == host after every step
    of a DML program, each step's batch run twice (the second sighting
    records, later ones hit or repair), with equal verdict counters."""
    rng = np.random.default_rng(seed)
    fact, dim = _base_tables(seed)
    tsvc, tplain = TService(device="cpu"), TService(device="cpu",
                                                    verdict_cache=False)
    rsvc = RService(mode="ref")
    for step, op in enumerate([("noop",)] + _program(seed)):
        if op[0] != "noop":
            _apply(fact, op, rng)
        # identical literals at every step: repeated traffic
        rq, tq = _both_queries(fact, dim, np.random.default_rng(seed))
        host = _host(rq)
        for rnd in range(2):
            got, want = _run(tsvc, tq), _run(rsvc, rq)
            _assert_all_equal(got, [want], f"step {step}.{rnd}", host)
            assert _counters(tsvc) == _counters(rsvc), (step, rnd)
        _assert_all_equal(_run(tplain, tq), [got], f"step {step} plain")
    assert tsvc.resilience["verdict_hits"] > 0
    assert tplain.resilience["verdict_hits"] == 0
    assert not tplain.cache.verdict_planes


def test_batch_dedupes_equivalent_predicates_before_launch():
    tables = _small_pair()
    preds = [P_VW,
             lambda E: (E.col("w") < 50) & (E.col("v") >= 100),   # commuted
             lambda E: (E.col("v") >= 100.0) & (E.col("w") < 50),  # 100.0
             P_V700]                                               # distinct
    rq, tq = _both(tables, preds)
    tsvc, rsvc = TService(device="cpu"), RService(mode="ref")
    got, want = _run(tsvc, tq), _run(rsvc, rq)
    assert _counters(tsvc) == _counters(rsvc)
    assert tsvc.resilience["verdict_deduped"] == 2
    assert tsvc.resilience["verdict_misses"] == 2
    # the two unique predicates went through one launch of the group
    assert tsvc.counters.technique["filter"]["launches"] == 1
    _assert_all_equal(got, [want], "dedupe", _host(rq))
    # equivalent predicates share one verdict row
    ss = [r.scan_sets["t"] for r in got[:3]]
    assert ss[0].part_ids is ss[1].part_ids is ss[2].part_ids


def test_full_hit_batch_never_touches_a_kernel(monkeypatch):
    tables = _small_pair()
    rq, tq = _both(tables, [P_VW, P_V700])
    tsvc, rsvc = TService(device="cpu"), RService(mode="ref")
    first = _run(tsvc, tq)
    _run(tsvc, tq)                 # second sighting: the doorkeeper admits
    for _ in range(2):
        _run(rsvc, rq)
    launches = tsvc.counters.launches

    def no_kernel(*a, **kw):
        raise AssertionError("a full-hit batch launched the filter kernel")

    monkeypatch.setattr(tops, "minmax_prune_batched", no_kernel)
    third, want = _run(tsvc, tq), _run(rsvc, rq)
    assert tsvc.counters.launches == launches
    assert third[0].counters["resilience"]["verdict_hits"] == 2
    assert _counters(tsvc) == _counters(rsvc)
    _assert_all_equal(third, [first, want], "full-hit repeat")


def test_append_repairs_in_place_instead_of_relaunching():
    rng = np.random.default_rng(7)
    tables = _small_pair(seed=7)
    rq, tq = _both(tables, [P_VW])
    tsvc, rsvc = TService(device="cpu"), RService(mode="ref")
    for _ in range(2):            # the second sighting records the row
        _run(tsvc, tq)
        _run(rsvc, rq)
    (key, entry), = tsvc.cache.verdict_planes.items()
    row = entry.arrays[0]
    before = row.clone()
    raw = {"v": rng.integers(-200, 1000, 30).astype(np.int64),
           "w": rng.integers(0, 100, 30).astype(np.int64)}
    for t in tables:
        t.append_partitions(raw, rows_per_partition=10)
        t.drop_partitions([2])
    launches = tsvc.counters.launches
    got, want = _run(tsvc, tq), _run(rsvc, rq)
    _assert_all_equal(got, [want], "append + drop repair", _host(rq))
    assert _counters(tsvc) == _counters(rsvc)
    assert tsvc.resilience["verdict_hits"] == 1          # repaired, not missed
    assert tsvc.cache.integrity["verdict_repairs"] == 1
    assert tsvc.counters.launches == launches            # no relaunch
    # written into a copy of the resident row that is swapped in (the row
    # a hit may be copying stays as it was): the dropped partition holds
    # the NO_MATCH sentinel, the capacity tail too
    new = tsvc.cache.verdict_planes[key].arrays[0]
    assert new is not row and torch.equal(row, before)
    P = tables[1].num_partitions
    assert int(new[2]) == 0 and not new[P:].any()


def test_update_of_a_read_column_drops_the_row_others_keep_it():
    """An update of a column the predicate reads is a miss (the row is
    dropped and relaunched); one of another column costs nothing."""
    rng = np.random.default_rng(3)
    tables = _small_pair(seed=3)
    rq, tq = _both(tables, [P_V700])                  # reads v only
    tsvc, rsvc = TService(device="cpu"), RService(mode="ref")
    for _ in range(2):
        _run(tsvc, tq)
        _run(rsvc, rq)
    for col, hit in (("w", True), ("v", False)):
        vals = rng.integers(-200, 1000, tables[0].num_rows).astype(np.int64)
        for t in tables:
            t.update_column(col, vals)
        before = tsvc.resilience["verdict_hits"]
        got, want = _run(tsvc, tq), _run(rsvc, rq)
        _assert_all_equal(got, [want], f"update {col}", _host(rq))
        assert (tsvc.resilience["verdict_hits"] - before == 1) is hit, col
        assert _counters(tsvc) == _counters(rsvc)


def test_invalidate_matches_verdict_rows_on_the_columns_read():
    tables = _small_pair()
    rq, tq = _both(tables, [P_VW, P_V700])
    svc = TService(device="cpu")
    for _ in range(2):
        _run(svc, tq)
    assert len(svc.cache.verdict_planes) == 2
    svc.cache.on_update("t", "w")            # only P_VW reads w
    (key,) = svc.cache.verdict_planes
    assert key[2] == TE.canonical_key(P_V700(TE))
    svc.cache.invalidate("t")
    assert not svc.cache.verdict_planes
    assert svc.cache.memory.bytes_in_use == svc.cache.resident_bytes


def test_verdict_family_is_registered_and_accounted():
    """The sixth plane family: declared, in the cache's stores, under the
    memory manager, padded to capacity with the NO_MATCH sentinel."""
    assert PLANE_FAMILIES[-1] == "verdict"
    tables = _small_pair()
    svc = TService(device="cpu")
    assert set(svc.cache._stores) == set(PLANE_FAMILIES)
    _, tq = _both(tables, [P_VW, P_VW])      # twice in the batch: admitted
    _run(svc, tq)
    (key, e), = svc.cache.verdict_planes.items()
    P = tables[1].num_partitions
    assert e.arrays[0].dtype == torch.int8
    assert e.arrays[0].shape[0] > P and not e.arrays[0][P:].any()
    assert ("verdict", key) in svc.cache.memory._resident
    assert svc.cache.memory.bytes_in_use == svc.cache.resident_bytes


def test_a_hit_returns_a_host_copy_of_the_device_row():
    """A verdict hit is a host (numpy) copy of the resident row's logical
    prefix: the scan set is built from it on the host, and writing the
    copy never touches the resident row."""
    tables = _small_pair()
    _, tq = _both(tables, [P_VW, P_VW])
    svc = TService(device="cpu")
    _run(svc, tq)
    pred = tq[0].scans["t"].pred
    ck = TE.canonical_key(pred)
    row = svc.cache.verdict_plane(tables[1], pred, ck)
    assert isinstance(row, np.ndarray) and row.dtype == np.int8
    assert row.shape == (tables[1].num_partitions,)
    row[:] = 0
    again = svc.cache.verdict_plane(tables[1], pred, ck)
    assert again.any()


def test_torn_resident_row_quarantined_then_serves_truth():
    """A row torn at record time: the verifier catches it on the next
    serve, quarantines it, and the miss relaunch records a clean row."""
    tables = _small_pair(seed=10)
    rq, tq = _both(tables, [P_VW])
    outs = {}
    for name, svc in (
            ("port", TService(device="cpu", fault_injector=TInjector(
                seed=1).add("stage.verdict", kind="corrupt", times=1))),
            ("ref", RService(mode="ref", fault_injector=RInjector(
                seed=1).add("stage.verdict", kind="corrupt", times=1)))):
        qs = tq if name == "port" else rq
        svc.cache.integrity_sample = 0      # record the torn row blind
        _run(svc, qs)
        _run(svc, qs)                       # second sighting records (torn)
        svc.cache.integrity_sample = 1      # verify on every serve
        got = _run(svc, qs)
        third = _run(svc, qs)
        integ = svc.cache.integrity
        assert integ["checksum_failures"] >= 1 and integ["quarantines"] >= 1
        assert svc.resilience["verdict_misses"] >= 3
        assert svc.resilience["verdict_hits"] >= 1
        outs[name] = (got, third, _counters(svc),
                      integ["quarantines"])
    for i in (0, 1):
        _assert_all_equal(outs["port"][i], [outs["ref"][i]], "torn verdict",
                          _host(rq))
    assert outs["port"][2:] == outs["ref"][2:]


def test_persistent_corruption_demotes_never_wrong():
    """Every verdict staging torn: the integrity protocol raises inside
    the verdict rung, the ladder demotes to the flat kernel chain, and
    the batch still returns the exact answer."""
    tables = _small_pair(seed=11)
    rq, tq = _both(tables, [P_VW, P_V700])
    inj = TInjector(seed=2).add("stage.verdict", kind="corrupt")
    svc = TService(device="cpu", fault_injector=inj, integrity_sample=1,
                   sleep=NO_SLEEP)
    _run(svc, tq)                  # first sighting: nothing recorded yet
    got = _run(svc, tq)            # records -> torn -> demote
    _assert_all_equal(got, [], "persistent verdict corruption", _host(rq))
    res = got[0].counters["resilience"]
    assert sum(res["demotions"].values()) >= 1      # cache-off demotion
    assert res["passthroughs"] == 0
    assert svc.cache.integrity["quarantines"] >= 1
