"""The port's hierarchical (tree) planes and tree rungs against the JAX
package.

The group and coarse hulls (``aggregate_tree_planes``,
``coarse_from_groups``, ``tree_entry_for``) must equal the reference's
byte for byte; each of the four tree wrappers must return what the
reference's wrapper and the port's own flat path return, taking the same
path (``last_tree_stats()``: ``tree``, ``flat_dense`` or ``flat_small``,
with the same densities); the sentinel cases of the reference's kernel
sentinel suite must hold; a tree-plane fault must demote to the flat
``device`` rung with unchanged reports; and ``run_batch`` through the tree
rung must equal the reference service.  Tables use a fanout of 4-16 so P
stays a few thousand.  Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from repro.core import device_stats as RD
from repro.core.flow import PruningPipeline as RPipeline
from repro.core.metadata import ColumnMeta as RCol
from repro.core.metadata import PartitionStats as RStats
from repro.core.prune_join import BlockedBloom as RBloom
from repro.kernels import ops as rops
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import device_stats as TD
from repro_torch.core.metadata import ColumnMeta as TCol
from repro_torch.core.metadata import PartitionStats as TStats
from repro_torch.core.prune_join import BlockedBloom as TBloom
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.kernels import ops as tops
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector

from test_torch_engine import (RE, TE, RJoin, RQuery, RSpec, TJoin, TQuery,
                               TSpec, _assert_reports_equal, _engine_tables,
                               _mixed_queries, _mixed_workload)

torch.set_num_threads(1)

CPU = "cpu"
F32_MAX = np.float32(np.finfo(np.float32).max)
P = 3000
FANOUT = 16
DROPPED = np.array([0, 1, 2, 700, 701, 1500, 2999])


def _stats_pair(mins, maxs):
    """Reference and port PartitionStats over the same [P, C] int stats."""
    Pn, C = mins.shape
    args = (mins, maxs, np.zeros((Pn, C), np.int64),
            np.full(Pn, 5, np.int64))
    return (RStats([RCol(f"c{i}", "int") for i in range(C)],
                   *(a.copy() for a in args)),
            TStats([TCol(f"c{i}", "int") for i in range(C)],
                   *(a.copy() for a in args)))


def _planes(seed=0, n=P, dropped=DROPPED):
    """Clustered c0 (sorted, narrow), random c1 and c2 in [0, 500) with
    narrow ranges (enumerable keys), dropped partitions as empty
    intervals; staged at capacity in both packages."""
    rng = np.random.default_rng(seed)
    mins = np.empty((n, 3))
    mins[:, 0] = np.sort(rng.integers(0, 100_000, n))
    mins[:, 1] = rng.integers(-1000, 1000, n)
    mins[:, 2] = rng.integers(0, 500, n)
    maxs = mins + np.stack([rng.integers(0, 60, n), rng.integers(0, 400, n),
                            rng.integers(0, 6, n)], axis=1)
    mins[dropped], maxs[dropped] = np.inf, -np.inf
    rs, ts = _stats_pair(mins, maxs)
    cap = TD.plane_capacity(n)
    return (RD.DeviceStats.stage(rs, capacity=cap),
            TD.DeviceStats.stage(ts, capacity=cap, device=CPU), mins, maxs)


def _host(a):
    return TD.to_host(a) if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("fanout", [4, 16, 64])
def test_tree_planes_equal_reference_byte_for_byte(fanout):
    rd, td, _, _ = _planes(seed=fanout)
    re = RD.tree_entry_for(rd, fanout=fanout, version=3)
    te = TD.tree_entry_for(td, fanout=fanout, version=3)
    assert (te.version, te.logical_p, te.meta) == \
        (re.version, re.logical_p, re.meta)
    assert len(te.arrays) == len(re.arrays) == 5
    for got, want in zip(te.arrays, re.arrays):
        got, want = _host(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    # the coarse level is held on the host; the group level on the planes'
    assert all(a.device.type == "cpu" for a in te.arrays)
    for got, want in zip(TD.coarse_from_groups(*te.arrays[:2]),
                         RD.coarse_from_groups(*re.arrays[:2])):
        assert _host(got).tobytes() == np.asarray(want).tobytes()
    assert TD.plane_checksum(te.arrays) == RD.plane_checksum(re.arrays)


def test_tree_fanout_must_be_a_power_of_two():
    for bad in (0, 1, 3, 12):
        with pytest.raises(ValueError):
            TD.DeviceStatsCache(device=CPU, tree_fanout=bad)
    with pytest.raises(ValueError):
        TD.aggregate_tree_planes(*TD.DeviceStats.stage(
            _stats_pair(np.zeros((6, 1)), np.ones((6, 1)))[1],
            device=CPU).planes, fanout=4)


# ---------------------------------------------------------------------------
# the four wrappers, each through tree, flat_dense and flat_small
# ---------------------------------------------------------------------------

def _filter_cases(mins):
    """(expected path, range lists) per case."""
    live = np.setdiff1d(np.arange(P), DROPPED)
    anchors = mins[live[[10, 900, 1800, 2900]], 0]
    narrow = [[(0, float(a), float(a) + 300.0)] for a in anchors]
    narrow += [[(0, float(anchors[1]), float(anchors[1]) + 50.0),
                (1, -500.0, 500.0)],
               [(0, -10.0, -1.0)],                      # below everything
               [(0, float(anchors[2]), np.inf), (2, 100.0, 110.0)]]
    wide = [[(1, -200.0, 200.0)], [(2, 0.0, 250.0)], [(0, 0.0, 60_000.0)]]
    return [("tree", narrow), ("flat_dense", wide)]


def _check_note(kind):
    got, want = tops.last_tree_stats(), rops.last_tree_stats()
    assert got == want, (got, want)
    assert got["path"] == kind


def test_filter_tree_wrapper_equals_reference_and_flat():
    rd, td, mins, _ = _planes(seed=1)
    for fanout in (FANOUT, 4):
        re = RD.tree_entry_for(rd, fanout=fanout)
        te = TD.tree_entry_for(td, fanout=fanout)
        for kind, lists in _filter_cases(mins):
            want = rops.prune_ranges_batched_tree(lists, rd, re, mode="ref")
            got = tops.prune_ranges_batched_tree(lists, td, te)
            _check_note(kind)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, tops.prune_ranges_batched_device(lists, td))
    # too few groups for the geometry: the flat launch, noted flat_small
    big = 1 << 10                        # P < 4 groups of 1,024
    re, te = (RD.tree_entry_for(rd, fanout=big),
              TD.tree_entry_for(td, fanout=big))
    lists = _filter_cases(mins)[0][1]
    want = rops.prune_ranges_batched_tree(lists, rd, re, mode="ref")
    got = tops.prune_ranges_batched_tree(lists, td, te)
    _check_note("flat_small")
    np.testing.assert_array_equal(got, want)


def test_filter_tree_leaf_work_follows_the_survivors():
    """On selective ranges the leaves evaluated are a small share of the
    capacity: the point of the pre-pass."""
    _rd, td, mins, _ = _planes(seed=2)
    te = TD.tree_entry_for(td, fanout=FANOUT)
    tops.prune_ranges_batched_tree(_filter_cases(mins)[0][1][:4], td, te)
    note = tops.last_tree_stats()
    assert note["path"] == "tree"
    assert note["leaf_cols"] <= td.capacity // 8
    assert note["fine_density"] < 0.1


def _key_plane(mins, maxs, ci, cap):
    pmin = np.full(cap, F32_MAX, dtype=np.float32)
    pmax = np.full(cap, -F32_MAX, dtype=np.float32)
    pmin[:P] = np.clip(RD.round_down_f32(mins[:, ci]), -F32_MAX, F32_MAX)
    pmax[:P] = np.clip(RD.round_up_f32(maxs[:, ci]), -F32_MAX, F32_MAX)
    return pmin, pmax


def test_join_tree_wrapper_equals_reference_and_flat():
    rd, td, mins, maxs = _planes(seed=3)
    pmin, pmax = _key_plane(mins, maxs, 0, td.capacity)
    rng = np.random.default_rng(3)
    selective = [np.unique(rng.integers(a, a + 500, 6)).astype(np.float64)
                 for a in (100, 40_000, 99_000)]
    spread = [np.unique(rng.integers(0, 100_000, 400)).astype(np.float64)]
    lists = [np.sort(rng.choice(P, 900, replace=False)) for _ in range(3)]
    tp, tx = torch.from_numpy(pmin), torch.from_numpy(pmax)
    small = TD.DeviceStats.stage(_stats_pair(mins[:2048], maxs[:2048])[1],
                                 device=CPU)
    rsmall = RD.DeviceStats.stage(_stats_pair(mins[:2048], maxs[:2048])[0])
    for kind, dist, fan, (rsrc, tsrc) in (
            ("tree", selective, FANOUT, (rd, td)),
            ("flat_dense", spread, FANOUT, (rd, td)),
            ("flat_small", selective, FANOUT, (rsmall, small))):
        re = RD.tree_entry_for(rsrc, fanout=fan)
        te = TD.tree_entry_for(tsrc, fanout=fan)
        for ids in (None, lists[:len(dist)]):
            want = rops.join_overlap_batched_tree(
                dist, pmin, pmax, re, 0, mode="ref", part_ids_lists=ids)
            got = tops.join_overlap_batched_tree(
                dist, tp, tx, P, te, 0, part_ids_lists=ids)
            _check_note(kind)
            flat = tops.join_overlap_batched_device(dist, tp, tx, P,
                                                    part_ids_lists=ids)
            if ids is None:
                np.testing.assert_array_equal(got, want[:, :P])
                np.testing.assert_array_equal(got, flat)
            else:               # only the listed entries are defined
                for q, i in enumerate(ids):
                    np.testing.assert_array_equal(got[q, i], want[q, i])
                    np.testing.assert_array_equal(got[q, i], flat[q, i])


def _blooms(rng, B, keys):
    out = []
    for ks in keys:
        rb, tb = RBloom(B), TBloom(B)
        rb.add(ks)
        tb.add(ks)
        out.append((rb, tb))
    return [r for r, _ in out], [t for _, t in out]


def _enum_plane(mins, maxs, cap, enumerable_groups=None):
    pmin = np.zeros(cap, dtype=np.int32)
    width = np.zeros(cap, dtype=np.int32)
    pmin[:P] = np.where(np.isfinite(mins[:, 2]), mins[:, 2], 0)
    width[:P] = np.where(np.isfinite(mins[:, 2]),
                         maxs[:, 2] - mins[:, 2] + 1, 0)
    if enumerable_groups is not None:       # only these groups enumerable
        keep = np.zeros(cap, dtype=bool)
        for g in enumerable_groups:
            keep[g * FANOUT:(g + 1) * FANOUT] = True
        width[~keep] = 0
    return pmin, width


def test_bloom_tree_wrapper_equals_reference_and_flat():
    """The Bloom pre-pass has no density fallback: a tree entry of the
    plane's geometry always takes the tree path."""
    rd, td, mins, maxs = _planes(seed=4)
    rng = np.random.default_rng(4)
    rblooms, tblooms = _blooms(rng, 64, [rng.integers(0, 500, 40)
                                         for _ in range(3)])
    ids = [np.sort(rng.choice(P, 1200, replace=False)) for _ in range(3)]
    small_src = (RD.DeviceStats.stage(_stats_pair(mins[:2048],
                                                  maxs[:2048])[0]),
                 TD.DeviceStats.stage(_stats_pair(mins[:2048],
                                                  maxs[:2048])[1],
                                      device=CPU))
    for kind, groups, (rsrc, tsrc) in (("tree", [3, 40, 41, 180], (rd, td)),
                                       ("tree", None, (rd, td)),
                                       ("flat_small", None, small_src)):
        pmin, width = _enum_plane(mins, maxs, td.capacity, groups)
        wmax = int(width.max())
        re = RD.tree_entry_for(rsrc, fanout=FANOUT)
        te = TD.tree_entry_for(tsrc, fanout=FANOUT)
        tp, tw = torch.from_numpy(pmin), torch.from_numpy(width)
        for pid in (None, ids):
            want = rops.bloom_probe_batched_tree(
                rblooms, pmin, width, wmax, 1024, re, mode="ref",
                part_ids_lists=pid)
            got = tops.bloom_probe_batched_tree(
                tblooms, tp, tw, 1024, P, te, part_ids_lists=pid)
            _check_note(kind)
            flat = tops.bloom_probe_batched_device(tblooms, tp, tw, 1024, P,
                                                   part_ids_lists=pid)
            if pid is None:
                np.testing.assert_array_equal(got, want[:, :P])
                np.testing.assert_array_equal(got, flat)
            else:
                for q, i in enumerate(pid):
                    np.testing.assert_array_equal(got[q, i], want[q, i])
                    np.testing.assert_array_equal(got[q, i], flat[q, i])


def _topk_plane(rng, cap, K=8):
    plane = np.full((cap, K), -np.inf, dtype=np.float32)
    live = np.setdiff1d(np.arange(P), DROPPED)
    plane[live] = -np.sort(-rng.integers(-1000, 1000, (live.size, K))
                           .astype(np.float32), axis=1)
    return plane


def _mask(lists, cap):
    m = np.zeros((len(lists), cap), dtype=np.float32)
    for q, ids in enumerate(lists):
        m[q, ids] = 1.0
    return m


def test_topk_tree_wrapper_equals_reference_and_flat():
    """The compacted plane's remapped candidates select the same values
    as the dense plane's, as the reference's compacted masks do."""
    rd, td, _, _ = _planes(seed=5)
    rng = np.random.default_rng(5)
    cap = td.capacity
    plane = _topk_plane(rng, cap)
    sparse = [np.array([3, 4, 17, 18, 19, 2000, 2001]),
              np.array([0, 1, 2]),                        # dropped only
              np.array([31, 32, 33, 700, 1999])]
    dense = [np.sort(rng.choice(P, 2500, replace=False)), np.array([5])]
    small = (RD.DeviceStats.stage(_stats_pair(np.zeros((2048, 3)),
                                              np.ones((2048, 3)))[0]),
             TD.DeviceStats.stage(_stats_pair(np.zeros((2048, 3)),
                                              np.ones((2048, 3)))[1],
                                  device=CPU))
    for kind, lists, (rsrc, tsrc) in (("tree", sparse, (rd, td)),
                                      ("flat_dense", dense, (rd, td)),
                                      ("flat_small", sparse, small)):
        re = RD.tree_entry_for(rsrc, fanout=FANOUT)
        te = TD.tree_entry_for(tsrc, fanout=FANOUT)
        for k in (1, 4, 16):
            want = rops.topk_init_batched_tree(plane, _mask(lists, cap), k,
                                               re, mode="ref")
            got = tops.topk_init_batched_tree(torch.from_numpy(plane), lists,
                                              k, te)
            _check_note(kind)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, tops.topk_init_batched_device(torch.from_numpy(plane),
                                                   lists, k))


# ---------------------------------------------------------------------------
# sentinels at the group level (the reference's kernel sentinel suite)
# ---------------------------------------------------------------------------

SENT_FANOUT = 4
SENT_CAP = 64                      # 16 groups of 4; eligibility needs P>=16
SENT_P = 56                        # live logical slots; 56..63 capacity tail
# group 2 (slots 8..11) fully dropped; singles sit on group edges
SENT = np.array([0, 8, 9, 10, 11, 19, 20, 34, 55])
SENT_LIVE = np.array([i for i in range(SENT_P) if i not in SENT])


def _sentinel_fixture(seed=0, C=2):
    """Clustered float stats (sorted mins) so narrow ranges keep few
    groups; ``mins``/``maxs`` [P] (each column the same)."""
    rng = np.random.default_rng(seed)
    mins = np.sort(rng.uniform(-100, 100, SENT_P))
    maxs = mins + rng.uniform(0, 4, SENT_P)
    mins[SENT], maxs[SENT] = np.inf, -np.inf
    tile = (lambda a: np.tile(a[:, None], (1, C)))
    rs, ts = _stats_pair(tile(mins), tile(maxs))
    rs.columns = [RCol(f"c{i}", "float") for i in range(C)]
    ts.columns = [TCol(f"c{i}", "float") for i in range(C)]
    rd = RD.DeviceStats.stage(rs, capacity=SENT_CAP)
    td = TD.DeviceStats.stage(ts, capacity=SENT_CAP, device=CPU)
    return (rd, RD.tree_entry_for(rd, fanout=SENT_FANOUT), td,
            TD.tree_entry_for(td, fanout=SENT_FANOUT), mins, maxs)


def test_group_sentinels_bit_identical_to_flat():
    rd, re, td, te, mins, _ = _sentinel_fixture()
    lo = float(np.float32(mins[SENT_LIVE[5]]))
    lists = [[(0, lo, lo + 10.0)], [(1, 80.0, np.inf)],
             [(0, lo, lo), (1, -90.0, -70.0)], [(0, 200.0, 300.0)]]
    want = rops.prune_ranges_batched_tree(lists, rd, re, mode="ref")
    got = tops.prune_ranges_batched_tree(lists, td, te)
    _check_note("tree")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tops.prune_ranges_batched_device(
        lists, td))
    assert (got[:, SENT] == 0).all()


def test_group_dense_fallback_is_bit_identical_too():
    rd, re, td, te, _, _ = _sentinel_fixture(seed=1)
    lists = [[(0, -200.0, 200.0)], [(1, -150.0, 150.0)]]
    want = rops.prune_ranges_batched_tree(lists, rd, re, mode="ref")
    got = tops.prune_ranges_batched_tree(lists, td, te)
    _check_note("flat_dense")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tops.prune_ranges_batched_device(
        lists, td))
    assert (got[:, [8, 9, 10, 11]] == 0).all()


def test_group_hull_restriction_matches_flat_join():
    rd, re, td, te, mins, maxs = _sentinel_fixture(seed=2)
    pmin = np.full(SENT_CAP, F32_MAX, dtype=np.float32)
    pmax = np.full(SENT_CAP, -F32_MAX, dtype=np.float32)
    pmin[SENT_LIVE] = mins[SENT_LIVE].astype(np.float32)
    pmax[SENT_LIVE] = maxs[SENT_LIVE].astype(np.float32)
    anchor = float(np.float32(mins[SENT_LIVE[8]]))
    dist = [np.sort(np.array([anchor, anchor + 1.0], dtype=np.float32)),
            np.array([F32_MAX], dtype=np.float32),   # == the sentinel pmin
            np.array([-150.0], dtype=np.float32)]    # below every hull
    tp, tx = torch.from_numpy(pmin), torch.from_numpy(pmax)
    want = rops.join_overlap_batched_tree(dist, pmin, pmax, re, 0,
                                          mode="ref")
    got = tops.join_overlap_batched_tree(dist, tp, tx, SENT_P, te, 0)
    _check_note("tree")
    np.testing.assert_array_equal(got, want[:, :SENT_P])
    np.testing.assert_array_equal(got, tops.join_overlap_batched_device(
        dist, tp, tx, SENT_P))
    assert (got[:, SENT] == 0).all()


def test_width_zero_groups_stay_unconditional_keeps():
    rd, re, td, te, _, _ = _sentinel_fixture(seed=3)
    rng = np.random.default_rng(3)
    pmin = np.zeros(SENT_CAP, dtype=np.int32)
    width = np.zeros(SENT_CAP, dtype=np.int32)     # sentinel width 0
    pmin[SENT_LIVE] = rng.integers(0, 500, SENT_LIVE.size)
    width[SENT_LIVE] = rng.integers(1, 12, SENT_LIVE.size)
    rblooms, tblooms = _blooms(rng, 64, [rng.integers(0, 500, 40)
                                         for _ in range(3)])
    tp, tw = torch.from_numpy(pmin), torch.from_numpy(width)
    want = rops.bloom_probe_batched_tree(rblooms, pmin, width,
                                         int(width.max()), 1024, re,
                                         mode="ref")
    got = tops.bloom_probe_batched_tree(tblooms, tp, tw, 1024, SENT_P, te)
    _check_note("tree")
    np.testing.assert_array_equal(got, want[:, :SENT_P])
    np.testing.assert_array_equal(got, tops.bloom_probe_batched_device(
        tblooms, tp, tw, 1024, SENT_P))
    assert (got[:, [8, 9, 10, 11]] == 1).all()


def test_compacted_groups_match_flat_heap():
    rd, re, td, te, _, _ = _sentinel_fixture(seed=4)
    rng = np.random.default_rng(4)
    K, k = 8, 4
    plane = np.full((SENT_CAP, K), -np.inf, dtype=np.float32)
    plane[SENT_LIVE] = np.sort(
        rng.uniform(-100, 100, (SENT_LIVE.size, K)).astype(np.float32),
        axis=1)[:, ::-1]
    # one list selects ONLY the dropped group, whose heap must come back
    # empty; one straddles a group edge
    lists = [np.array([1, 2, 5, 6, 12, 13]), np.array([8, 9, 10, 11]),
             np.array([7, 8])]
    want = rops.topk_init_batched_tree(plane, _mask(lists, SENT_CAP), k, re,
                                       mode="ref")
    got = tops.topk_init_batched_tree(torch.from_numpy(plane), lists, k, te)
    _check_note("tree")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tops.topk_init_batched_device(
        torch.from_numpy(plane), lists, k))
    assert (got[1] == -np.inf).all()


# ---------------------------------------------------------------------------
# the tree rung in the service
# ---------------------------------------------------------------------------

def _mixed(tables, seed, ndv_limit):
    workload = _mixed_workload(np.random.default_rng(seed), n=32)
    tq = _mixed_queries(workload, [t for _, t in tables], TE, TQuery, TSpec,
                        TJoin)
    rq = _mixed_queries(workload, [r for r, _ in tables], RE, RQuery, RSpec,
                        RJoin)
    return tq, rq


def _run(svc, queries, ndv_limit):
    cls = TPipeline if isinstance(svc, TService) else RPipeline
    return svc.run_batch(queries, cls(filter_mode="device", service=svc,
                                      join_ndv_limit=ndv_limit))


@pytest.fixture(scope="module")
def tables():
    return _engine_tables()


@pytest.mark.parametrize("ndv_limit", [4096, 16])
def test_run_batch_through_tree_rung_equals_reference(tables, ndv_limit,
                                                      monkeypatch):
    """tree_fanout=8 puts the 100-partition events table on the tree rung
    of every stage; reports equal the reference's tree service and the
    port's flat service."""
    tq, rq = _mixed(tables, 7, ndv_limit)
    paths, tree_fn = [], tops.prune_ranges_batched_tree

    def spy(*a, **kw):
        out = tree_fn(*a, **kw)
        paths.append(tops.last_tree_stats()["path"])
        return out
    monkeypatch.setattr(tops, "prune_ranges_batched_tree", spy)
    svc = TService(device=CPU, tree_fanout=8)
    got = _run(svc, tq, ndv_limit)
    want = _run(RService(mode="ref", tree_fanout=8, verdict_cache=False), rq,
                ndv_limit)
    flat = _run(TService(device=CPU), tq, ndv_limit)
    for g, w, f in zip(got, want, flat):
        _assert_reports_equal(g, w)
        _assert_reports_equal(g, f)
    c = got[0].counters
    launches = sum(t["launches"] for t in c["technique"].values())
    # every evaluation ran the tree rung but the 10-partition users
    # table's one filter launch (below 4 groups of 8: flat); a filter
    # group on the gathered tree path launches no kernel, so it counts
    # as a tree evaluation alone
    gathered = paths.count("tree")
    assert paths and c["technique"]["filter"]["launches"] \
        == 1 + len(paths) - gathered
    assert c["tree_launches"] == launches - 1 + gathered
    assert svc.cache.tree_planes
    assert not any(c["resilience"]["demotions"].values())


def test_pipeline_takes_tree_fanout():
    svc = TPipeline(filter_mode="device", device=CPU,
                    tree_fanout=8).device_service()
    assert svc.cache.tree_fanout == 8
    with pytest.raises(ValueError):
        TPipeline(filter_mode="device", service=svc, tree_fanout=8)


@pytest.mark.parametrize("site,kind", [
    ("stage.tree_stat", "error"),
    ("get.tree_stat", "error"),
    ("stage.tree_stat", "corrupt"),
    ("launch.filter:tree", "error"),
    ("launch.join:tree", "error"),
    ("launch.topk:tree", "error"),
])
def test_tree_plane_fault_demotes_to_device_rung(tables, site, kind):
    """A tree-plane fault (staging failure, a persistently torn plane, a
    failed tree launch) demotes to the flat device rung, which never
    reads the tree family: the reports stay equal to the reference."""
    tq, rq = _mixed(tables, 8, 4096)
    inj = FaultInjector(seed=0).add(site, kind=kind)
    svc = TService(device=CPU, tree_fanout=8, fault_injector=inj,
                   integrity_sample=1)
    got = _run(svc, tq, 4096)
    want = _run(RService(mode="ref", verdict_cache=False), rq, 4096)
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)
    res = got[0].counters["resilience"]
    assert res["demotions"]["device"] >= 1
    assert res["demotions"]["host_kernel"] == 0
    assert res["passthroughs"] == 0
    assert inj.log
