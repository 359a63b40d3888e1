"""Resident stat planes of the PyTorch port against the JAX package's.

``DeviceStats.stage`` must give the same f32 bytes as the reference (the
widening casts, the demote plane, the capacity-tail sentinels
``(+f32max, -f32max, demote=1)``) and the same checksum; the cache must
keep pinned planes resident under a budget and restage when the table's
version moves on.  Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from repro.core import device_stats as RD
from repro.core import metadata as RM

from repro_torch.core import device_stats as TD
from repro_torch.core import metadata as TM
from repro_torch.serve.resilience import FaultInjector

from test_torch_host import both_tables, table_raw

torch.set_num_threads(1)

CPU = "cpu"


def stats_pair(mins, maxs, nulls, kinds):
    P, C = mins.shape
    rows = np.full(P, 4, dtype=np.int64)
    rcols = [RM.ColumnMeta(f"c{i}", k, np.array(["a", "b"]) if k == "str"
                           else None) for i, k in enumerate(kinds)]
    tcols = [TM.ColumnMeta(f"c{i}", k, np.array(["a", "b"]) if k == "str"
                           else None) for i, k in enumerate(kinds)]
    return (RM.PartitionStats(rcols, mins.copy(), maxs.copy(), nulls.copy(),
                              rows.copy()),
            TM.PartitionStats(tcols, mins.copy(), maxs.copy(), nulls.copy(),
                              rows.copy()))


def awkward_stats(seed, P=37):
    """Stats that exercise every cast rule: ints past 2**24 (inexact in
    f32), fractional floats, +-inf, all-null empty intervals, nulls."""
    rng = np.random.default_rng(seed)
    C = 4
    mins = np.empty((P, C))
    mins[:, 0] = rng.integers(-1000, 1000, P)
    mins[:, 1] = rng.integers(2 ** 24, 2 ** 30, P)
    mins[:, 2] = rng.normal(size=P)
    mins[:, 3] = rng.integers(0, 2, P)
    maxs = mins + np.abs(rng.normal(size=(P, C))) * [10, 1000, 1, 0]
    maxs[:, [0, 1, 3]] = np.ceil(maxs[:, [0, 1, 3]])
    mins[3, 2], maxs[5, 2] = -np.inf, np.inf
    mins[7], maxs[7] = np.inf, -np.inf              # all-null partition
    nulls = (rng.random((P, C)) < 0.2).astype(np.int64)
    return stats_pair(mins, maxs, nulls, ["int", "int", "float", "str"])


def host_planes(dstats):
    return [TD.to_host(a) for a in dstats.planes]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("capacity", [None, "plane", 200])
def test_stage_planes_and_checksum_equal_reference(seed, capacity):
    rs, ts = awkward_stats(seed)
    cap = (None if capacity is None
           else TD.plane_capacity(ts.num_partitions) if capacity == "plane"
           else capacity)
    rd = RD.DeviceStats.stage(rs, "t", 3, capacity=cap)
    td = TD.DeviceStats.stage(ts, "t", 3, capacity=cap, device=CPU)
    assert td.capacity == rd.capacity and td.num_partitions == 37
    for got, want in zip(host_planes(td), rd.planes):
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(td.integral, rd.integral)
    assert td.checksum == rd.checksum
    assert TD.plane_checksum(td.planes) == td.checksum
    assert td.epoch.capacity == rd.epoch.capacity
    assert td.nbytes == rd.nbytes
    if td.capacity > 37:                        # sentinel tail
        mins, maxs, dem = host_planes(td)
        assert (mins[:, 37:] == TD._F32_MAX).all()
        assert (maxs[:, 37:] == -TD._F32_MAX).all()
        assert (dem[:, 37:] == 1.0).all()


@pytest.mark.parametrize("fn", ["round_down_f32", "round_up_f32"])
def test_widening_rounding_equals_reference(fn):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=200) * 1e9, [np.inf, -np.inf, 0.0,
                                                      2.0 ** 24 + 1, 1e-300]])
    got, want = getattr(TD, fn)(x), getattr(RD, fn)(x)
    assert got.tobytes() == np.asarray(want).tobytes()


def test_bound_casts_and_snapping_equal_reference():
    rng = np.random.default_rng(1)
    lo = np.concatenate([rng.normal(size=50) * 1e8, [-np.inf, np.inf, 3.5]])
    hi = lo + np.abs(rng.normal(size=lo.size))
    integral = rng.random(lo.size) < 0.5
    for a, b in zip(TD.snap_bounds_integral(lo, hi, integral),
                    RD.snap_bounds_integral(lo, hi, integral)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TD.cast_bounds_f32(lo, hi), RD.cast_bounds_f32(lo, hi)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for p in (0, 1, 7, 8, 100, 4096, 1 << 20):
        assert TD.plane_capacity(p) == RD.plane_capacity(p)


def _tables(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        raw, _, nulls = table_raw(rng, n=64)
        out.append(both_tables(raw, 8, nulls, name=f"t{i}")[1])
    return out


def test_pinned_planes_never_evicted_under_budget():
    a, b, c = _tables(3)
    probe = TD.DeviceStatsCache(device=CPU)
    one = probe.get(a).nbytes
    cache = TD.DeviceStatsCache(budget_bytes=int(1.5 * one), device=CPU)
    with cache.pin_scope():
        ea = cache.get(a)
        eb = cache.get(b)            # admit under pressure: `a` is pinned
        assert (a.name, a.stats.uid) in cache.entries
        assert (b.name, b.stats.uid) in cache.entries
        assert cache.memory.pin_denied >= 1
        assert cache.memory.evictions == 0
        assert ea.planes[0] is cache.entries[(a.name, a.stats.uid)].planes[0]
        del eb
    # scope exit reclaims back under budget; the LRU unpinned plane goes
    assert cache.memory.bytes_in_use <= cache.memory.budget_bytes
    assert cache.memory.evictions == 1
    assert (a.name, a.stats.uid) not in cache.entries
    cache.get(c)                     # c evicts b (unpinned, LRU)
    assert (b.name, b.stats.uid) not in cache.entries
    cache.get(a)                     # re-admit an evicted key: a storm
    assert cache.memory.restage_storms == 1


@pytest.mark.parametrize("dml", ["append", "drop", "update", "notify"])
def test_version_bump_restages(dml):
    """After a version bump the plane equals a fresh stage byte for byte:
    replayed from the delta log for the table's own DML, restaged in full
    for a bare ``TableVersion`` bump."""
    (t,) = _tables(1, seed=3)
    cache = TD.DeviceStatsCache(device=CPU)
    first = cache.get(t)
    assert cache.get(t) is first and cache.hits == 1
    tv = None
    if dml == "append":
        t.append_partitions({"x": np.arange(12, dtype=np.int64),
                             "y": np.arange(12, dtype=np.int64),
                             "s": np.array(["Bear"] * 12)},
                            rows_per_partition=4)
    elif dml == "drop":
        t.drop_partitions([0, 3])
    elif dml == "update":
        t.update_column("y", np.arange(t.num_rows) * 3)
    else:
        from repro_torch.core.predicate_cache import TableVersion
        tv = TableVersion(t.num_partitions)
        cache.get(t, tv)
        tv.version += 1
    again = cache.get(t, tv)
    if dml == "notify":
        # a TableVersion bump with no delta log behind it restages in full
        assert again is not first
        assert cache.full_restages == 1 and cache.delta_stages == 0
    else:
        # the table's own DML replays into the resident plane in place
        assert again is first
        assert cache.full_restages == 0 and cache.delta_stages == 1
    fresh = TD.DeviceStats.stage(t.stats, t.name, t.version,
                                 capacity=TD.plane_capacity(t.num_partitions),
                                 live=t.live, device=CPU)
    for x, y in zip(host_planes(again), host_planes(fresh)):
        assert x.tobytes() == y.tobytes()
    assert again.num_partitions == t.num_partitions
    assert again.live_count == t.num_live_partitions
    assert again.checksum == fresh.checksum


def test_torn_plane_is_quarantined_and_restaged():
    (t,) = _tables(1, seed=4)
    inj = FaultInjector(seed=0).add("stage.stat", kind="corrupt", times=1)
    cache = TD.DeviceStatsCache(device=CPU, fault_injector=inj,
                                integrity_sample=1)
    e = cache.get(t)
    assert cache.integrity["checksum_failures"] == 1
    assert cache.integrity["quarantines"] == 1
    assert TD.plane_checksum(e.planes) == e.checksum
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in e.planes)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (t,) = _tables(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.DeviceStatsCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.DeviceStats.stage(t.stats)
    assert TD.resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# the runtime techniques' planes: join-key, enumeration, block-top-k
# ---------------------------------------------------------------------------

def _runtime_tables(seed, wide_keys=False):
    """A reference table and its port twin: int keys (optionally past
    int32), a float column, an int column with nulls and a dictionary
    column; some partitions dropped so the planes carry sentinels."""
    from repro.data.table import Table as RTable
    from repro_torch.data.table import Table as TTable
    rng = np.random.default_rng(seed)
    n = 900
    key = np.sort(rng.integers(-3000, 3000, n))
    if wide_keys:
        key[-50:] += 2 ** 33
    raw = {"k": key.astype(np.int64),
           "f": rng.normal(size=n) * 1e3,
           "v": rng.integers(-10_000, 10_000, n).astype(np.int64),
           "s": np.array(["ok-1", "warn-2", "err-3"])[rng.integers(0, 3, n)]}
    nulls = {"v": rng.random(n) < 0.1, "f": rng.random(n) < 0.05}
    rt = RTable.build("rt", raw, 30, nulls)
    rt.drop_partitions([1, 4, 17])
    tt = TTable.from_arrays(rt.name, rt.columns, rt.data, rt.nulls,
                            rt.part_bounds)
    tt.drop_partitions([1, 4, 17])
    return rt, tt


def _planes_of(cache, family, table, col, desc=True):
    if family == "join_key":
        return cache.join_key_plane(table, col), ()
    if family == "enum":
        *arrays, wmax, ok = cache.enum_plane(table, col)
        return arrays, (wmax, ok)
    return (cache.block_topk_plane(table, col, desc),), ()


STORE = {"join_key": "key_planes", "enum": "enum_planes",
         "block_topk": "topk_planes"}


@pytest.mark.parametrize("wide_keys", [False, True])
@pytest.mark.parametrize("family,col,desc", [
    ("join_key", "k", True), ("join_key", "f", True), ("join_key", "s", True),
    ("enum", "k", True), ("enum", "v", True), ("enum", "s", True),
    ("block_topk", "v", True), ("block_topk", "v", False),
    ("block_topk", "f", True), ("block_topk", "k", False),
])
def test_runtime_planes_equal_reference_byte_for_byte(family, col, desc,
                                                      wide_keys):
    """Widening, clamping, the empty-interval and width-0 sentinels, the
    -inf padding and rounding of the signed block-top-k rows, the
    capacity tail and the checksum stamp: all as in the reference."""
    rt, tt = _runtime_tables(5, wide_keys)
    rcache = RD.DeviceStatsCache()
    tcache = TD.DeviceStatsCache(device=CPU)
    (r_arrays, r_meta) = _planes_of(rcache, family, rt, col, desc)
    (t_arrays, t_meta) = _planes_of(tcache, family, tt, col, desc)
    assert t_meta == r_meta
    for got, want in zip(t_arrays, r_arrays):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got, want = TD.to_host(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    rstore = getattr(rcache, STORE[family])
    tstore = getattr(tcache, STORE[family])
    (rkey, re), = rstore.items()
    (tkey, te), = tstore.items()
    assert te.meta["checksum"] == re.meta["checksum"]
    assert TD.plane_checksum(te.arrays) == te.meta["checksum"]
    P = tt.num_partitions
    if family == "join_key":
        pmin, pmax = (TD.to_host(a) for a in t_arrays)
        assert (pmin[[1, 4, 17]] == TD._F32_MAX).all()
        assert (pmin[P:] == TD._F32_MAX).all() and (pmax[P:] == -TD._F32_MAX).all()
    elif family == "enum":
        width = TD.to_host(t_arrays[1])
        assert (width[[1, 4, 17]] == 0).all() and (width[P:] == 0).all()
    else:
        rows = TD.to_host(t_arrays[0])
        assert rows.shape[1] == TD.KPLANE
        assert (rows[[1, 4, 17]] == -np.inf).all() and (rows[P:] == -np.inf).all()


@pytest.mark.parametrize("family", ["join_key", "enum", "block_topk"])
def test_runtime_plane_hit_and_version_bump_restage(family):
    _rt, tt = _runtime_tables(6)
    cache = TD.DeviceStatsCache(device=CPU)
    first, _ = _planes_of(cache, family, tt, "v")
    again, _ = _planes_of(cache, family, tt, "v")
    assert all(a is b for a, b in zip(first, again)) and cache.plane_hits == 1
    before = [TD.to_host(a).copy() for a in first]
    tt.append_partitions({"k": np.arange(30, dtype=np.int64),
                          "f": np.zeros(30), "v": np.arange(30) * 7,
                          "s": np.array(["ok-1"] * 30)}, rows_per_partition=30)
    after, _ = _planes_of(cache, family, tt, "v")
    # an in-capacity append replays into a copy of the resident tensors
    # and swaps it in: the tensors handed out before stay as they were
    assert cache.full_restages == 0 and cache.delta_stages == 1
    assert all(a is not b for a, b in zip(first, after))
    assert all(np.array_equal(TD.to_host(a), b)
               for a, b in zip(first, before))
    fresh, _ = _planes_of(TD.DeviceStatsCache(device=CPU), family, tt, "v")
    for x, y in zip(after, fresh):
        assert TD.to_host(x).tobytes() == TD.to_host(y).tobytes()


@pytest.mark.parametrize("family", ["join_key", "enum", "block_topk"])
def test_torn_runtime_plane_is_quarantined_and_restaged(family):
    _rt, tt = _runtime_tables(7)
    inj = FaultInjector(seed=0).add(f"stage.{family}", kind="corrupt",
                                    times=1)
    cache = TD.DeviceStatsCache(device=CPU, fault_injector=inj,
                                integrity_sample=1)
    arrays, _ = _planes_of(cache, family, tt, "k")
    assert cache.integrity["checksum_failures"] == 1
    assert cache.integrity["quarantines"] == 1
    (e,) = getattr(cache, STORE[family]).values()
    assert TD.plane_checksum(arrays) == e.meta["checksum"]
    # a second read verifies the resident plane and serves it
    again, _ = _planes_of(cache, family, tt, "k")
    assert all(a is b for a, b in zip(arrays, again))
    assert cache.integrity["checksum_failures"] == 1


@pytest.mark.parametrize("family", ["join_key", "enum", "block_topk"])
def test_persistently_torn_runtime_plane_raises_integrity_error(family):
    _rt, tt = _runtime_tables(8)
    inj = FaultInjector(seed=0).add(f"stage.{family}", kind="corrupt")
    cache = TD.DeviceStatsCache(device=CPU, fault_injector=inj,
                                integrity_sample=1)
    with pytest.raises(TD.PlaneIntegrityError):
        _planes_of(cache, family, tt, "k")
    assert not getattr(cache, STORE[family])
    assert cache.memory.bytes_in_use == 0


def test_runtime_planes_pinned_under_budget_and_accounted():
    """All four families share one byte budget: pinned planes stay
    resident, scope exit reclaims back under it."""
    _rt, a = _runtime_tables(9)
    _rt, b = _runtime_tables(10)
    b.name = "rt2"
    probe = TD.DeviceStatsCache(device=CPU)
    one = TD.to_host(probe.block_topk_plane(a, "v", True)).nbytes
    cache = TD.DeviceStatsCache(budget_bytes=int(1.5 * one), device=CPU)
    with cache.pin_scope():
        cache.block_topk_plane(a, "v", True)
        cache.block_topk_plane(b, "v", True)    # over budget: a is pinned
        cache.join_key_plane(a, "k")
        assert len(cache.topk_planes) == 2 and len(cache.key_planes) == 1
        assert cache.memory.evictions == 0 and cache.memory.pin_denied >= 1
    assert cache.memory.bytes_in_use <= cache.memory.budget_bytes
    assert cache.memory.evictions >= 1
    assert cache.resident_bytes == cache.memory.bytes_in_use
