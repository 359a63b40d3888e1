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
    assert again is not first
    assert cache.full_restages == 1
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
