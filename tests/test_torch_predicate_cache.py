"""The port's Sec. 8.2 top-k predicate cache against the JAX package's.

Each case of the reference suite's ``TestPredicateCache`` runs as one
scenario on both packages (the same numpy-seeded tables, DML and keys);
every lookup, every top-k value and the hit / miss counts must be equal.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core import predicate_cache as RC
from repro.core.metadata import ScanSet as RScanSet
from repro.core.prune_topk import run_topk as r_run_topk
from repro.core.prune_topk import topk_oracle as r_oracle
from repro.data.table import Table as RTable

from repro_torch.core import expr as TE
from repro_torch.core import predicate_cache as TC
from repro_torch.core.metadata import ScanSet as TScanSet
from repro_torch.core.prune_topk import run_topk as t_run_topk
from repro_torch.core.prune_topk import topk_oracle as t_oracle
from repro_torch.data.table import Table as TTable

torch.set_num_threads(1)

REF = types.SimpleNamespace(E=RE, C=RC, ScanSet=RScanSet, run_topk=r_run_topk,
                            oracle=r_oracle, Table=RTable)
PORT = types.SimpleNamespace(E=TE, C=TC, ScanSet=TScanSet,
                             run_topk=t_run_topk, oracle=t_oracle,
                             Table=TTable)


def clustered_table(pk, n=4000, rows_pp=100, seed=0):
    rng = np.random.default_rng(seed)
    return pk.Table.build(
        "t", {"v": rng.permutation(np.arange(n)).astype(np.int64),
              "w": np.sort(rng.integers(0, 10_000, size=n)).astype(np.int64)},
        rows_per_partition=rows_pp)


def _topk(pk, tbl, k=5):
    return pk.run_topk(tbl, pk.ScanSet.full(tbl.num_partitions), "v", k,
                       strategy="sort")


def _ids(x):
    return None if x is None else np.asarray(x).tolist()


def contributing_partitions_suffice(pk):
    tbl = clustered_table(pk)
    res = _topk(pk, tbl)
    cached = pk.run_topk(tbl, pk.ScanSet(res.contributing), "v", 5,
                         strategy="none")
    assert np.array_equal(np.sort(cached.values),
                          np.sort(pk.oracle(tbl, "v", 5)))
    return [_ids(res.contributing), _ids(res.sources), _ids(cached.values)]


def cache_hit_scans_fewer_partitions(pk):
    tbl = clustered_table(pk)
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(tbl.num_partitions)
    key = pk.C.plan_key("t", None, "v", True, 5)
    first = _topk(pk, tbl)
    cache.record(key, first.contributing, tv)
    hit = cache.lookup(key, tv)
    assert hit is not None and len(hit) <= len(first.scanned)
    cached = pk.run_topk(tbl, pk.ScanSet(hit), "v", 5, strategy="none")
    assert np.array_equal(np.sort(cached.values), np.sort(first.values))
    return [_ids(hit), _ids(cached.values), cache.hits, cache.misses,
            cache.hit_rate]


def insert_is_safe(pk):
    tbl = clustered_table(pk, n=1000, rows_pp=100)
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(tbl.num_partitions)
    key = pk.C.plan_key("t", None, "v", True, 3)
    cache.record(key, _topk(pk, tbl, k=3).contributing, tv)
    new_v = np.concatenate([tbl.data["v"], np.arange(5000, 5100)])
    new_w = np.concatenate([tbl.data["w"], np.zeros(100)])
    tbl2 = pk.Table.build("t", {"v": new_v.astype(np.int64),
                                "w": new_w.astype(np.int64)},
                          rows_per_partition=100)
    tv.insert_partitions(tbl2.num_partitions - tbl.num_partitions)
    hit = cache.lookup(key, tv)
    res = pk.run_topk(tbl2, pk.ScanSet(hit), "v", 3, strategy="none")
    assert np.array_equal(np.sort(res.values),
                          np.sort(pk.oracle(tbl2, "v", 3)))
    return [_ids(hit), _ids(res.values)]


def delete_and_order_update_invalidate(pk):
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(10)
    key = pk.C.plan_key("t", None, "v", True, 3)
    out = []
    cache.record(key, np.array([1, 2]), tv)
    cache.on_update("t", "w")
    out.append(_ids(cache.lookup(key, tv)))
    cache.on_update("t", "v")
    out.append(_ids(cache.lookup(key, tv)))
    cache.record(key, np.array([1, 2]), tv)
    cache.on_insert("t")
    out.append(_ids(cache.lookup(key, tv)))
    cache.on_delete("t")
    out.append(_ids(cache.lookup(key, tv)))
    assert out[0] is not None and out[1] is None and out[3] is None
    return out + [cache.hits, cache.misses, cache.hit_rate]


def lru_eviction(pk):
    cache = pk.C.PredicateCache(max_entries=2)
    tv = pk.C.TableVersion(4)
    for i in range(3):
        cache.record(pk.C.plan_key("t", None, "v", True, i), np.array([i]),
                     tv)
    assert len(cache.entries) == 2
    miss = cache.lookup(pk.C.plan_key("t", None, "v", True, 0), tv)
    assert miss is None
    return [list(cache.entries), cache.hits, cache.misses]


def plan_key_canonicalizes_equivalent_predicates(pk):
    E, key = pk.E, pk.C.plan_key
    p1 = (E.col("v") >= 100) & (E.col("w") < 500)
    p2 = (E.col("w") < 500.0) & (E.col("v") >= 100.0)
    assert key("t", p1, "v", True, 5) == key("t", p2, "v", True, 5)
    assert key("t", p1, "v", True, 5) != key(
        "t", (E.col("v") >= 101) & (E.col("w") < 500), "v", True, 5)
    return [key("t", p1, "v", True, 5), key("t", p2, "v", False, 3),
            key("t", E.And((p1, E.col("v") >= 100)), "v", True, 5),
            key("t", E.col("v") == (2 ** 53 + 1), "v", True, 1),
            key("t", E.col("v") == float(2 ** 53), "v", True, 1)]


def update_of_predicate_column_invalidates(pk):
    tbl = pk.Table.build(
        "t", {"v": np.array([0, 1, 10, 11, 20, 21, 30, 31], np.int64),
              "w": np.array([1, 1, 1, 1, 0, 0, 0, 0], np.int64)},
        rows_per_partition=2)
    pred = pk.E.col("w") >= 1
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(tbl.num_partitions)
    key = pk.C.plan_key("t", pred, "v", True, 2)
    cache.record(key, np.array([1]), tv, pred=pred)
    tbl.update_column("w", np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int64))
    cache.on_update("t", "w")
    assert cache.lookup(key, tv) is None
    return [cache.entries.get(key), cache.misses]


def drop_then_append_freshness_uses_delta_log(pk):
    rng = np.random.default_rng(3)

    def cols(n):
        return {"v": rng.integers(0, 100, n).astype(np.int64),
                "w": rng.integers(0, 100, n).astype(np.int64)}
    tbl = pk.Table.build("t", cols(100), rows_per_partition=10)
    pred = pk.E.col("w") >= 0
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(tbl.num_partitions)
    key = pk.C.plan_key("t", pred, "v", True, 3)
    cache.record(key, np.array([1, 2, 5]), tv, pred=pred, table=tbl)
    tbl.drop_partitions(np.array([2, 7]))
    tv.version += 1
    tbl.append_partitions(cols(20), rows_per_partition=10)
    tv.insert_partitions(2)
    hit = cache.lookup(key, tv, table=tbl)
    assert 2 not in hit and 7 not in hit
    assert {1, 5, 10, 11} <= set(hit.tolist())
    n = int(np.diff(tbl.part_bounds)[1])
    tbl.rewrite_partitions([1], cols(n))
    tv.version += 1
    after = cache.lookup(key, tv, table=tbl)
    assert after is None
    return [_ids(hit), after, cache.hits, cache.misses]


def delta_log_update_of_predicate_column_misses(pk):
    rng = np.random.default_rng(4)
    tbl = pk.Table.build(
        "t", {"v": rng.integers(0, 100, 40).astype(np.int64),
              "w": rng.integers(0, 100, 40).astype(np.int64)},
        rows_per_partition=10)
    pred = pk.E.col("w") >= 50
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(tbl.num_partitions)
    key = pk.C.plan_key("t", pred, "v", True, 3)
    cache.record(key, np.array([0, 2]), tv, pred=pred, table=tbl)
    first = cache.lookup(key, tv, table=tbl)
    tbl.update_column("v", rng.integers(0, 100, 40).astype(np.int64))
    order_update = cache.lookup(key, tv, table=tbl)
    cache.record(key, np.array([0, 2]), tv, pred=pred, table=tbl)
    tbl.update_column("w", rng.integers(0, 100, 40).astype(np.int64))
    tv.version += 1
    pred_update = cache.lookup(key, tv, table=tbl)
    assert first is not None and order_update is None and pred_update is None
    return [_ids(first), order_update, pred_update, cache.hits,
            cache.misses, cache.hit_rate]


def shrunken_legacy_count_misses(pk):
    """The legacy ``TableVersion`` path: a count below the recorded one
    misses (and drops the entry) instead of resurrecting ids."""
    cache = pk.C.PredicateCache()
    tv = pk.C.TableVersion(8)
    key = pk.C.plan_key("t", None, "v", True, 2)
    cache.record(key, np.array([3, 4]), tv)
    tv.num_partitions = 6
    gone = cache.lookup(key, tv)
    tv.num_partitions = 10
    return [gone, key in cache.entries, cache.misses]


SCENARIOS = [contributing_partitions_suffice, cache_hit_scans_fewer_partitions,
             insert_is_safe, delete_and_order_update_invalidate, lru_eviction,
             plan_key_canonicalizes_equivalent_predicates,
             update_of_predicate_column_invalidates,
             drop_then_append_freshness_uses_delta_log,
             delta_log_update_of_predicate_column_misses,
             shrunken_legacy_count_misses]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_scenario_equals_reference(scenario):
    assert scenario(PORT) == scenario(REF)


def test_record_keeps_entry_fields_of_reference():
    rng = np.random.default_rng(8)
    raw = {"v": rng.integers(0, 100, 60).astype(np.int64),
           "w": rng.integers(0, 100, 60).astype(np.int64)}
    out = []
    for pk in (PORT, REF):
        tbl = pk.Table.build("t", raw, rows_per_partition=10)
        cache = pk.C.PredicateCache()
        pred = (pk.E.col("w") >= 3) & (pk.E.col("v") < 90)
        cache.record(pk.C.plan_key("t", pred, "v", False, 4),
                     [5, 1, 3], pk.C.TableVersion(6), pred=pred, table=tbl)
        (e,) = cache.entries.values()
        out.append((e.part_ids.dtype, e.part_ids.tolist(), e.version,
                    e.num_partitions, sorted(e.pred_cols), e.has_delta_log))
    assert out[0] == out[1]
