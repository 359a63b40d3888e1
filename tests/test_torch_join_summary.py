"""The JOIN build summary of the port's card path against the JAX
package's ``summarize_build``.

``ops.summarize_build_batched_device`` runs ``bloom_build``'s plain
versions on the CPU (its CUDA kernels are held to them on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 14), and
``PruningService.join_summary_batch`` routes build sides through it.
Every field must equal the reference's: min, max, count, size, the
sorted distinct keys and their dtype, the Bloom filter's block count and
its words bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from repro.core.flow import PruningPipeline as RPipeline
from repro.core.flow import Query as RQuery
from repro.core.flow import TableScanSpec as RSpec
from repro.core import expr as RE
from repro.core.prune_join import summarize_build as ref_summarize
from repro.serve.prune_service import PruningService as RService

from repro_torch.core import expr as TE
from repro_torch.core.flow import JoinSpec as TJoin
from repro_torch.core.flow import PruningPipeline as TPipeline
from repro_torch.core.flow import Query as TQuery
from repro_torch.core.flow import TableScanSpec as TSpec
from repro_torch.core.prune_join import BLOCK_WORDS, bloom_blocks
from repro_torch.kernels import bloom_build as bb
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError
from repro_torch.serve import prune_service as ps
from repro_torch.serve.prune_service import PruningService as TService
from repro_torch.serve.resilience import FaultInjector
from repro.core.flow import JoinSpec as RJoin

from test_torch_engine import (_assert_reports_equal, _engine_tables,
                               _mixed_queries, _mixed_workload)

torch.set_num_threads(1)

LIMIT = 4096
I64 = np.iinfo(np.int64)


def _case(name: str):
    """(keys, null mask or None) of one named build side; ``encoded_*``
    is a case's keys as a table holds an integer column, in float64."""
    if name.startswith("encoded_"):
        keys, mask = _case(name[len("encoded_"):])
        return keys.astype(np.float64), mask
    rng = np.random.default_rng(sum(map(ord, name)))
    ext = np.array([I64.min, I64.max, -1, 0, 1, I64.min + 1, I64.max - 1],
                   dtype=np.int64)
    if name == "empty":
        return np.zeros(0, dtype=np.int64), None
    if name == "all_null":
        return rng.integers(0, 50, 300).astype(np.int64), np.ones(300, bool)
    if name in ("ndv_at_limit", "ndv_over_limit"):
        ndv = LIMIT + (name == "ndv_over_limit")
        keys = np.repeat(rng.choice(10 ** 12, ndv, replace=False), 2)
        return rng.permutation(keys).astype(np.int64), None
    if name == "duplicates":
        return rng.integers(0, 3000, 100_000).astype(np.int64), None
    if name == "sparse":
        return rng.integers(1, 6_000_000_001, 60_000), None
    if name == "negative_extreme":
        return np.concatenate([np.tile(ext, 30),
                               -rng.integers(1, 2 ** 62, 9_000)]), None
    if name == "extreme_few":
        mask = np.zeros(7 * 20, dtype=bool)
        mask[::5] = True                    # nulls among them
        return np.tile(ext, 20), mask
    if name == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, 20_000).astype(
            np.int32), None
    if name == "q3":
        keys = np.unique(rng.integers(1, 6_000_000_001, 252_000))
        return rng.permutation(keys)[:250_000].astype(np.int64), None
    raise KeyError(name)


CASES = ["empty", "all_null", "ndv_at_limit", "ndv_over_limit",
         "duplicates", "sparse", "negative_extreme", "extreme_few", "int32",
         "q3", "encoded_duplicates", "encoded_ndv_over_limit", "encoded_q3"]


def _assert_summary_equal(got, want):
    for f in ("min", "max", "count", "size_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.distinct is None) == (want.distinct is None)
    assert (got.bloom is None) == (want.bloom is None)
    if want.distinct is not None:
        assert got.distinct.dtype == want.distinct.dtype
        np.testing.assert_array_equal(got.distinct, want.distinct)
    if want.bloom is not None:
        assert got.bloom.n_blocks == want.bloom.n_blocks
        assert got.bloom.words.dtype == want.bloom.words.dtype
        np.testing.assert_array_equal(got.bloom.words, want.bloom.words)


@pytest.mark.parametrize("route", ["plain", "service"])
@pytest.mark.parametrize("case", CASES)
def test_summary_equals_reference_field_for_field(case, route):
    keys, mask = _case(case)
    want = ref_summarize(keys, mask, ndv_limit=LIMIT)
    side = keys if mask is None else keys[~mask]
    before = bb.bloom_build.launches
    if route == "plain":
        got = ops.summarize_build_batched_device([side], LIMIT,
                                                 device="cpu")[0]
    else:
        svc = TService(device="cpu")
        got = svc.join_summary_batch([side], LIMIT)[0]
        assert svc.counters.join_summary == dict(device=1, host=0)
    assert bb.bloom_build.launches == before      # the plain versions
    _assert_summary_equal(got, want)


def test_one_call_summarises_every_build_side_as_alone():
    sides, wants = [], []
    for case in CASES:
        keys, mask = _case(case)
        sides.append(keys if mask is None else keys[~mask])
        wants.append(ref_summarize(keys, mask, ndv_limit=LIMIT))
    got = ops.summarize_build_batched_device(sides, LIMIT, device="cpu")
    for g, w in zip(got, wants):
        _assert_summary_equal(g, w)


@pytest.mark.parametrize("ndv_limit", [16, 100])
def test_a_lower_ndv_limit_gives_the_reference_filters(ndv_limit):
    """Build sides on both sides of a small limit, in one call."""
    rng = np.random.default_rng(ndv_limit)
    sides = [rng.integers(0, n, 3 * n).astype(np.int64)
             for n in (1, ndv_limit, ndv_limit + 1, 40 * ndv_limit)]
    got = ops.summarize_build_batched_device(sides, ndv_limit, device="cpu")
    for g, keys in zip(got, sides):
        _assert_summary_equal(g, ref_summarize(keys, ndv_limit=ndv_limit))


def test_plan_lays_out_hash_sets_and_filters():
    plan = bb.plan_builds([1, 5000, 4096, 250_000], LIMIT, 16)
    assert plan.dtype == np.int64 and plan.shape == (4, bb.COLS)
    np.testing.assert_array_equal(plan[:, 1], [1, 5000, 4096, 250_000])
    np.testing.assert_array_equal(plan[:, 0], [0, 1, 5001, 9097])
    caps = plan[:, 3]
    assert all(c & (c - 1) == 0 and c >= 2 * n for c, n in zip(caps,
                                                              plan[:, 1]))
    np.testing.assert_array_equal(plan[:, 2], np.cumsum(caps) - caps)
    # words only where the count can pass the limit, as many as it needs
    np.testing.assert_array_equal(
        plan[:, 5], [0, bloom_blocks(5000) * BLOCK_WORDS, 0,
                     bloom_blocks(250_000) * BLOCK_WORDS])
    np.testing.assert_array_equal(plan[:, 4], np.cumsum(plan[:, 5])
                                  - plan[:, 5])


def test_dedupe_plain_version_counts_the_key_minus_one():
    keys = torch.tensor([5, -1, 7, -1, I64.min, 5], dtype=torch.int64)
    plan = bb.plan_builds([4, 2], 3, 16)
    header, distinct = bb.dedupe_ref(keys, plan, 3)
    assert header[0, :5].tolist() == [3, -1, 7, 0, 1]
    assert distinct[0].tolist() == [-1, 5, 7]
    assert header[1, :5].tolist() == [2, I64.min, 5, 0, 0]
    # under a limit of 1 both segments take a filter of one 16-word block,
    # at most 4 bits a distinct key
    plan = bb.plan_builds([4, 2], 1, 16)
    header, _ = bb.dedupe_ref(keys, plan, 1)
    words = bb.bloom_set_ref(keys, plan, header, 1, 16)
    assert header[:, 3].tolist() == [1, 1] and words.dtype == torch.int32
    assert int(words.numel()) == int(plan[:, 5].sum()) == 2 * BLOCK_WORDS
    for seg, ndv in ((words[:BLOCK_WORDS], 3), (words[BLOCK_WORDS:], 2)):
        bits = sum(bin(w & 0xFFFFFFFF).count("1") for w in seg.tolist())
        assert 1 <= bits <= 4 * ndv


def test_wrappers_reject_what_the_kernels_do_not_take():
    for keys in (np.arange(4, dtype=np.uint64), np.ones(4, dtype=bool),
                 np.arange(4).reshape(2, 2)):
        with pytest.raises(KernelError):
            ops.summarize_build_batched_device([keys], device="cpu")
    plan = bb.plan_builds([3], LIMIT, 16)
    good = torch.from_numpy(np.concatenate([plan.reshape(-1),
                                            np.arange(3)]))
    bb.bloom_build(good, plan, LIMIT, 16)
    for staged, p in ((good[:-1], plan), (good.int(), plan),
                      (good, plan.astype(np.int32)),
                      (good, plan[:, :6].copy())):
        with pytest.raises(KernelError):
            bb.bloom_build(staged, p, LIMIT, 16)
    with pytest.raises(KernelError):
        bb.bloom_build(good, plan, 0, 16)


def _stats(kind, lo, hi):
    """A build table's metadata for ``summary_on_card``: one column's
    kind and its partitions' ranges."""
    return types.SimpleNamespace(
        column=lambda _c: types.SimpleNamespace(kind=kind),
        col_min=lambda _c: np.asarray(lo, dtype=np.float64),
        col_max=lambda _c: np.asarray(hi, dtype=np.float64))


MIN = ps.CARD_SUMMARY_MIN_KEYS
INTS = ("int", [0.0, 7.0], [5.0, 6e9])


@pytest.mark.parametrize("dtype,n,column,want", [
    (np.int64, MIN, INTS, True),
    (np.int32, 2 * MIN, ("float", [0.0], [1.0]), True),
    (np.int64, MIN - 1, INTS, False),
    (np.float64, MIN, INTS, True),          # an int column's encoded keys
    (np.float64, MIN, ("str", [0.0], [30.0]), True),
    (np.float64, MIN - 1, INTS, False),
    (np.float64, 2 * MIN, ("float", [0.0], [1.0]), False),
    # an all-null partition (lo > hi) bounds nothing
    (np.float64, MIN, ("int", [np.inf, -9e18], [-np.inf, 9e18]), True),
    (np.float64, MIN, ("int", [0.0, -2.0 ** 63], [1.0, 5.0]), True),
    (np.float64, MIN, ("int", [0.0], [2.0 ** 63]), False),
    (np.float64, MIN, ("int", [-1e19], [0.0]), False),
    (np.uint64, 2 * MIN, INTS, False),
    (np.bool_, 2 * MIN, INTS, False),
])
def test_routing_takes_large_integer_build_sides_on_a_cuda_service(
        dtype, n, column, want):
    keys = np.zeros(n, dtype=dtype)
    stats = _stats(*column)
    assert not TService(device="cpu").summary_on_card(keys, stats, "k")
    card = TService.__new__(TService)          # the rule, without a card
    card.device = torch.device("cuda")
    assert card.summary_on_card(keys, stats, "k") is want


# ---------------------------------------------------------------------------
# The JOIN stage through run_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_tables():
    return _engine_tables()


def _run(tables, workload, ndv_limit, routed, fault=False):
    """The port's run_batch on a CPU service, build sides routed through
    ``join_summary_batch`` where ``routed``, and the reference's."""
    ttabs = [t for _, t in tables]
    rtabs = [r for r, _ in tables]
    inj = (FaultInjector().add("launch.join_summary") if fault else None)
    svc = TService(device="cpu", fault_injector=inj)
    if routed:
        svc.summary_on_card = lambda *_a: True
    tq = _mixed_queries(workload, ttabs, TE, TQuery, TSpec, TJoin)
    got = svc.run_batch(tq, TPipeline(filter_mode="device", service=svc,
                                      join_ndv_limit=ndv_limit))
    rq = _mixed_queries(workload, rtabs, RE, RQuery, RSpec, RJoin)
    rsvc = RService(mode="ref")
    want = rsvc.run_batch(rq, RPipeline(filter_mode="device", service=rsvc,
                                        join_ndv_limit=ndv_limit))
    return svc, got, want


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("ndv_limit", [4096, 16])
def test_run_batch_reports_equal_the_reference(engine_tables, ndv_limit,
                                               routed):
    """A CPU service keeps the host summary (``routed=False``, the
    default) and gives the reference's ``TechniqueReport``s; routed
    through ``join_summary_batch`` the reports are the same."""
    workload = _mixed_workload(np.random.default_rng(7))
    svc, got, want = _run(engine_tables, workload, ndv_limit, routed)
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)
    assert got[0].counters["technique"] == want[0].counters["technique"]


def test_join_summary_counter_counts_summaries_not_launches(engine_tables):
    workload = _mixed_workload(np.random.default_rng(8))
    joins = sum(1 for w in workload if w[0] in (1, 3))
    plain, got_plain, _ = _run(engine_tables, workload, 16, routed=False)
    assert plain.counters.join_summary == dict(device=0, host=0)
    assert got_plain[0].counters["join_summary"] == dict(device=0, host=0)
    routed, got, want = _run(engine_tables, workload, 16, routed=True)
    assert routed.counters.join_summary == dict(device=joins, host=0)
    assert got[0].counters["join_summary"] == dict(device=joins, host=0)
    # one batched call for the batch's build sides, none of it a launch
    assert routed.counters.launches == plain.counters.launches
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)


def test_a_faulted_card_summary_goes_to_the_host_exactly(engine_tables):
    workload = _mixed_workload(np.random.default_rng(9))
    joins = sum(1 for w in workload if w[0] in (1, 3))
    svc, got, want = _run(engine_tables, workload, 16, routed=True,
                          fault=True)
    assert svc.counters.join_summary == dict(device=0, host=joins)
    res = got[0].counters["resilience"]
    assert res["demotions"].get("host_oracle", 0) >= 1
    for g, w in zip(got, want):
        _assert_reports_equal(g, w)


def test_single_query_pipeline_routes_through_its_service(engine_tables):
    workload = _mixed_workload(np.random.default_rng(10), n=8)
    ttabs = [t for _, t in engine_tables]
    rtabs = [r for r, _ in engine_tables]
    pipe = TPipeline(filter_mode="device", device="cpu", join_ndv_limit=16)
    svc = pipe.device_service()
    svc.summary_on_card = lambda *_a: True
    rpipe = RPipeline(filter_mode="device", service=RService(mode="ref"),
                      join_ndv_limit=16)
    for tq, rq in zip(
            _mixed_queries(workload, ttabs, TE, TQuery, TSpec, TJoin),
            _mixed_queries(workload, rtabs, RE, RQuery, RSpec, RJoin)):
        _assert_reports_equal(pipe.run(tq), rpipe.run(rq))
    joins = sum(1 for w in workload if w[0] in (1, 3))
    assert svc.counters.join_summary == dict(device=joins, host=0)
