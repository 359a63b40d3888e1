"""The port's per-query device path against the JAX package.

``ops.prune_ranges_device``, ``ops.join_overlap_device`` and
``ops.topk_boundary_device`` with their kernels' plain versions
(``ref.minmax_prune_ref``, ``ref.join_overlap_ref``,
``ref.topk_boundary_ref`` and ``ref.topk_boundary_prefix_ref``, and the
CUDA scan's tiled formulation ``ref.topk_boundary_tiled_ref``) against
the JAX package's jnp oracles and its Pallas kernels in interpret mode,
the f64 host engine and the port's batched path (row q of a batched
launch equals the per-query call for query q).  Verdicts, hits, skips and
heap values are compared exactly (tolerance 0).  Inputs come from numpy
seeds, drawn by the generators of ``test_torch_cuda.py``, which the card
tests share.  Shapes stay small, the Pallas block edges included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import expr as RE
from repro.core.prune_filter import extract_ranges as r_extract_ranges
from repro.data.table import Table as RTable
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.join_overlap import join_overlap as pallas_join_overlap
from repro.kernels.minmax_prune import minmax_prune as pallas_minmax_prune
from repro.kernels.topk_boundary import topk_boundary as pallas_topk_boundary

from repro_torch.core import device_stats as TD
from repro_torch.core import expr as TE
from repro_torch.core.metadata import ScanSet
from repro_torch.core.prune_filter import eval_ranges_tv, extract_ranges
from repro_torch.core.prune_topk import run_topk, topk_oracle
from repro_torch.data.table import Table as TTable
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_boundary as tb
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.join_overlap import join_overlap
from repro_torch.kernels.minmax_prune import minmax_prune
from repro_torch.kernels.topk_boundary import MAX_K_SCAN, topk_boundary

from test_torch_cuda import (clustered_keys, clustered_plane, overlap_problem,
                             range_problem, topk_problem, window_problem)

torch.set_num_threads(1)

CSRC = TD.__file__.replace("core/device_stats.py", "kernels/csrc")
NEG = float("-inf")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _table_pair(seed, n=400, rows_pp=10):
    """A reference table with int, nullable int, float and string columns
    (two all-null partitions of ``x``), and the port's copy of it."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-50, 50, n)
    if seed % 2:
        x = np.sort(x)
    nulls = {"x": rng.random(n) < 0.05}
    nulls["x"][:2 * rows_pp] = True
    rt = RTable.build("t", {
        "x": x.astype(np.int64),
        "y": rng.integers(0, 1000, n).astype(np.int64),
        "f": rng.normal(size=n) * 100.0,
        "s": np.array(["apple", "banana", "cherry", "date"])[
            rng.integers(0, 4, n)],
    }, rows_per_partition=rows_pp, nulls=nulls)
    tt = TTable.from_arrays(rt.name, rt.columns, rt.data, rt.nulls,
                            rt.part_bounds)
    return rt, tt


# predicates built the same way in both packages; "exact" ones lower to
# integral ranges, which the f32 path evaluates exactly like the f64 host
PREDS = [
    ("int_conj", True, lambda E: (E.col("x") >= -10) & (E.col("y") < 700)),
    ("int_eq", True, lambda E: E.col("x") == 3),
    ("str_prefix", True, lambda E: E.startswith(E.col("s"), "b")),
    ("float_inexact", False,
     lambda E: (E.col("f") > -1000.3) & (E.col("f") <= 1000.1)),
    ("three_cols", True, lambda E: (E.col("y") >= 100) & (E.col("y") <= 400)
     & (E.col("x") > -30)),
    ("true", True, lambda E: E.true()),
]


# ---------------------------------------------------------------------------
# minmax_prune and prune_ranges_device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,P,edges", [
    (1, 1, False), (3, 7, False), (1, 2048, False), (3, 2049, False),
    (2, 5000, False), (6, 300, False), (3, 2047, True), (70, 257, True),
])
def test_minmax_plain_version_equals_jnp_oracle_and_pallas_interpret(
        K, P, edges):
    rng = np.random.default_rng(K * 1000 + P)
    problem = range_problem(rng, K, P, edges)
    got = tref.minmax_prune_ref(*_t(*problem)).numpy()
    args = [jnp.asarray(a) for a in problem]
    oracle = np.asarray(rref.minmax_prune_ref(*args))
    pallas = np.asarray(pallas_minmax_prune(*args, interpret=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


def test_plain_versions_compare_denormals_as_ieee():
    """The plain versions keep IEEE f32 compares at denormals, as the CUDA
    kernels (built without flush-to-zero) do; XLA on the CPU flushes them
    to zero, so these cases are held to IEEE, not to the JAX package."""
    tiny = float(np.float32(1e-45))
    tv = tref.minmax_prune_ref(*_t(
        np.array([tiny], np.float32), np.array([1.0], np.float32),
        np.array([[-0.0, tiny]], np.float32),
        np.array([[0.0, 0.5]], np.float32), np.zeros((1, 2), np.float32)))
    np.testing.assert_array_equal(tv.numpy(), [0, 2])  # 0.0 < 1e-45: NO
    hit = tref.join_overlap_ref(*_t(np.array([-1e-45, 1e-45], np.float32),
                                    np.array([0.0, 1e-40], np.float32),
                                    np.array([1e-45], np.float32)))
    np.testing.assert_array_equal(hit.numpy(), [0, 1])
    rng = np.random.default_rng(7)
    problem = range_problem(rng, 4, 500, edges=True, denormals=True)
    got = tref.minmax_prune_ref(*_t(*problem)).numpy()
    lo, hi, mins, maxs, nullable = (a.astype(np.float64) for a in problem)
    empty = mins > maxs
    no = (maxs < lo[:, None]) | (mins > hi[:, None]) | empty
    full = (mins >= lo[:, None]) & (maxs <= hi[:, None]) & (nullable == 0) \
        & ~empty
    np.testing.assert_array_equal(
        got, np.where(no, 0, np.where(full, 2, 1)).min(axis=0))


def test_minmax_plain_version_chunks_long_conjunctions(monkeypatch):
    rng = np.random.default_rng(4)
    args = _t(*range_problem(rng, 300, 100, edges=True, denormals=True))
    want = tref.minmax_prune_ref(*args)
    monkeypatch.setattr(tref, "MINMAX_SLAB_ELEMS", 700)      # 7-row chunks
    assert torch.equal(tref.minmax_prune_ref(*args), want)


@pytest.mark.parametrize("name,exact,build", PREDS,
                         ids=[p[0] for p in PREDS])
@pytest.mark.parametrize("seed", [0, 1])
def test_prune_ranges_device_equals_reference_host_and_batched_row(
        seed, name, exact, build):
    rt, tt = _table_pair(seed)
    r_ranges = r_extract_ranges(build(RE), rt.stats)
    ranges = extract_ranges(build(TE), tt.stats)
    assert ranges == r_ranges
    assert ranges is not None
    got = tops.prune_ranges_device(ranges, tt.stats, mode="torch",
                                   device="cpu")
    for mode in ("ref", "interpret"):
        want = rops.prune_ranges_device(r_ranges, rt.stats, mode=mode)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the port's batched row for the same ranges
    dstats = TD.DeviceStats.stage(tt.stats, device="cpu")
    row = tops.prune_ranges_batched_device([ranges], dstats, mode="torch")[0]
    np.testing.assert_array_equal(got, row)
    # the f64 host oracle: exact on integral ranges, never a false NO or
    # FULL on inexact float bounds
    host = eval_ranges_tv(ranges, tt.stats)
    if exact:
        np.testing.assert_array_equal(got, host)
    else:
        assert ((got == 0) <= (host == 0)).all()
        assert ((got == 2) <= (host == 2)).all()
        assert (got != host).any()          # FULL demoted somewhere


def test_empty_conjunction_is_full_without_a_launch():
    _rt, tt = _table_pair(2)
    before = minmax_prune.launches
    tv = tops.prune_ranges_device([], tt.stats, device="cpu")
    assert tv.dtype == np.int8 and (tv == 2).all()
    assert tv.shape == (tt.num_partitions,)
    assert minmax_prune.launches == before


@pytest.mark.parametrize("seed", range(3))
def test_stage_ranges_equals_reference_byte_for_byte(seed):
    rt, tt = _table_pair(seed)
    rng = np.random.default_rng(seed)
    ranges = [(int(rng.integers(0, 3)), float(rng.integers(-60, 0)) + 0.5,
               float(rng.integers(0, 900)) + 0.25) for _ in range(4)]
    got = tops.stage_ranges(ranges, tt.stats, device="cpu")
    want = rops.stage_ranges(ranges, rt.stats)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------------------------------
# join_overlap and join_overlap_device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,D,edges", [
    (1, 1, False), (1024, 2048, False), (1025, 2049, False), (3000, 10, False),
    (400, 500, False), (37, 5, True), (2047, 300, True),
])
def test_join_plain_version_equals_jnp_oracle_pallas_and_brute_force(
        P, D, edges):
    rng = np.random.default_rng(P + D)
    pmin, pmax, distinct = overlap_problem(rng, P, D, edges)
    got = tref.join_overlap_ref(*_t(pmin, pmax, distinct)).numpy()
    args = [jnp.asarray(a) for a in (pmin, pmax, distinct)]
    oracle = np.asarray(rref.join_overlap_ref(*args))
    pallas = np.asarray(pallas_join_overlap(*args, interpret=True))
    brute = np.array([((distinct >= lo) & (distinct <= hi)).any()
                      for lo, hi in zip(pmin, pmax)], dtype=np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, brute)


@pytest.mark.parametrize("key_col", ["x", "y", "f"])
@pytest.mark.parametrize("seed", [0, 1])
def test_join_overlap_device_equals_reference_and_batched_row(seed,
                                                              key_col):
    rt, tt = _table_pair(seed)
    rng = np.random.default_rng(10 + seed)
    vals = rt.data[key_col]
    distinct = np.unique(rng.choice(vals, 12))
    if key_col != "f":
        distinct = np.unique(np.concatenate([distinct, [-1000, 5, 2000]]))
    got = tops.join_overlap_device(tt.stats, key_col, distinct, mode="torch",
                                   device="cpu")
    for mode in ("ref", "interpret"):
        want = rops.join_overlap_device(rt.stats, key_col, distinct,
                                        mode=mode)
        np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # never a false prune against the f64 intervals; the all-null
    # partitions of x (empty intervals) never hit
    lo, hi = tt.stats.col_min(key_col), tt.stats.col_max(key_col)
    truth = np.array([((distinct >= a) & (distinct <= b)).any()
                      for a, b in zip(lo, hi)])
    assert (got[truth] == 1).all()
    if key_col == "x":
        assert (got[:2] == 0).all()
    # the port's batched row over the resident join-key plane
    pmin, pmax = TD.DeviceStatsCache(device="cpu").join_key_plane(tt,
                                                                  key_col)
    row = tops.join_overlap_batched_device([distinct], pmin, pmax,
                                           tt.num_partitions, mode="torch")[0]
    np.testing.assert_array_equal(got, row)


@pytest.mark.parametrize("bad", ["unsorted", "nan_key", "nan_bound"])
def test_join_rejects_an_unsorted_or_nan_key_list(bad):
    pmin, pmax, keys = _t(*overlap_problem(np.random.default_rng(6), 30, 20))
    if bad == "unsorted":
        keys = keys.flip(0)
    elif bad == "nan_key":
        keys = torch.cat([keys, torch.tensor([float("nan")])])
    else:
        pmax = pmax.clone()
        pmax[3] = float("nan")
    before = join_overlap.launches
    with pytest.raises(KernelError, match="sorted"):
        join_overlap(pmin, pmax, keys)
    assert join_overlap.launches == before
    if bad == "unsorted":
        _rt, tt = _table_pair(0)
        with pytest.raises(KernelError, match="sorted"):
            tops.join_overlap_device(tt.stats, "y", np.array([5.0, 1.0]),
                                     device="cpu")


def _single_oracles(pmin, pmax, distinct):
    """The JAX package's jnp oracle and Pallas kernel (interpret mode), and
    a brute-force any-key-inside, on the same intervals and keys."""
    args = [jnp.asarray(a) for a in (pmin, pmax, distinct)]
    brute = np.array([((distinct >= lo) & (distinct <= hi)).any()
                      for lo, hi in zip(pmin, pmax)], dtype=np.int32)
    return (np.asarray(rref.join_overlap_ref(*args)),
            np.asarray(pallas_join_overlap(*args, interpret=True)), brute)


@pytest.mark.parametrize("kind,P,n_keys,tile,warp", [
    ("clustered", 3000, 40, 1024, 128),    # mostly empty windows
    ("clustered", 5000, 600, 256, 32),
    ("clustered", 600, 50, 1, None),        # tiles of 1
    ("clustered", 700, 80, 2048, 128),      # one tile past P
    ("random", 2047, 300, 1024, 128),
    ("random", 37, 5, 64, None),
])
def test_join_windowed_version_equals_plain_version_pallas_and_brute_force(
        kind, P, n_keys, tile, warp):
    """``ref.join_overlap_windowed_ref`` on one key list (the CUDA kernel's
    arithmetic: each tile's key window, each warp's inside it, the search
    restricted to it) equals the plain version, the jnp oracle, the
    Pallas kernel in interpret mode and a brute force, with all-empty
    tiles (+inf, -inf), keys at both infinities and both signed zeros, and
    intervals that are a signed zero or reach an infinity."""
    rng = np.random.default_rng(P + tile)
    if kind == "clustered":
        t0 = (P // 3) // tile * tile
        run = (t0, t0 + 2 * tile) if 4 * tile <= P else (0, 0)
        pmin, pmax = clustered_plane(rng, P, P, np.float32(np.inf),
                                     empty_run=run)
        keys = clustered_keys(rng, pmin, pmax, P, n_keys, tile)
    else:
        pmin, pmax, keys = overlap_problem(rng, P, n_keys, edges=True)
    keys = np.unique(np.concatenate([keys, [-np.inf, np.inf, 0.0]])
                     ).astype(np.float32)
    keys[keys == 0] = np.float32(-0.0)           # the key is -0.0
    if P >= 8:
        pmin[1:7] = [0.0, -0.0, 5.0, np.inf, -np.inf, -3.0]
        pmax[1:7] = [0.0, -0.0, np.inf, np.inf, -np.inf, -0.0]
    got = tref.join_overlap_windowed_ref(*_t(keys, pmin, pmax), tile, warp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P,)
    assert torch.equal(got, tref.join_overlap_ref(*_t(pmin, pmax, keys)))
    for want in _single_oracles(pmin, pmax, keys):
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "clustered" and run[1]:
        a, b = tref.join_windows(torch.from_numpy(keys)[None],
                                 *_t(pmin, pmax), tile)
        assert (b[0, run[0] // tile:run[1] // tile]
                <= a[0, run[0] // tile:run[1] // tile]).all()


@pytest.mark.parametrize("tile", [8, 32])
def test_join_windowed_version_at_window_sizes(tile):
    """One key list whose tile windows hold 0, 1, 32, 33 keys, and keys on
    both sides of the least staged window and of the staged capacity,
    with keys on every tile's min and max:
    ``join_windows`` finds those sizes, ``window_paths`` sorts them into
    the kernel's four paths, and the windowed version equals the plain
    version and the JAX package."""
    rng = np.random.default_rng(tile)
    least, most = tref.JOIN_STAGE_MIN, tref.JOIN_STAGE_KEYS
    sizes = (0, 1, 32, 33, least - 1, least, most, most + 1)
    pmin, pmax, keys = window_problem(rng, sizes, tile, np.float32(np.inf))
    a, b = tref.join_windows(torch.from_numpy(keys)[None], *_t(pmin, pmax),
                             tile)
    assert (b - a)[0].tolist() == list(sizes)
    assert tref.window_paths(a, b) == dict(empty=1, lanes=2, staged=2,
                                           in_place=3)
    got = tref.join_overlap_windowed_ref(*_t(keys, pmin, pmax), tile,
                                         tile // 4)
    assert torch.equal(got, tref.join_overlap_ref(*_t(pmin, pmax, keys)))
    for want in _single_oracles(pmin, pmax, keys):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,tile", [
    ("join_overlap", tref.JOIN_TILE_SINGLE),
    ("join_overlap_batched", tref.JOIN_TILE_BATCHED),
])
def test_join_window_constants_match_the_kernel_sources(name, tile):
    """The plain versions' tile and staged window sizes are the CUDA
    sources' own (kThreads * kV partitions, kStageMin and kStageKeys
    keys)."""
    import re
    with open(f"{CSRC}/{name}.cu") as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads"] * const["kV"] == tile
    assert const["kStageMin"] == tref.JOIN_STAGE_MIN
    assert const["kStageKeys"] == tref.JOIN_STAGE_KEYS


# ---------------------------------------------------------------------------
# topk_boundary and topk_boundary_device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,k,order,seed", [
    (1, 1, "random", 0), (30, 2, "random", 1), (120, 4, "random", 2),
    (77, 8, "descending", 3), (100, 16, "random", 4),
    (300, 4, "descending", 5),              # more rows than a Pallas block
    (40, 8, "ascending", 6),                # every row merges
])
def test_topk_plain_version_equals_jnp_oracle_and_pallas_interpret(
        P, k, order, seed):
    rng = np.random.default_rng(seed)
    rows, b_init = topk_problem(rng, P, k, order=order)
    skip, heap = tref.topk_boundary_ref(*_t(rows), float(b_init))
    skip_r, heap_r = rref.topk_boundary_ref(jnp.asarray(rows), b_init)
    skip_p, heap_p = pallas_topk_boundary(jnp.asarray(rows),
                                          jnp.asarray(b_init), interpret=True)
    assert skip.dtype == torch.int32
    for s, h in ((skip_r, heap_r), (skip_p, heap_p)):
        np.testing.assert_array_equal(skip.numpy(), np.asarray(s))
        np.testing.assert_array_equal(heap.numpy(), np.asarray(h))
    if order == "ascending" and b_init == NEG:
        assert not skip.any()


def test_topk_plain_version_jumps_over_long_skipped_runs(monkeypatch):
    """Chunk sizes of the jump do not change the scan."""
    rng = np.random.default_rng(8)
    rows, b_init = topk_problem(rng, 3000, 8, order="descending", lo=-30,
                                hi=30)
    want = tref.topk_boundary_ref(*_t(rows), float(b_init))
    monkeypatch.setattr(tref, "TOPK_FIRST_CHUNK", 1)
    monkeypatch.setattr(tref, "TOPK_MAX_CHUNK", 4)
    got = tref.topk_boundary_ref(*_t(rows), float(b_init))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_prefix_formulation_dominates_and_equals_reference(seed):
    """With a witnessed upfront boundary, the prefix-merge formulation
    gives the sequential heap and a superset of its skips; it equals the
    JAX package's prefix oracle exactly."""
    rng = np.random.default_rng(100 + seed)
    P, k = int(rng.integers(1, 120)), int(rng.choice([1, 2, 4, 8, 16]))
    rows, b_init = topk_problem(rng, P, k, valid_binit=True)
    skip_s, heap_s = tops.topk_boundary_device(rows, b_init, device="cpu")
    skip_p, heap_p = tops.topk_boundary_device(rows, b_init, mode="prefix",
                                               device="cpu")
    np.testing.assert_array_equal(heap_p, heap_s)
    assert (skip_p >= skip_s).all()
    want_s, want_h = rref.topk_boundary_prefix_ref(jnp.asarray(rows), b_init)
    np.testing.assert_array_equal(skip_p, np.asarray(want_s))
    np.testing.assert_array_equal(heap_p, np.asarray(want_h))


@pytest.mark.parametrize("mode", ["torch", "prefix"])
def test_topk_padding_rows_harmless(mode):
    rows = np.full((300, 4), -np.inf, dtype=np.float32)   # > a Pallas block
    rows[0] = [5, 4, 3, 2]
    skip, heap = tops.topk_boundary_device(rows, mode=mode, device="cpu")
    np.testing.assert_array_equal(heap, [5, 4, 3, 2])
    _skip_p, heap_p = pallas_topk_boundary(jnp.asarray(rows),
                                           jnp.float32(-np.inf),
                                           interpret=True)
    np.testing.assert_array_equal(heap, np.asarray(heap_p))
    assert skip[0] == 0


def test_b_init_rounds_down_on_every_route():
    """A b_init that is not an f32 is rounded down to one on both of the
    port's routes, as the Pallas route rounds it; the JAX jnp route rounds
    to nearest, so it skips the one row whose head equals the rounded-down
    value, where the port and the Pallas route merge it."""
    b = 0.1                                   # f32(0.1) > 0.1
    b_down = float(TD.round_down_f32(b))
    assert b_down < b < float(np.float32(b))
    rows = np.array([[b_down, -np.inf], [0.5, 0.2], [0.05, -np.inf]],
                    dtype=np.float32)
    skip, heap = tops.topk_boundary_device(rows, b, device="cpu")
    pallas = rops.topk_boundary_device(rows, b, mode="interpret")
    np.testing.assert_array_equal(skip, pallas[0])
    np.testing.assert_array_equal(heap, pallas[1])
    jnp_ref = rops.topk_boundary_device(rows, b, mode="ref")
    np.testing.assert_array_equal(skip, [0, 0, 1])
    np.testing.assert_array_equal(np.asarray(jnp_ref[0]), [1, 0, 1])
    # an f32 b_init: every route agrees
    b32 = float(np.float32(0.5))
    for mode in ("ref", "interpret"):
        want = rops.topk_boundary_device(rows, b32, mode=mode)
        got = tops.topk_boundary_device(rows, b32, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_topk_boundary_device_matches_host_engine(k, desc):
    """Block-top-k rows in the host scan's order through the port's
    topk_boundary_device: the heap is the full-scan oracle's top-k, the
    skips are exactly ``run_topk(strategy="sort")``'s, and the JAX
    package's interpret route gives the same."""
    rt, tt = _table_pair(3 + k, n=300, rows_pp=6)
    sign = 1.0 if desc else -1.0
    vals, _ = tt.global_ctx().col("y")
    scan = ScanSet.full(tt.num_partitions)
    host = run_topk(tt, scan, "y", k, desc=desc, strategy="sort")
    rows = tops.build_block_topk(sign * vals, tt.part_bounds, k)
    bmax = sign * (tt.stats.col_max("y") if desc else tt.stats.col_min("y"))
    order = np.argsort(-bmax, kind="stable")
    skip, heap = tops.topk_boundary_device(rows[order], device="cpu")
    oracle = topk_oracle(tt, "y", k, desc=desc)
    got = sign * np.sort(heap[heap > -np.inf])[::-1]
    np.testing.assert_array_equal(got, oracle.astype(np.float32))
    host_skip = np.isin(scan.part_ids[order], host.skipped).astype(np.int32)
    np.testing.assert_array_equal(skip, host_skip)
    r_skip, r_heap = rops.topk_boundary_device(rows[order], mode="interpret")
    np.testing.assert_array_equal(skip, np.asarray(r_skip))
    np.testing.assert_array_equal(heap, np.asarray(r_heap))


# ---------------------------------------------------------------------------
# the tiled boundary scan of csrc/topk_boundary.cu (ref.topk_boundary_tiled_ref)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,k,order,tile,b_kind,zeros,seed", [
    (1, 1, "random", 1, "none", False, 0),
    (50, 4, "random", 1, "none", False, 1),          # a row a tile
    (50, 4, "random", 2, "median", False, 2),
    (120, 8, "random", 7, "none", False, 3),
    (120, 8, "descending", 7, "median", False, 4),
    (120, 8, "random", 120, "median", False, 5),     # one tile
    (77, 3, "ascending", 7, "none", False, 6),       # every row merges
    (77, 3, "ascending", 2, "median", False, 7),
    (200, 16, "random", 7, "above", False, 8),       # every row skipped
    (200, 16, "descending", 1, "none", False, 9),
    (300, 2, "random", 400, "none", False, 10),      # a tile past P
    (40, 8, "random", 7, "all_neg_inf", False, 11),
    (60, 6, "random", 2, "none", True, 12),          # -0.0 beside +0.0
    (60, 6, "descending", 7, "median", True, 13),
])
def test_tiled_scan_equals_sequential_scan_and_pallas_interpret(
        P, k, order, tile, b_kind, zeros, seed):
    """Passes A-C of the CUDA scan in plain torch against the sequential
    plain version (skips and heap bits, -0.0 and +0.0 told apart) and the
    JAX package's Pallas kernel in interpret mode (skips; heap values, and
    bits where a value is not zero: the Pallas merge's one-hot sum returns
    +0.0 for a selected -0.0).  Heads from a narrow integer range tie; 15%
    of the rows are all -inf.  Up to 16 values (k <= 8) the plain
    version's sort is stable on the CPU, so it places signed zeros as the
    stable merges do."""
    rng = np.random.default_rng(seed)
    rows, _ = topk_problem(rng, P, k, order=order, lo=-6, hi=6)
    if order != "ascending":
        rows[rng.random(P) < 0.15] = -np.inf
    if b_kind == "all_neg_inf":
        rows[:] = -np.inf
    if zeros:
        flip = (rows == 0) & (rng.random(rows.shape) < 0.5)
        rows[flip] = -0.0
        rows = np.ascontiguousarray(-np.sort(-rows, axis=1))
        assert flip.any() and (rows == 0).sum() > flip.sum()
    b_init = {"none": NEG, "all_neg_inf": NEG,
              "median": float(np.median(rows[:, 0])),
              "above": float(np.nanmax(rows[:, 0])) + 1.0}[b_kind]
    skip, heap = tref.topk_boundary_tiled_ref(*_t(rows), b_init, tile)
    want_skip, want_heap = tref.topk_boundary_ref(*_t(rows), b_init)
    assert skip.dtype == torch.int32 and torch.equal(skip, want_skip)
    assert torch.equal(heap.view(torch.int32), want_heap.view(torch.int32))
    skip_p, heap_p = pallas_topk_boundary(jnp.asarray(rows),
                                          jnp.float32(b_init), interpret=True)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(skip_p))
    got, pallas = heap.numpy(), np.asarray(heap_p)
    np.testing.assert_array_equal(got, pallas)
    nz = got != 0
    np.testing.assert_array_equal(got[nz].view(np.int32),
                                  pallas[nz].view(np.int32))
    if b_kind == "above":
        assert skip.all()
    if order == "ascending" and b_init == NEG:
        assert not skip.any()


@pytest.mark.parametrize("P,k,sms", [
    (1, 1, 132), (2049, 8, 132), (1 << 20, 25, 132), (1 << 20, 200, 132),
    ((1 << 20) + 1, 25, 132), (1 << 21, 1, 132), (40, MAX_K_SCAN, 132),
    (100_000, 3000, 132), (1 << 20, 25, 1),
])
def test_scan_tile_fills_the_card_within_shared_memory(P, k, sms):
    """The scan's tile: a multiple of the walk's sub-tile, at least k rows,
    about two tiles an SM, and pass B's n - 1 heaps within its shared
    memory; phase 4's shape (P = 2**20, k = 25) runs on many blocks."""
    T = tb.scan_tile(P, k, sms)
    n = -(-P // T)
    assert T % tb.SCAN_SUB == 0 and T >= k
    assert n <= max(1, tb.TILES_PER_SM * sms)
    assert (n - 1) * k <= tb.SCAN_FLOATS
    if (P, k, sms) == (1 << 20, 25, 132):
        assert (T, n) == (4096, 256)


# ---------------------------------------------------------------------------
# the three wrappers and ops entry points on the CPU
# ---------------------------------------------------------------------------

def _wrapper_case(kernel, rng):
    if kernel == "minmax_prune":
        args = _t(*range_problem(rng, 3, 50))
        return minmax_prune, args, lambda: tref.minmax_prune_ref(*args)
    if kernel == "join_overlap":
        args = _t(*overlap_problem(rng, 50, 30))
        return join_overlap, args, lambda: tref.join_overlap_ref(*args)
    rows, b_init = topk_problem(rng, 50, 4)
    args = _t(rows) + [float(b_init)]
    return topk_boundary, args, lambda: tref.topk_boundary_ref(*args)


PER_QUERY = ["minmax_prune", "join_overlap", "topk_boundary"]


@pytest.mark.parametrize("kernel", PER_QUERY)
def test_per_query_wrappers_run_plain_version_on_cpu_count_no_launch(kernel):
    fn, args, plain = _wrapper_case(kernel, np.random.default_rng(11))
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before
    want = plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernel in tops.KERNELS


@pytest.mark.parametrize("kernel,bad", [
    ("minmax_prune", "dtype"), ("minmax_prune", "shape"),
    ("minmax_prune", "contiguous"), ("topk_boundary", "k"),
    ("topk_boundary", "nan_b_init"), ("topk_boundary", "dtype"),
    ("join_overlap", "dtype"), ("join_overlap", "shape"),
])
def test_per_query_wrappers_reject_what_the_kernel_does_not_take(kernel,
                                                                 bad):
    fn, args, _ = _wrapper_case(kernel, np.random.default_rng(12))
    args = list(args)
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = args[1][:-1].contiguous()
    elif bad == "contiguous":
        args[2] = torch.cat([args[2], args[2]], 1)[:, ::2]
    elif bad == "k":
        args[0] = torch.zeros((3, MAX_K_SCAN + 1))
    else:
        args[1] = float("nan")
    with pytest.raises(KernelError):
        fn(*args)


def _op_call(op, device, mode="auto"):
    _rt, tt = _table_pair(0, n=60)
    if op == "prune_ranges_device":
        return tops.prune_ranges_device([(0, -10.0, 10.0)], tt.stats,
                                        mode=mode, device=device)
    if op == "join_overlap_device":
        return tops.join_overlap_device(tt.stats, "y", np.arange(5.0),
                                        mode=mode, device=device)
    rows = np.full((4, 2), -np.inf, dtype=np.float32)
    return tops.topk_boundary_device(rows, mode=mode, device=device)


OPS = ["prune_ranges_device", "join_overlap_device", "topk_boundary_device"]


@pytest.mark.parametrize("op", OPS)
def test_per_query_modes_refuse_the_other_device(op):
    with pytest.raises(ValueError, match="cuda"):
        _op_call(op, "cpu", mode="cuda")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        _op_call(op, "cpu", mode="pallas")
    _op_call(op, "cpu", mode="torch")
    if op != "topk_boundary_device":
        with pytest.raises(ValueError, match="unknown kernel mode"):
            _op_call(op, "cpu", mode="prefix")


@pytest.mark.parametrize("op", OPS)
def test_per_query_ops_run_on_the_gpu_by_default(op, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _op_call(op, None)
    _op_call(op, "cpu")


@pytest.mark.parametrize("name", ["minmax_prune", "join_overlap",
                                  "topk_boundary"])
def test_per_query_kernel_sources_exist(name):
    import os
    assert name in tops.KERNELS
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    assert f'extern "C" int {name}_launch(' in src
    assert "src/repro/kernels/" in src       # names the TPU kernel it replaces
