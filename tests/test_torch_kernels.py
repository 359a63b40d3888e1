"""The batched kernels' plain PyTorch versions against the JAX package:
its jnp oracles and its Pallas kernels in interpret mode.

Verdicts are integers and the top-k heaps are selected values, so the
tolerance is exact equality everywhere.  Shapes stay small (P <= 2048 and
Q <= 16 through Pallas interpret mode).  Kernel inputs come from the
generators of ``test_torch_cuda.py``, which the on-card tests share.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import device_stats as RD
from repro.core import metadata as RM
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.core import prune_join as RJ
from repro.kernels.bloom_probe import \
    bloom_probe_batched as pallas_bloom_probe_batched
from repro.kernels.join_overlap import \
    join_overlap_batched as pallas_join_overlap_batched
from repro.kernels.minmax_prune_batched import \
    minmax_prune_batched as pallas_minmax_prune_batched
from repro.kernels.topk_boundary import \
    topk_init_batched as pallas_topk_init_batched

from repro_torch.core import device_stats as TD
from repro_torch.core import metadata as TM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.bloom_probe import bloom_probe_batched
from repro_torch.kernels.join_overlap import join_overlap_batched
from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
from repro_torch.kernels.topk_boundary import topk_init_batched

from test_torch_cuda import (TOPK_EDGES, bloom_inputs, clustered_keys,
                             clustered_plane, join_inputs, topk_edge_inputs,
                             topk_inputs, window_problem)

torch.set_num_threads(1)

from repro_torch.kernels import minmax_prune_batched as tmpb

SENT = np.array([0, 3, 7, 11])          # sentinel (dropped) positions
LIVE = np.array([i for i in range(12) if i not in SENT])
F32_MAX = np.float32(np.finfo(np.float32).max)


def _stats(M, mins, maxs, C=2):
    P = len(mins)
    return M.PartitionStats(
        columns=[M.ColumnMeta(f"c{i}", "int") for i in range(C)],
        mins=np.tile(np.asarray(mins, np.float64)[:, None], (1, C)),
        maxs=np.tile(np.asarray(maxs, np.float64)[:, None], (1, C)),
        null_counts=np.zeros((P, C), dtype=np.int64),
        row_counts=np.full(P, 5, dtype=np.int64),
    )


def _stage_pair(mins, maxs, capacity=None):
    return (RD.DeviceStats.stage(_stats(RM, mins, maxs), capacity=capacity),
            TD.DeviceStats.stage(_stats(TM, mins, maxs), capacity=capacity,
                                 device="cpu"))


SENTINEL_RANGES = [
    [(0, -50.0, 75.0)],                      # two-sided
    [(1, 0.0, np.inf)],                      # one-sided lo
    [(0, -np.inf, 10.0)],                    # one-sided hi
    [(0, 42.0, 42.0), (1, -80.0, 120.0)],    # equality + conj
]


def _sentinel_planes():
    rng = np.random.default_rng(0)
    base_min = rng.integers(-100, 100, LIVE.size).astype(np.float64)
    base_max = base_min + rng.integers(0, 50, LIVE.size)
    mins = np.full(12, np.inf)
    maxs = np.full(12, -np.inf)              # the drop sentinel, pre-cast
    mins[LIVE], maxs[LIVE] = base_min, base_max
    return mins, maxs, base_min, base_max


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
def test_sentinel_rows_match_reference(ref_mode):
    """The cases of the reference's sentinel suite: sentinel partitions
    are NO_MATCH and live rows are unchanged, identically in both."""
    mins, maxs, base_min, base_max = _sentinel_planes()
    r_all, t_all = _stage_pair(mins, maxs)
    r_live, t_live = _stage_pair(base_min, base_max)
    want = rops.prune_ranges_batched_device(SENTINEL_RANGES, r_all,
                                            mode=ref_mode)
    got = tops.prune_ranges_batched_device(SENTINEL_RANGES, t_all,
                                           mode="torch")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8
    assert (got[:, SENT] == 0).all()
    np.testing.assert_array_equal(
        got[:, LIVE], tops.prune_ranges_batched_device(SENTINEL_RANGES,
                                                       t_live, mode="torch"))
    np.testing.assert_array_equal(
        got, tops.prune_ranges_batched_host(SENTINEL_RANGES,
                                            _stats(TM, mins, maxs)))


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
def test_capacity_tail_sentinels_sliced_off(ref_mode):
    rng = np.random.default_rng(1)
    mins = rng.integers(-100, 100, 10).astype(np.float64)
    maxs = mins + 10
    ranges = [[(0, -200.0, 200.0)], [(1, 0.0, 5.0)]]
    r_pad, t_pad = _stage_pair(mins, maxs, capacity=32)
    _, t_dense = _stage_pair(mins, maxs)
    assert t_pad.capacity == 32 and t_pad.num_partitions == 10
    got = tops.prune_ranges_batched_device(ranges, t_pad, mode="torch")
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(
        got, tops.prune_ranges_batched_device(ranges, t_dense, mode="auto"))
    np.testing.assert_array_equal(
        got, rops.prune_ranges_batched_device(ranges, r_pad, mode=ref_mode))


def _random_kernel_inputs(rng, Q, Kb, C, P):
    mins = rng.integers(-100, 100, (C, P)).astype(np.float32)
    maxs = mins + rng.integers(0, 40, (C, P)).astype(np.float32)
    demote = (rng.random((C, P)) < 0.3).astype(np.float32)
    drop = rng.random((C, P)) < 0.1
    mins[drop], maxs[drop], demote[drop] = F32_MAX, -F32_MAX, 1.0
    cids = rng.integers(0, C, (Q, Kb)).astype(np.int32)
    lo = rng.integers(-120, 120, (Q, Kb)).astype(np.float32)
    hi = lo + rng.integers(0, 60, (Q, Kb)).astype(np.float32)
    pick = rng.integers(0, P, (Q, Kb))
    eq = rng.random((Q, Kb)) < 0.3               # inclusive ends
    lo[eq] = mins[cids[eq], pick[eq]]
    hi[eq] = np.maximum(hi[eq], lo[eq])
    noop = rng.random((Q, Kb)) < 0.25
    lo[noop], hi[noop] = -np.inf, np.inf
    return cids, lo, hi, mins, maxs, demote


@pytest.mark.parametrize("Q,Kb,C,P", [
    (1, 1, 1, 1), (7, 2, 3, 31), (16, 4, 6, 2048), (13, 8, 5, 1000),
])
def test_plain_version_equals_jnp_oracle_and_pallas_interpret(Q, Kb, C, P):
    rng = np.random.default_rng(Q * 1000 + P)
    arrays = _random_kernel_inputs(rng, Q, Kb, C, P)
    got = tref.minmax_prune_batched_ref(
        *[torch.from_numpy(a) for a in arrays]).numpy()
    oracle = np.asarray(rref.minmax_prune_batched_ref(
        *[jnp.asarray(a) for a in arrays]))
    pallas = np.asarray(pallas_minmax_prune_batched(
        *[jnp.asarray(a) for a in arrays], interpret=True))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("seed", range(3))
def test_batched_device_matches_reference_ref_and_host(seed):
    """ops.prune_ranges_batched_device(mode='torch') == the reference's
    mode='ref' output == prune_ranges_batched_host, on staged planes of
    random int tables (bounds snap to integers: exact vs the f64 host)."""
    rng = np.random.default_rng(seed)
    P, C = 300, 3
    mins = rng.integers(-1000, 1000, (P, C)).astype(np.float64)
    maxs = mins + rng.integers(0, 100, (P, C))
    nulls = (rng.random((P, C)) < 0.1).astype(np.int64)
    rows = np.full(P, 10, dtype=np.int64)
    rs = RM.PartitionStats([RM.ColumnMeta(f"c{i}", "int") for i in range(C)],
                           mins, maxs, nulls, rows)
    ts = TM.PartitionStats([TM.ColumnMeta(f"c{i}", "int") for i in range(C)],
                           mins.copy(), maxs.copy(), nulls.copy(), rows.copy())
    cap = TD.plane_capacity(P)
    rdst = RD.DeviceStats.stage(rs, capacity=cap)
    tdst = TD.DeviceStats.stage(ts, capacity=cap, device="cpu")
    range_lists = []
    for _ in range(20):
        k = int(rng.integers(0, 4))
        rl = []
        for _ in range(k):
            lo = float(rng.integers(-1100, 1000)) + rng.choice([0.0, 0.5])
            rl.append((int(rng.integers(0, C)), lo,
                       lo + float(rng.integers(0, 400))))
        range_lists.append(rl)
    got = tops.prune_ranges_batched_device(range_lists, tdst, mode="torch")
    np.testing.assert_array_equal(
        got, rops.prune_ranges_batched_device(range_lists, rdst, mode="ref"))
    np.testing.assert_array_equal(
        got, tops.prune_ranges_batched_host(range_lists, ts))
    np.testing.assert_array_equal(
        tops.prune_ranges_batched_host(range_lists, ts),
        rops.prune_ranges_batched_host(range_lists, rs))
    for a, b in zip(tops.pack_ranges(range_lists, tdst),
                    rops.pack_ranges(range_lists, rdst)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_inexact_float_bounds_demote_full_like_reference():
    P = 50
    mins = np.linspace(0, 1, P)[:, None] + np.zeros((P, 1))
    maxs = mins + 0.01
    zeros = np.zeros((P, 1), dtype=np.int64)
    rows = np.full(P, 3, dtype=np.int64)
    rs = RM.PartitionStats([RM.ColumnMeta("f", "float")], mins, maxs, zeros,
                           rows)
    ts = TM.PartitionStats([TM.ColumnMeta("f", "float")], mins.copy(),
                           maxs.copy(), zeros.copy(), rows.copy())
    ranges = [[(0, 0.3, np.inf)], [(0, 0.25, 0.5)], [(0, 0.5, 0.5)]]
    got = tops.prune_ranges_batched_device(
        ranges, TD.DeviceStats.stage(ts, device="cpu"), mode="torch")
    np.testing.assert_array_equal(got, rops.prune_ranges_batched_device(
        ranges, RD.DeviceStats.stage(rs), mode="ref"))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 8, 9, 100])
def test_buckets_equal_reference(k):
    assert tops.k_bucket(k) == rops.k_bucket(k)
    assert tops.q_bucket(k) == rops.q_bucket(k)


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(9)
    arrays = [torch.from_numpy(a)
              for a in _random_kernel_inputs(rng, 5, 2, 3, 40)]
    before = minmax_prune_batched.launches
    got = minmax_prune_batched(*arrays, num_partitions=33)
    assert minmax_prune_batched.launches == before
    assert got.dtype == torch.int8 and tuple(got.shape) == (5, 33)
    torch.testing.assert_close(
        got, tref.minmax_prune_batched_ref(*arrays)[:, :33], rtol=0, atol=0)


@pytest.mark.parametrize("Q,P", [(5, 3000), (64, 4096)])
def test_wrapper_slabs_the_plain_version_over_p(monkeypatch, Q, P):
    """On the CPU the wrapper runs the plain version in [Q, slab] column
    slabs; the slabs join up to the one-shot answer."""
    rng = np.random.default_rng(Q + P)
    arrays = [torch.from_numpy(a)
              for a in _random_kernel_inputs(rng, Q, 4, 3, P)]
    want = tref.minmax_prune_batched_ref(*arrays, num_partitions=P - 3)
    monkeypatch.setattr(tmpb, "_REF_SLAB_ELEMS", 1)   # 1024-column slabs
    got = minmax_prune_batched(*arrays, num_partitions=P - 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "p"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(10)
    cids, lo, hi, mins, maxs, dem = [
        torch.from_numpy(a) for a in _random_kernel_inputs(rng, 4, 2, 3, 16)]
    kw = {}
    if bad == "dtype":
        cids = cids.long()
    elif bad == "shape":
        hi = hi[:, :1].contiguous()
    elif bad == "contiguous":
        maxs = torch.cat([maxs, maxs], 1)[:, ::2]
    else:
        kw = dict(num_partitions=17)
    with pytest.raises(KernelError):
        minmax_prune_batched(cids, lo, hi, mins, maxs, dem, **kw)


def test_modes_refuse_the_other_device():
    _, tdst = _stage_pair(np.arange(4.0), np.arange(4.0) + 1)
    with pytest.raises(ValueError, match="cuda"):
        tops.prune_ranges_batched_device([[(0, 0.0, 1.0)]], tdst, mode="cuda")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        tops.prune_ranges_batched_device([[(0, 0.0, 1.0)]], tdst,
                                         mode="pallas")


# ---------------------------------------------------------------------------
# join_overlap_batched
# ---------------------------------------------------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("Q,max_keys,P", [
    (1, 1, 1), (5, 60, 300), (9, 200, 1000), (3, 1, 257), (16, 40, 2048),
])
def test_join_plain_version_equals_jnp_oracle_and_pallas_interpret(
        Q, max_keys, P):
    rng = np.random.default_rng(Q * 100 + P)
    cap = TD.plane_capacity(P)
    pmin, pmax, lists = join_inputs(rng, Q, P, cap, max_keys)
    dist = tops.pack_distinct(lists)
    dist_r = rops.pack_distinct(lists)          # [Db, Qb]: keys on axis 0
    assert dist.tobytes() == np.ascontiguousarray(dist_r[:, :Q].T).tobytes()
    got = tref.join_overlap_batched_ref(*_t(dist, pmin, pmax),
                                        num_partitions=P).numpy()
    args_r = (jnp.asarray(dist_r), jnp.asarray(pmin[:P]),
              jnp.asarray(pmax[:P]))
    oracle = np.asarray(rref.join_overlap_batched_ref(*args_r))[:Q]
    pallas = np.asarray(pallas_join_overlap_batched(*args_r,
                                                    interpret=True))[:Q]
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    # the service path: packing, plane slicing and readback
    np.testing.assert_array_equal(
        tops.join_overlap_batched_device(lists, *_t(pmin, pmax), P,
                                         mode="torch"),
        rops.join_overlap_batched_device(lists, jnp.asarray(pmin[:P]),
                                         jnp.asarray(pmax[:P]), mode="ref"))


def test_join_plain_version_slabs_over_p(monkeypatch):
    rng = np.random.default_rng(3)
    P = 3000
    pmin, pmax, lists = join_inputs(rng, 7, P, TD.plane_capacity(P))
    args = _t(tops.pack_distinct(lists), pmin, pmax)
    want = tref.join_overlap_batched_ref(*args, num_partitions=P)
    monkeypatch.setattr(tref, "JOIN_SLAB_ELEMS", 7 * 256)   # 256-wide slabs
    assert torch.equal(tref.join_overlap_batched_ref(*args, num_partitions=P),
                       want)


def _join_oracles(lists, pmin, pmax, P):
    """The JAX package's jnp oracle and Pallas kernel (interpret mode) on
    the same key lists and the first P intervals: hit [Q, P]."""
    dist_r = rops.pack_distinct(lists)
    args_r = (jnp.asarray(dist_r), jnp.asarray(pmin[:P]),
              jnp.asarray(pmax[:P]))
    Q = len(lists)
    return (np.asarray(rref.join_overlap_batched_ref(*args_r))[:Q],
            np.asarray(pallas_join_overlap_batched(*args_r,
                                                   interpret=True))[:Q])


@pytest.mark.parametrize("kind,Q,P,n_keys,tile,warp,sentinel", [
    ("clustered", 6, 3000, 40, 256, 32, "f32max"),    # mostly empty windows
    ("clustered", 5, 4100, 400, 2048, 256, "f32max"),  # the kernel's tile
    ("clustered", 3, 700, 60, 1, None, "inf"),         # tiles of 1
    ("clustered", 4, 700, 100, 4096, 512, "inf"),      # one tile past P
    ("random", 7, 1000, 300, 64, 16, "f32max"),
    ("random", 2, 257, 5, 2048, None, "inf"),
])
def test_join_windowed_version_equals_plain_version_and_pallas_interpret(
        kind, Q, P, n_keys, tile, warp, sentinel):
    """``ref.join_overlap_windowed_ref`` (the CUDA kernel's arithmetic:
    each tile's key window, each warp's inside it, the search restricted
    to it) equals the plain version, the jnp oracle and the Pallas kernel
    in interpret mode, on clustered planes with all-empty tiles and on
    random ones, with either empty sentinel."""
    rng = np.random.default_rng(P + Q + tile)
    cap = TD.plane_capacity(P)
    sent = F32_MAX if sentinel == "f32max" else np.float32(np.inf)
    if kind == "clustered":
        t0 = (P // 3) // tile * tile
        run = (t0, t0 + 2 * tile) if 4 * tile <= P else (0, 0)
        pmin, pmax = clustered_plane(rng, P, cap, sent, empty_run=run)
        lists = [clustered_keys(rng, pmin, pmax, P, n_keys, tile)
                 for _ in range(Q)]
    else:
        pmin, pmax, lists = join_inputs(rng, Q, P, cap, n_keys)
        gone = pmin > pmax
        pmin[gone], pmax[gone] = sent, -sent
    dist = tops.pack_distinct(lists)
    args = _t(dist, pmin, pmax)
    got = tref.join_overlap_windowed_ref(*args, tile, warp, num_partitions=P)
    want = tref.join_overlap_batched_ref(*args, num_partitions=P)
    assert got.dtype == torch.int8 and tuple(got.shape) == (Q, P)
    assert torch.equal(got, want)
    oracle, pallas = _join_oracles(lists, pmin, pmax, P)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), pallas)
    a, b = tref.join_windows(args[0], *args[1:], tile, num_partitions=P)
    assert a.shape == (Q, -(-P // tile))
    if kind == "clustered" and run[1]:
        # the all-empty tiles' windows are empty for every query
        assert (b[:, run[0] // tile:run[1] // tile]
                <= a[:, run[0] // tile:run[1] // tile]).all()


@pytest.mark.parametrize("tile", [8, 16])
def test_join_windowed_version_at_window_sizes(tile):
    """Windows of 0, 1, 32, 33 keys, on both sides of the least staged
    window and of the staged capacity, with keys on every tile's min and
    max: ``join_windows`` finds
    those sizes, ``window_paths`` sorts them into the kernel's four paths,
    and the windowed version equals the plain version and the JAX
    package."""
    rng = np.random.default_rng(tile)
    least, most = tref.JOIN_STAGE_MIN, tref.JOIN_STAGE_KEYS
    sizes = (0, 1, 32, 33, least - 1, least, most, most + 1)
    pmin, pmax, keys = window_problem(rng, sizes, tile, F32_MAX)
    P = pmin.size
    lists = [keys, keys[::2], keys[:40], keys[-3:]]
    dist = tops.pack_distinct(lists)
    args = _t(dist, pmin, pmax)
    a, b = tref.join_windows(args[0], *args[1:], tile)
    assert (b - a)[0].tolist() == list(sizes)
    assert tref.window_paths(a[:1], b[:1]) == dict(empty=1, lanes=2,
                                                   staged=2, in_place=3)
    got = tref.join_overlap_windowed_ref(*args, tile, tile // 2)
    assert torch.equal(got, tref.join_overlap_batched_ref(*args))
    oracle, pallas = _join_oracles(lists, pmin, pmax, P)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_join_windowed_version_widens_a_tile_with_a_nan_bound():
    """A NaN bound (outside the plane's contract) widens its tile's window
    to the whole row, so the windowed version stays the plain version's
    search there too."""
    rng = np.random.default_rng(9)
    P = 600
    pmin, pmax = clustered_plane(rng, P, P, F32_MAX)
    lists = [clustered_keys(rng, pmin, pmax, P, 50) for _ in range(3)]
    pmin[5], pmax[300] = np.nan, np.nan
    args = _t(tops.pack_distinct(lists), pmin, pmax)
    a, b = tref.join_windows(args[0], *args[1:], 64)
    assert (a[:, [0, 4]] == 0).all()
    assert (b[:, [0, 4]] == args[0].shape[1]).all()
    assert torch.equal(tref.join_overlap_windowed_ref(*args, 64, 8),
                       tref.join_overlap_batched_ref(*args))


# ---------------------------------------------------------------------------
# bloom_probe_batched
# ---------------------------------------------------------------------------

def test_mix32_equals_host_mixer():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 5000, dtype=np.uint64),
                        [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]])
    got = tref.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, RJ._mix32(x.astype(np.uint32)))


@pytest.mark.parametrize("Q,P,n_blocks,limit", [
    (1, 1, (1,), 64), (4, 300, (1, 8, 256, 1024), 64), (3, 700, (8,), 16),
    (9, 129, (1, 256), 96),
])
def test_bloom_plain_version_equals_jnp_oracle_and_pallas_interpret(
        Q, P, n_blocks, limit):
    rng = np.random.default_rng(Q * 100 + P)
    cap = TD.plane_capacity(P)
    blooms, pmin, width, width_eff = bloom_inputs(rng, Q, P, cap, n_blocks,
                                                  limit)
    words = tops.pack_blooms(blooms)
    lo, hi = rops.pack_blooms(blooms)           # [Qb, 16, Bb] 16-bit halves
    w = words.view(np.uint32).reshape(Q, -1, 16).transpose(0, 2, 1)
    np.testing.assert_array_equal(w & 0xFFFF, lo[:Q])
    np.testing.assert_array_equal(w >> 16, hi[:Q])
    got = tref.bloom_probe_batched_ref(*_t(words, pmin, width_eff),
                                       num_partitions=P).numpy()
    wmax = int(width[:P].max())
    eb = rops.enum_bucket(max(1, min(wmax, limit)))
    args_r = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(pmin[:P]),
              jnp.asarray(width_eff[:P]))
    oracle = np.asarray(rref.bloom_probe_batched_ref(*args_r, eb))[:Q]
    pallas = np.asarray(pallas_bloom_probe_batched(
        *args_r, enum_pad=eb, interpret=True))[:Q]
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    # the service path (raw widths; the wrapper applies the limit) against
    # the reference's host BlockedBloom matcher
    np.testing.assert_array_equal(
        tops.bloom_probe_batched_device(blooms, *_t(pmin, width), limit, P,
                                        mode="torch"),
        rops.bloom_probe_batched_device(blooms, jnp.asarray(pmin[:P]),
                                        jnp.asarray(width[:P]), wmax, limit,
                                        mode="ref"))


def bitsliced_probe(table, bits, Q, n_blocks, pmin, width, P):
    """hit [Q, P] through a ``bloom_bitslice_ref`` table, as the card's
    kernel probes it: every candidate hashed once, a chunk's hits the AND
    of its four entries."""
    hit = torch.ones((Q, P), dtype=torch.int8)
    w = width[:P].to(torch.int64).clamp(min=0)
    total = int(w.sum())
    if total == 0:
        return hit
    seg = torch.repeat_interleave(torch.arange(P), w)
    c = pmin[:P].to(torch.int64)[seg] + torch.arange(total) \
        - (torch.cumsum(w, 0) - w)[seg]
    h0 = tref.mix32((c & tref.U32) ^ tref.mix32(torch.where(c < 0, tref.U32,
                                                            0)))
    h1 = tref.mix32(h0 ^ tref.H1_SALT)
    h2 = tref.mix32(h1 ^ tref.H2_SALT)
    base = (h0 & (n_blocks - 1)) * 512
    masks = torch.full((table.shape[0], total), -1, dtype=torch.int64)
    for i in range(4):
        masks &= table[:, base + ((h1 >> (8 * i)) & 15) * 32
                       + ((h2 >> (8 * i)) & 31)]
    for q in range(Q):
        any_hit = torch.zeros(P, dtype=torch.int64).index_add_(
            0, seg, (masks[q // bits] >> (q % bits)) & 1)
        hit[q] = torch.where(w > 0, any_hit > 0, True).to(torch.int8)
    return hit


@pytest.mark.parametrize("Q,P,n_blocks,bits", [
    (1, 40, (1,), 8), (16, 300, (256,), 8), (16, 300, (256,), 16),
    (33, 200, (1, 8, 64), 32), (70, 129, (8,), 8), (5, 100, (1, 1024), 32),
])
def test_bloom_bitsliced_table_equals_plain_version_and_oracle(
        Q, P, n_blocks, bits):
    """The card's bit-sliced layout, built by its plain transpose and
    probed in plain torch, against the port's plain version and the JAX
    oracle: a layout error shows here, on the CPU."""
    rng = np.random.default_rng(Q * 1000 + P + bits)
    cap = TD.plane_capacity(P)
    blooms, pmin, width, width_eff = bloom_inputs(rng, Q, P, cap, n_blocks)
    words = tops.pack_blooms(blooms)
    nb = words.shape[1] // 16
    table = tref.bloom_bitslice_ref(torch.from_numpy(words), bits)
    assert tuple(table.shape) == (-(-Q // bits), nb * 512)
    q, pos, bit = Q - 1, 7 % (nb * 16), 5            # one entry by hand
    assert int(table[q // bits, pos * 32 + bit] >> (q % bits)) & 1 == \
        int(words.view(np.uint32)[q, pos] >> bit) & 1
    got = bitsliced_probe(table, bits, Q, nb, *_t(pmin, width_eff), P)
    plain = tref.bloom_probe_batched_ref(*_t(words, pmin, width_eff),
                                         num_partitions=P)
    assert torch.equal(got, plain)
    lo, hi = rops.pack_blooms(blooms)
    eb = rops.enum_bucket(max(1, min(int(width[:P].max()), 64)))
    oracle = np.asarray(rref.bloom_probe_batched_ref(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(pmin[:P]),
        jnp.asarray(width_eff[:P]), eb))[:Q]
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("Q,n_blocks,plan", [
    (1, 1, (8, 512)), (16, 256, (16, 262_144)), (16, 128, (16, 131_072)),
    (32, 64, (32, 131_072)), (70, 256, (32, 3 * 524_288)),
    (8, 256, (8, 131_072)), (8, 1024, (8, 524_288)),
    (33, 1024, (32, 2 * 2_097_152)),
])
def test_bloom_table_plan(Q, n_blocks, plan):
    """The narrowest entry that covers min(Q, 32) queries, and a table of
    ceil(Q / bits) chunks that the plain transpose fills exactly."""
    from repro_torch.kernels.bloom_probe import table_plan
    assert table_plan(Q, n_blocks) == plan
    bits, nbytes = plan
    words = torch.zeros((Q, n_blocks * 16), dtype=torch.int32)
    table = tref.bloom_bitslice_ref(words, bits)
    assert table.numel() * bits // 8 == nbytes


def test_bloom_plain_version_slabs_over_p(monkeypatch):
    rng = np.random.default_rng(4)
    P = 2000
    blooms, pmin, _w, width_eff = bloom_inputs(rng, 5, P,
                                               TD.plane_capacity(P))
    args = _t(tops.pack_blooms(blooms), pmin, width_eff)
    want = tref.bloom_probe_batched_ref(*args, num_partitions=P)
    monkeypatch.setattr(tref, "BLOOM_SLAB_CANDIDATES", 100)
    assert torch.equal(tref.bloom_probe_batched_ref(*args, num_partitions=P),
                       want)


# ---------------------------------------------------------------------------
# topk_init_batched
# ---------------------------------------------------------------------------

def _dense_mask(lists, cap):
    mask = np.zeros((cap, len(lists)), dtype=np.float32)      # [P, Q]
    for q, ids in enumerate(lists):
        mask[ids, q] = 1.0
    return mask


@pytest.mark.parametrize("Q,P,K,k", [
    (1, 1, 8, 1), (5, 200, 8, 3), (9, 130, 8, 8), (3, 300, 4, 16),
])
def test_topk_plain_version_equals_jnp_oracle_and_pallas_interpret(
        Q, P, K, k):
    rng = np.random.default_rng(Q * 100 + P)
    cap = TD.plane_capacity(P)
    plane, lists = topk_inputs(rng, Q, P, cap, K)
    offsets, ids = tops.pack_candidates(lists)
    got = tref.topk_init_batched_ref(*_t(plane, offsets, ids), k).numpy()
    mask = _dense_mask(lists, cap)
    args_r = (jnp.asarray(plane), jnp.asarray(mask))
    oracle = np.asarray(rref.topk_init_batched_ref(*args_r, k))
    pallas = np.asarray(pallas_topk_init_batched(*args_r, k, interpret=True))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("k", [1, 3, 64, 128])
def test_topk_service_path_equals_reference(k):
    rng = np.random.default_rng(k)
    P = 1500
    plane, lists = topk_inputs(rng, 12, P, TD.plane_capacity(P))
    got = tops.topk_init_batched_device(torch.from_numpy(plane), lists, k,
                                        mode="torch")
    want = rops.topk_init_batched_device(
        jnp.asarray(plane), _dense_mask(lists, P).T, k, mode="ref")
    np.testing.assert_array_equal(got, want)
    assert (got[0] == -np.inf).all()            # the query with no candidate


def threshold_topk(plane, lists, k):
    """The argument the card's kernel rests on, in numpy: t is the k-th
    largest row head of a query's candidates (-inf with fewer than k);
    only the rows whose head is above t hold values above t, fewer than k
    of them; the heap is their values above t, descending, then t (each
    value equal to t is counted, never gathered)."""
    heap = np.full((len(lists), k), -np.inf, dtype=np.float32)
    for q, ids in enumerate(lists):
        heads = plane[ids, 0]
        t = np.sort(heads)[::-1][k - 1] if len(ids) >= k else np.float32(
            -np.inf)
        rows = plane[ids[heads > t]]
        assert len(rows) < k
        vals = np.sort(rows[rows > t])[::-1][:k]
        heap[q] = t
        heap[q, :len(vals)] = vals
    return heap


@pytest.mark.parametrize("edge", TOPK_EDGES)
@pytest.mark.parametrize("k", [1, 3, 64, 128])
def test_topk_threshold_argument_equals_reference(edge, k):
    """The threshold argument, exactly against the JAX oracle (the CSR
    lists as its dense [P, Q] mask, which cannot repeat an id) and the
    port's plain version (which counts a repeated id twice).  Exactly:
    every value equal, with -0.0 equal to 0.0 (which of the two a sort
    puts first is not defined, on either side)."""
    rng = np.random.default_rng(TOPK_EDGES.index(edge) * 1000 + k)
    P = 150
    plane, lists = topk_edge_inputs(rng, edge, P)
    got = threshold_topk(plane, lists, k)
    offsets, ids = tops.pack_candidates(lists)
    plain = tref.topk_init_batched_ref(*_t(plane, offsets, ids), k).numpy()
    np.testing.assert_array_equal(got, plain)
    if edge != "duplicates":
        oracle = np.asarray(rref.topk_init_batched_ref(
            jnp.asarray(plane), jnp.asarray(_dense_mask(lists, P)), k))
        np.testing.assert_array_equal(got, oracle)
    assert (got[0] == -np.inf).all()            # the query with no candidate


def test_build_block_topk_equals_reference():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=500) * 1e6
    vals[rng.random(500) < 0.05] = np.nan
    bounds = np.concatenate([[0], np.sort(rng.integers(0, 520, 40)), [500]])
    mask = rng.random(500) < 0.8
    for k in (1, 4, 64):
        for m in (None, mask):
            got = tops.build_block_topk(vals, bounds, k, mask=m)
            want = rops.build_block_topk(vals, bounds, k, mask=m)
            assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("sizes", ["uniform", "near_uniform", "skewed",
                                   "overrun"])
def test_build_block_topk_row_sort_equals_reference(sizes):
    """Partitions of near-equal size take a row sort of a padded matrix,
    skewed ones the segmented sort: both give the reference's rows, with
    ties of +0 and -0, -inf values, NaN and masked rows."""
    rng = np.random.default_rng(3)
    P = 60
    if sizes == "uniform":
        counts = np.full(P, 16)
    elif sizes == "near_uniform":
        counts = rng.integers(10, 17, P)
    elif sizes == "skewed":
        counts = rng.integers(0, 3, P)
        counts[7] = 400
    else:
        counts = np.full(P, 16)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    n = int(bounds[-1])
    vals = rng.integers(-5, 5, n).astype(np.float64)
    vals[rng.random(n) < 0.1] = -0.0
    vals[rng.random(n) < 0.05] = -np.inf
    vals[rng.random(n) < 0.05] = np.nan
    if sizes == "overrun":
        vals = vals[:n - 20]               # bounds past the last row
    mask = rng.random(vals.size) < 0.8
    for k in (1, 4, 16, 64):
        for m in (None, mask):
            got = tops.build_block_topk(vals, bounds, k, mask=m)
            want = np.asarray(rops.build_block_topk(vals, bounds, k, mask=m))
            assert got.tobytes() == want.tobytes(), (k, m is None)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 1024, 1025, 4096])
def test_join_buckets_equal_reference(n):
    assert tops.d_bucket(n) == rops.d_bucket(n)
    assert tops.bloom_bucket(n) == rops.bloom_bucket(n)
    assert tops.BLOOM_MAX_BLOCKS == rops.BLOOM_MAX_BLOCKS


# ---------------------------------------------------------------------------
# the three wrappers on the CPU
# ---------------------------------------------------------------------------

def _wrapper_args(kernel, rng, P=40):
    cap = TD.plane_capacity(P)
    if kernel == "join_overlap_batched":
        pmin, pmax, lists = join_inputs(rng, 4, P, cap)
        return (join_overlap_batched, _t(tops.pack_distinct(lists), pmin,
                                         pmax), dict(num_partitions=P),
                lambda a, kw: tref.join_overlap_batched_ref(*a, **kw))
    if kernel == "bloom_probe_batched":
        blooms, pmin, _w, weff = bloom_inputs(rng, 4, P, cap)
        return (bloom_probe_batched, _t(tops.pack_blooms(blooms), pmin,
                                        weff), dict(num_partitions=P),
                lambda a, kw: tref.bloom_probe_batched_ref(*a, **kw))
    plane, lists = topk_inputs(rng, 4, P, cap)
    return (topk_init_batched,
            _t(plane, *tops.pack_candidates(lists)) + [5], {},
            lambda a, kw: tref.topk_init_batched_ref(*a))


KERNELS = ["join_overlap_batched", "bloom_probe_batched", "topk_init_batched"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_new_wrappers_run_plain_version_on_cpu_and_count_no_launch(kernel):
    fn, args, kw, plain = _wrapper_args(kernel, np.random.default_rng(11))
    before = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == before
    torch.testing.assert_close(got, plain(args, kw), rtol=0, atol=0)


@pytest.mark.parametrize("kernel,bad", [
    (k, b) for k in KERNELS for b in ("dtype", "shape", "contiguous", "p")
])
def test_new_wrappers_reject_what_the_kernel_does_not_take(kernel, bad):
    fn, args, kw, _ = _wrapper_args(kernel, np.random.default_rng(12))
    args = list(args)
    if bad == "dtype":
        args[1] = args[1].double() if kernel != "topk_init_batched" \
            else args[1].int()
    elif bad == "shape" and kernel == "topk_init_batched":
        args[0] = args[0].reshape(-1)       # rows must be [Pc, K]
    elif bad == "shape":
        args[2] = args[2][:-1].contiguous()
    elif bad == "contiguous":
        args[0] = torch.cat([args[0], args[0]], -1)[..., ::2]
    elif kernel == "topk_init_batched":
        args[3] = 129                       # k above the kernel's heap
    else:
        kw = dict(num_partitions=int(args[1].shape[0]) + 1)
    with pytest.raises(KernelError):
        fn(*args, **kw)


def test_bloom_wrapper_rejects_a_non_power_of_two_filter():
    fn, args, kw, _ = _wrapper_args("bloom_probe_batched",
                                    np.random.default_rng(13))
    words = torch.cat([args[0], args[0][:, :16]], 1)       # 3 blocks of 16
    with pytest.raises(KernelError, match="power-of-two"):
        fn(words, *args[1:], **kw)


@pytest.mark.parametrize("bad", ["id_high", "id_negative", "offsets_end",
                                 "offsets_order"])
def test_topk_wrapper_rejects_candidates_outside_the_plane(bad):
    fn, (plane, offsets, ids, k), _kw, _ = _wrapper_args(
        "topk_init_batched", np.random.default_rng(14))
    ids, offsets = ids.clone(), offsets.clone()
    if bad == "id_high":
        ids[-1] = plane.shape[0]
    elif bad == "id_negative":
        ids[0] = -1
    elif bad == "offsets_end":
        offsets[-1] += 1
    else:
        offsets[1] = int(offsets[2]) + 1        # a list ending before it starts
    with pytest.raises(KernelError, match="CSR"):
        fn(plane, offsets, ids, k)


@pytest.mark.parametrize("arg", [2 ** 31, -2 ** 31 - 1])
def test_launch_rejects_an_argument_outside_int32(monkeypatch, arg):
    """``build.launch`` refuses a dimension the kernel's ``int`` would
    truncate, before it reaches the entry point or the card."""
    from repro_torch.kernels import build
    called = []
    monkeypatch.setattr(build, "entry", lambda name: called.append(name))
    with pytest.raises(KernelError, match="int32"):
        build.launch("minmax_prune_batched", torch.device("cpu"),
                     torch.zeros(1), 3, arg)
    assert not called


@pytest.mark.parametrize("device,kernel", [("cpu", False), ("meta", None)])
def test_runs_kernel_by_device(device, kernel):
    """The wrappers' one dispatch: the plain version on the CPU, the
    kernel on CUDA (tested on the card), any other device refused."""
    from repro_torch.kernels import build
    if kernel is None:
        with pytest.raises(KernelError, match="unsupported device"):
            build.runs_kernel(torch.device(device))
    else:
        assert build.runs_kernel(torch.device(device)) is kernel
