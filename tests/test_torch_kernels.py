"""The batched pruning kernel's plain PyTorch version against the JAX
package: its jnp oracle and its Pallas kernel in interpret mode.

Verdicts are integers, so the tolerance is exact equality everywhere.
Shapes stay small (P <= 2048 and Q <= 16 through Pallas interpret mode).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import device_stats as RD
from repro.core import metadata as RM
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.minmax_prune_batched import \
    minmax_prune_batched as pallas_minmax_prune_batched

from repro_torch.core import device_stats as TD
from repro_torch.core import metadata as TM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched

torch.set_num_threads(1)

tmpb = importlib.import_module("repro_torch.kernels.minmax_prune_batched")

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
    before = tmpb.minmax_prune_batched.launches
    got = minmax_prune_batched(*arrays, num_partitions=33)
    assert tmpb.minmax_prune_batched.launches == before
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
