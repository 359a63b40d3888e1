"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and the CUDA compiler; without a card
each one skips (a skip is no pass: on a machine without a GPU the kernels
are checked only by ``chip_smoke.py`` on the card).  Every comparison is
exact: the kernels return verdicts and selected values, no arithmetic
that could round differently.  The input generators here carry no JAX,
so the CPU tests of ``test_torch_kernels.py`` reuse them.  Run these on
the card with

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import device_stats as TD
from repro_torch.core.metadata import ColumnMeta, PartitionStats
from repro_torch.core.prune_join import BlockedBloom
from repro_torch.kernels import build, ops
from repro_torch.kernels.bloom_probe import bloom_probe_batched
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.join_overlap import join_overlap_batched
from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
from repro_torch.kernels.ref import (bloom_probe_batched_ref,
                                    join_overlap_batched_ref,
                                    minmax_prune_batched_ref,
                                    topk_init_batched_ref)
from repro_torch.kernels.topk_boundary import topk_init_batched
from repro_torch.kernels.join_overlap import join_overlap
from repro_torch.kernels import join_overlap as join_mod
from repro_torch.kernels import minmax_prune as minmax_mod
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import topk_boundary as topk_mod
from repro_torch.kernels.minmax_prune import minmax_prune
from repro_torch.kernels.ref import (join_overlap_ref, minmax_prune_ref,
                                    topk_boundary_ref,
                                    topk_boundary_tiled_ref)
from repro_torch.kernels.topk_boundary import MAX_K_SCAN, topk_boundary

F32_MAX = np.float32(np.finfo(np.float32).max)
WRAPPERS = {f.__name__: f for f in (join_overlap_batched, bloom_probe_batched,
                                    topk_init_batched)}
DENORMALS = np.array([1e-45, 1e-40, 1.1754942e-38, -1e-45, -1e-40, 0.0,
                      -0.0], dtype=np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, Q, Kb, C, P, cap):
    mins = rng.integers(-100, 100, (C, cap)).astype(np.float32)
    maxs = mins + rng.integers(0, 40, (C, cap)).astype(np.float32)
    demote = (rng.random((C, cap)) < 0.3).astype(np.float32)
    drop = rng.random((C, cap)) < 0.1
    drop[:, P:] = True
    mins[drop], maxs[drop], demote[drop] = F32_MAX, -F32_MAX, 1.0
    cids = rng.integers(0, C, (Q, Kb)).astype(np.int32)
    lo = rng.integers(-120, 120, (Q, Kb)).astype(np.float32)
    hi = lo + rng.integers(0, 60, (Q, Kb)).astype(np.float32)
    noop = rng.random((Q, Kb)) < 0.25
    lo[noop], hi[noop] = -np.inf, np.inf
    lo[0, 0] = np.float32(1e-45)                 # a denormal bound
    return cids, lo, hi, mins, maxs, demote


def join_inputs(rng, Q, P, cap, max_keys=200):
    """A join-key plane ([cap] f32 rows, drop sentinels inside P and in
    the capacity tail) and Q sorted distinct key lists, some of them
    holding a partition's exact bounds."""
    pmin = rng.integers(-5000, 10_000, cap).astype(np.float32)
    pmax = pmin + rng.integers(0, 100, cap).astype(np.float32)
    drop = rng.random(cap) < 0.1
    drop[P:] = True
    pmin[drop], pmax[drop] = F32_MAX, -F32_MAX
    lists = []
    for qi in range(Q):
        keys = rng.integers(-5000, 10_000, int(rng.integers(1, max_keys + 1)))
        if qi % 3 == 0 and P:
            p = int(rng.integers(0, P))
            keys = np.append(keys, [pmin[p], pmax[p]])   # inclusive ends
        lists.append(np.unique(keys).astype(np.float32))
    return pmin, pmax, lists


def bloom_inputs(rng, Q, P, cap, n_blocks=(1, 8, 256, 1024), limit=64):
    """Q blocked-Bloom filters of the given block counts and an
    enumeration plane: widths 0 (keep), within and above ``limit``,
    negative candidates, and candidates at both ends of int32."""
    blooms = []
    for qi in range(Q):
        nb = n_blocks[qi % len(n_blocks)]
        b = BlockedBloom(nb * 32)          # 16 bits per key: nb blocks
        assert b.n_blocks == nb
        b.add(rng.integers(-3000, 3000, nb * 32))
        blooms.append(b)
    pmin = rng.integers(-3000, 3000, cap).astype(np.int32)
    width = rng.integers(0, 40, cap).astype(np.int32)
    width[rng.random(cap) < 0.1] = 0
    width[rng.random(cap) < 0.05] = 2 * limit               # too wide
    if P >= 2:
        pmin[0], width[0] = np.iinfo(np.int32).min, 7
        pmin[1], width[1] = np.iinfo(np.int32).max - 9, 10
    width[P:] = 0
    width_eff = np.where(width <= limit, width, 0).astype(np.int32)
    return blooms, pmin, width, width_eff


def topk_inputs(rng, Q, P, cap, K=TD.KPLANE):
    """A [cap, K] block-top-k plane (rows descending, -inf padded, ties,
    all -inf rows) and Q candidate lists: empty, all, and random subsets
    of [0, P)."""
    plane = np.full((cap, K), -np.inf, dtype=np.float32)
    for p in range(P):
        n = int(rng.integers(0, K + 1)) if rng.random() < 0.9 else 0
        plane[p, :n] = -np.sort(-rng.integers(-60, 60, n).astype(np.float32))
    lists = []
    for qi in range(Q):
        if qi == 0:
            lists.append(np.zeros(0, dtype=np.int32))
        elif qi == 1:
            lists.append(np.arange(P, dtype=np.int32))
        else:
            keep = rng.random(P) < rng.choice([0.001, 0.05, 0.5])
            lists.append(np.nonzero(keep)[0].astype(np.int32))
    return plane, lists


TOPK_EDGES = ("equal_heads", "equal_values", "neg_inf_rows", "empty",
              "duplicates", "few_values", "signed_zeros")


def topk_edge_inputs(rng, edge, P, Q=6, K=TD.KPLANE):
    """A [P, K] block-top-k plane and Q candidate lists (the first empty,
    the second all of [0, P)) at one of ``TOPK_EDGES``: every row head
    equal, every finite value equal, mostly all -inf rows, all but one
    query empty, lists that repeat ids, rows of at most 2 values (a query
    holds fewer than k), values of both signed zeros."""
    plane = np.full((P, K), -np.inf, dtype=np.float32)
    for p in range(P):
        n = int(rng.integers(0, K + 1))
        if edge == "few_values":
            n = int(rng.integers(0, 3))
        vals = rng.integers(-60, 60, n).astype(np.float32)
        if edge == "equal_heads" and n:
            vals = np.append(np.float32(7.0), np.minimum(vals[1:], 6.0))
        elif edge == "equal_values":
            vals[:] = 3.0
        elif edge == "neg_inf_rows" and rng.random() < 0.8:
            vals = vals[:0]
        elif edge == "signed_zeros":
            vals = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), n)
        plane[p, :len(vals)] = -np.sort(-vals)
    lists = [np.zeros(0, dtype=np.int32), np.arange(P, dtype=np.int32)]
    for _ in range(Q - 2):
        if edge == "empty":
            ids = np.zeros(0, dtype=np.int64)
        elif edge == "duplicates":
            ids = rng.integers(0, P, int(rng.integers(1, 3 * P)))
        else:
            ids = np.nonzero(rng.random(P) < rng.choice([0.01, 0.3, 0.9]))[0]
        lists.append(ids.astype(np.int32))
    if edge == "empty":
        lists[1] = lists[1][:0]
        lists[-1] = np.arange(0, P, 3, dtype=np.int32)
    return plane, lists


def range_problem(rng, K, P, edges=False, denormals=False):
    """One conjunction of K ranges over [K, P] pre-gathered stats, as the
    JAX suite draws them (``tests/test_kernels.py`` ``range_problems``:
    10% empty intervals (+inf, -inf), 20% nullable).  ``edges`` adds
    bounds equal to a partition's stat, ``denormals`` denormal stats and
    bounds (compared with the IEEE plain version only: XLA on the CPU
    flushes denormals to zero); a long conjunction (K > 64) keeps most of
    its ranges wide, so verdicts survive to its last constraint."""
    mins = rng.uniform(-100, 100, size=(K, P)).astype(np.float32)
    maxs = mins + rng.uniform(0, 50, size=(K, P)).astype(np.float32)
    empty = rng.random((K, P)) < 0.1
    mins = np.where(empty, np.inf, mins).astype(np.float32)
    maxs = np.where(empty, -np.inf, maxs).astype(np.float32)
    nullable = (rng.random((K, P)) < 0.2).astype(np.float32)
    lo = rng.uniform(-120, 120, size=K).astype(np.float32)
    hi = lo + rng.uniform(0, 100, size=K).astype(np.float32)
    if K > 64:
        wide = rng.random(K) < 0.98
        lo[wide], hi[wide] = -1000.0, 1000.0
    if denormals:
        den = rng.random((K, P)) < 0.05
        mins[den] = rng.choice(DENORMALS, int(den.sum()))
        maxs[den] = np.maximum(mins[den],
                               rng.choice(DENORMALS, int(den.sum())))
        lo[0] = DENORMALS[0]
    if edges:
        pick = rng.integers(0, P, K)
        eq = (rng.random(K) < 0.3) & ~empty[np.arange(K), pick]
        lo[eq] = mins[eq, pick[eq]]
        eq = (rng.random(K) < 0.3) & ~empty[np.arange(K), pick]
        hi[eq] = np.maximum(lo[eq], maxs[eq, pick[eq]])
    return lo, hi, mins, maxs, nullable


def overlap_problem(rng, P, D, edges=False, denormals=False):
    """[P] partition intervals and a sorted distinct key list of at most D
    keys, as the JAX suite draws them (``overlap_problems``: 5% empty
    intervals (+inf, -inf)).  ``edges`` adds keys on a partition's bounds
    and keys at both infinities, ``denormals`` denormal intervals and
    keys."""
    pmin = rng.integers(0, 10_000, size=P).astype(np.float32)
    pmax = pmin + rng.integers(0, 100, size=P).astype(np.float32)
    empty = rng.random(P) < 0.05
    pmin = np.where(empty, np.inf, pmin).astype(np.float32)
    pmax = np.where(empty, -np.inf, pmax).astype(np.float32)
    keys = rng.integers(0, 10_000, size=D).astype(np.float32)
    if edges:
        live = np.nonzero(~empty)[0]
        if live.size:
            p = rng.choice(live, min(4, live.size))
            keys = np.concatenate([keys, pmin[p], pmax[p]])
        keys = np.concatenate([keys, [-np.inf, np.inf]])
    if denormals:
        den = rng.random(P) < 0.05
        pmin[den] = rng.choice(DENORMALS[3:], int(den.sum()))
        pmax[den] = rng.choice(DENORMALS[:3], int(den.sum()))
        keys = np.concatenate([keys, DENORMALS[:2]])
    return pmin, pmax, np.unique(keys)[:max(D, 1)].astype(np.float32)


def clustered_plane(rng, P, cap, sentinel, empty_run=(0, 0), drop=0.05):
    """A join-key plane like the events table's ``user_id`` one: nearly
    sorted intervals at most 40 ids wide over a running sum of small
    steps, a ``drop`` share and the partitions of ``empty_run`` (a
    [start, stop) range: all-empty tiles) set to the empty interval
    (``sentinel``, -``sentinel``), and the capacity tail too."""
    start = np.cumsum(rng.integers(0, 4, cap)) + rng.integers(-2, 3, cap)
    pmin = start.astype(np.float32)
    pmax = (start + rng.integers(0, 41, cap)).astype(np.float32)
    gone = rng.random(cap) < drop
    gone[empty_run[0]:empty_run[1]] = True
    gone[P:] = True
    pmin[gone], pmax[gone] = sentinel, -sentinel
    return pmin, pmax


def clustered_keys(rng, pmin, pmax, P, n, tile=None):
    """A sorted distinct key list of at most ``n`` ids drawn over the live
    range of the first P intervals, plus, with ``tile``, the min pmin and
    max pmax of a tile of that many partitions (keys on its window's
    edges)."""
    live = pmin[:P] <= pmax[:P]
    if not live.any():
        return np.array([1.0], np.float32)
    lo, hi = float(pmin[:P][live].min()), float(pmax[:P][live].max())
    keys = rng.integers(int(lo) - 50, int(hi) + 50, n)
    if tile:
        t = int(rng.integers(0, -(-P // tile)))
        s = slice(t * tile, min((t + 1) * tile, P))
        if live[s].any():
            keys = np.append(keys, [pmin[s][live[s]].min(),
                                    pmax[s][live[s]].max()])
    return np.unique(keys).astype(np.float32)


def window_problem(rng, sizes, tile, sentinel):
    """Intervals [len(sizes) * tile] and the sorted keys 0, 1, 2, ... such
    that tile i's key window (the keys inside its [min pmin, max pmax])
    holds exactly sizes[i] keys: its first partition spans the window,
    the others lie inside it, 10% are empty (``sentinel``); a window of 0
    lies between two keys."""
    pmin = np.empty(len(sizes) * tile, np.float32)
    pmax = np.empty_like(pmin)
    at = 0
    for i, w in enumerate(sizes):
        s = slice(i * tile, (i + 1) * tile)
        if w == 0:
            pmin[s], pmax[s] = at + 0.25, at + 0.75
        else:
            lo = at + rng.integers(0, w, tile)
            pmin[s] = lo
            pmax[s] = np.minimum(lo + rng.integers(0, 40, tile), at + w - 1)
            pmin[i * tile], pmax[i * tile] = at, at + w - 1
            empty = rng.random(tile) < 0.1
            empty[0] = False
            pmin[s][empty], pmax[s][empty] = sentinel, -sentinel
        at += w + 1
    return pmin, pmax, np.arange(at, dtype=np.float32)


def topk_problem(rng, P, k, valid_binit=False, order="random", lo=-1000,
                 hi=1000):
    """(rows [P, k], b_init) as the JAX suite draws them
    (``topk_problems``): integer rows in [lo, hi) (a narrow range makes
    ties), each cut to a random count and -inf padded, sorted descending;
    ``b_init`` from {-inf, -500, 0, 500}, or with ``valid_binit`` a
    witnessed boundary (k values >= it exist).  ``order`` is "random",
    "descending" (by row head, the scan's sort strategy) or "ascending"
    (strictly rising heads: every row merges)."""
    rows = rng.integers(lo, hi, size=(P, k)).astype(np.float32)
    fill = rng.integers(0, k + 1, size=P)
    rows[np.arange(k)[None, :] >= fill[:, None]] = -np.inf
    rows = -np.sort(-rows, axis=1)
    if order == "descending":
        rows = rows[np.argsort(-rows[:, 0], kind="stable")]
    elif order == "ascending":
        rows = (2.0 * np.arange(P, dtype=np.float32))[:, None] \
            - np.arange(k, dtype=np.float32)[None, :]
    if valid_binit:
        finite = np.sort(rows[np.isfinite(rows)])[::-1]
        kth = finite[k - 1] if len(finite) >= k else -np.inf
        binit = rng.choice([-np.inf, float(kth), float(kth) - 10.0])
    else:
        binit = rng.choice([-np.inf, -500.0, 0.0, 500.0])
    return np.ascontiguousarray(rows, dtype=np.float32), np.float32(binit)


@pytest.mark.parametrize("Q,Kb,C,P,cap", [
    (1, 1, 1, 1, None), (7, 2, 6, 31, None), (64, 4, 6, 4097, None),
    (300, 8, 33, 5000, None),
    # conjunctions longer than the kernel's 1024-slot shared tile
    (3, 3000, 6, 700, None), (2, 8192, 6, 4097, None),
    # P = 1, 3, 15 mod 16: rows of tv off a 4-byte boundary
    (5, 2, 6, 4097, None), (9, 3, 6, 4099, None), (64, 2, 6, 4111, None),
    # capacities P + 3: plane rows off a 16-byte boundary
    (7, 4, 6, 4097, 4100), (33, 2, 6, 100_000, 100_003),
    # more slots than the tile, in single-range queries
    (1100, 1, 6, 1000, None),
    # more referenced columns than the 4-column shared tile, and than the
    # 1024-column map (every slot from global memory)
    (40, 8, 33, 2049, 2052), (3, 5, 1100, 37, 40),
])
def test_kernel_equals_plain_version(cuda, Q, Kb, C, P, cap):
    rng = np.random.default_rng(P)
    cap = cap or TD.plane_capacity(P)
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(rng, Q, Kb, C, P, cap)]
    before = minmax_prune_batched.launches
    got = minmax_prune_batched(*args, num_partitions=P)
    torch.cuda.synchronize()
    assert minmax_prune_batched.launches == before + 1
    want = minmax_prune_batched_ref(*args, num_partitions=P)
    assert got.dtype == torch.int8 and tuple(got.shape) == (Q, P)
    assert torch.equal(got, want)


def packed_planes(planes, gaps, dev):
    """The three [C, Pc] planes as contiguous views of one flat tensor,
    plane i starting gaps[i] elements after the end of plane i - 1: storage
    offsets that differ mod 16 bytes, as for views of one [3, C, Pc]
    tensor with C * Pc odd."""
    n = planes[0].size
    flat = torch.empty(sum(gaps) + 3 * n, dtype=torch.float32, device=dev)
    out, at = [], 0
    for a, gap in zip(planes, gaps):
        at += gap
        out.append(flat[at:at + n].view(a.shape))
        out[-1].copy_(torch.from_numpy(a))
        at += n
    return out


@pytest.mark.parametrize("Q,Kb,C,P,cap,gaps", [
    # mins 16-byte aligned, maxs and demote not: staged columns
    (64, 3, 6, 4096, None, (0, 1, 3)),
    # views of one [3, C, Pc] tensor with C * Pc odd
    (7, 2, 3, 4096, 4099, (0, 0, 0)),
    # more referenced columns than the shared tile: read from global
    (40, 8, 33, 2049, None, (0, 2, 1)),
])
def test_kernel_equals_plain_version_at_plane_offsets(cuda, Q, Kb, C, P,
                                                      cap, gaps):
    rng = np.random.default_rng(P + sum(gaps))
    cap = cap or TD.plane_capacity(P)
    cids, lo, hi, *planes = _inputs(rng, Q, Kb, C, P, cap)
    mins, maxs, demote = packed_planes(planes, gaps, cuda)
    assert len({t.data_ptr() % 16 for t in (mins, maxs, demote)}) > 1
    cq = [torch.from_numpy(a).to(cuda) for a in (cids, lo, hi)]
    got = minmax_prune_batched(*cq, mins, maxs, demote, num_partitions=P)
    torch.cuda.synchronize()
    want = minmax_prune_batched_ref(*cq, mins, maxs, demote,
                                    num_partitions=P)
    assert torch.equal(got, want)


def test_service_on_card_equals_cpu(cuda):
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.data.generator import make_events_table
    from repro_torch.serve.prune_service import PruningService
    ev = make_events_table(np.random.default_rng(0), n_rows=20000,
                           rows_per_partition=20)
    rng = np.random.default_rng(1)
    qs = [Query(scans={"e": TableScanSpec(
        ev, E.col("ts") >= float(rng.integers(0, 10_000_000)))},
        limit=int(rng.integers(0, 50)) if i % 2 else None)
        for i in range(32)]
    got = PruningService().run_batch(qs)
    want = PruningService(device="cpu").run_batch(qs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.scan_sets["e"].part_ids,
                                      w.scan_sets["e"].part_ids)
        np.testing.assert_array_equal(g.scan_sets["e"].match,
                                      w.scan_sets["e"].match)
    assert got[0].counters["technique"]["filter"]["launches"] == 1
    assert not any(got[0].counters["resilience"]["demotions"].values())


def test_torch_mode_refuses_cuda_planes(cuda):
    stats = PartitionStats([ColumnMeta("a", "int")], np.zeros((4, 1)),
                           np.ones((4, 1)), np.zeros((4, 1), dtype=np.int64),
                           np.ones(4, dtype=np.int64))
    dstats = TD.DeviceStats.stage(stats, device=cuda)
    with pytest.raises(ValueError):
        ops.prune_ranges_batched_device([[(0, 0.0, 1.0)]], dstats,
                                        mode="torch")


def test_launch_failure_raises_out_of_run_batch(cuda, monkeypatch):
    """A launch that returns a CUDA error raises KernelError from the
    wrapper and out of run_batch: no host rung takes the batch over."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.data.generator import make_events_table
    from repro_torch.serve.prune_service import PruningService
    ev = make_events_table(np.random.default_rng(0), n_rows=4000,
                           rows_per_partition=20)
    svc = PruningService()
    # every entry point returns cudaErrorInvalidValue
    monkeypatch.setattr(build, "entry", lambda _name: lambda *_a: 1)
    with pytest.raises(KernelError, match="cudaError 1"):
        svc.run_batch([Query(scans={"e": TableScanSpec(
            ev, E.col("ts") >= 5_000_000)})])
    assert not any(svc.resilience["demotions"].values())
    assert svc.resilience["salvaged_batches"] == 0


@pytest.mark.parametrize("Q,max_keys,P", [
    (1, 1, 1), (7, 60, 1000), (32, 4096, 100_000),
    # key rows longer than the kernel's staged capacity: searched in place
    (3, 9000, 5000),
])
def test_join_overlap_equals_plain_version(cuda, Q, max_keys, P):
    rng = np.random.default_rng(P + Q)
    cap = TD.plane_capacity(P)
    pmin, pmax, lists = join_inputs(rng, Q, P, cap, max_keys)
    dist = torch.from_numpy(ops.pack_distinct(lists)).to(cuda)
    pmin_d, pmax_d = (torch.from_numpy(a).to(cuda) for a in (pmin, pmax))
    before = join_overlap_batched.launches
    got = join_overlap_batched(dist, pmin_d, pmax_d, num_partitions=P)
    torch.cuda.synchronize()
    assert join_overlap_batched.launches == before + 1
    want = join_overlap_batched_ref(dist, pmin_d, pmax_d, num_partitions=P)
    assert got.dtype == torch.int8 and tuple(got.shape) == (Q, P)
    assert torch.equal(got, want)


def _views(arrays, offset, dev):
    """The 1-D arrays as consecutive views of one device buffer, the first
    starting ``offset`` floats in (off 16 bytes for offset 1-3)."""
    n = sum(a.size for a in arrays)
    buf = torch.zeros(offset + n, device=dev)
    out, at = [], offset
    for a in arrays:
        out.append(buf[at:at + a.size])
        out[-1].copy_(torch.from_numpy(a))
        at += a.size
    return out


@pytest.mark.parametrize("Q,P,cap,offset,n_keys", [
    (5, 4097, None, 0, 60), (5, 4098, None, 0, 60),    # P = 1, 2 mod 4
    (5, 4099, None, 0, 60),                             # P = 3 mod 4
    (4, 100_000, None, 1, 400), (3, 5000, None, 2, 40),  # rows off 16 bytes
    (6, 5001, 8192, 3, 200),    # num_partitions < Pc, not a multiple of 4
    (70, 20_000, None, 0, 80),  # more queries than a block's chunk
    (16, 1 << 20, None, 0, 3000),   # phase 3's shape
])
def test_join_overlap_batched_clustered_alignment(cuda, Q, P, cap, offset,
                                                  n_keys):
    """The windowed kernel on clustered planes (mostly empty windows, an
    all-empty run of tiles) where the rows are not 16-byte aligned: P not
    a multiple of 4 (the output rows after the first start off 4 and 16
    bytes), the plane rows as views at an odd offset, a logical P inside
    a larger capacity, and more queries than a block holds at once;
    equal to the plain version and to the windowed one."""
    rng = np.random.default_rng(Q * 31 + P + offset)
    cap = cap or TD.plane_capacity(P)
    tile = ref_mod.JOIN_TILE_BATCHED
    t0 = (P // 3) // tile * tile
    pmin, pmax = clustered_plane(rng, P, cap, F32_MAX,
                                 empty_run=(t0, t0 + 2 * tile))
    lists = [clustered_keys(rng, pmin, pmax, P, n_keys, tile)
             for _ in range(Q)]
    dist = torch.from_numpy(ops.pack_distinct(lists)).to(cuda)
    pmin_d, pmax_d = _views((pmin, pmax), offset, cuda)
    assert (pmin_d.data_ptr() % 16 != 0) == (offset != 0)
    got = join_overlap_batched(dist, pmin_d, pmax_d, num_partitions=P)
    torch.cuda.synchronize()
    want = join_overlap_batched_ref(dist, pmin_d, pmax_d, num_partitions=P)
    assert torch.equal(got, want)
    assert torch.equal(got, ref_mod.join_overlap_windowed_ref(
        dist, pmin_d, pmax_d, tile, num_partitions=P))
    a, b = ref_mod.join_windows(dist, pmin_d, pmax_d, tile, P)
    assert (b <= a).any()


@pytest.mark.parametrize("sizes,Q", [
    ((0, 1, 32, 33, 1023, 1024, 4096, 4097), 3),
    ((5000, 0, 4096, 64, 1, 0, 2000, 40), 70),   # Q over the chunk
])
def test_join_overlap_batched_window_paths(cuda, sizes, Q):
    """Tiles whose key windows take each path of the kernel: empty (zeros,
    no search), held in a warp's lanes, staged in shared memory, and
    searched in place (below the least staged window and past the
    capacity); keys on every tile's min and max."""
    rng = np.random.default_rng(len(sizes) + Q)
    tile = ref_mod.JOIN_TILE_BATCHED
    pmin, pmax, keys = window_problem(rng, sizes, tile, F32_MAX)
    P = pmin.size
    cap = TD.plane_capacity(P)
    pmin = np.concatenate([pmin, np.full(cap - P, F32_MAX, np.float32)])
    pmax = np.concatenate([pmax, np.full(cap - P, -F32_MAX, np.float32)])
    lists = [keys[int(rng.integers(0, 3)):][::int(rng.integers(1, 3))]
             for _ in range(Q - 1)] + [keys]
    dist = torch.from_numpy(ops.pack_distinct(lists)).to(cuda)
    pmin_d, pmax_d = (torch.from_numpy(a).to(cuda) for a in (pmin, pmax))
    a, b = ref_mod.join_windows(dist, pmin_d, pmax_d, tile, P)
    assert (b - a)[-1].tolist() == list(sizes)
    paths = ref_mod.window_paths(a, b)
    assert min(paths.values()) > 0, paths
    got = join_overlap_batched(dist, pmin_d, pmax_d, num_partitions=P)
    torch.cuda.synchronize()
    assert torch.equal(got, join_overlap_batched_ref(dist, pmin_d, pmax_d,
                                                     num_partitions=P))


def test_join_overlap_batched_random_plane_nan_and_denormals(cuda):
    """A random plane (every window the whole row) with denormal bounds
    and keys, and a NaN bound (outside the plane's contract): equal to
    the plain version, whose search the widened window keeps."""
    rng = np.random.default_rng(17)
    P, Q = 70_000, 9
    cap = TD.plane_capacity(P)
    pmin, pmax, lists = join_inputs(rng, Q, P, cap, 5000)
    den = rng.random(P) < 0.02
    pmin[:P][den], pmax[:P][den] = -DENORMALS[1], DENORMALS[0]
    lists[0] = np.unique(np.concatenate([lists[0], DENORMALS[:2]])
                         ).astype(np.float32)
    pmin[4000], pmax[9000] = np.nan, np.nan
    dist = torch.from_numpy(ops.pack_distinct(lists)).to(cuda)
    pmin_d, pmax_d = (torch.from_numpy(a).to(cuda) for a in (pmin, pmax))
    got = join_overlap_batched(dist, pmin_d, pmax_d, num_partitions=P)
    torch.cuda.synchronize()
    assert torch.equal(got, join_overlap_batched_ref(dist, pmin_d, pmax_d,
                                                     num_partitions=P))


@pytest.mark.parametrize("Q,P,n_blocks,edge", [
    (1, 1, (1,), None), (4, 3000, (1, 8, 256, 1024), None),
    (33, 20_000, (8, 1024), None), (70, 5000, (256,), None),
    # 8-, 16- and 32-query tables at 64, 256 and 1024 blocks
    (8, 3000, (256,), None), (32, 3000, (64,), None),
    (16, 5000, (256,), None), (16, 3000, (1024,), None),
    (1, 3000, (1024,), None), (32, 3000, (256,), None),
    # every width 0; one very wide partition among narrow ones in a warp
    (16, 3000, (256,), "zero"), (33, 3000, (64,), "wide"),
    (16, 3000, (1024,), "wide"),
])
def test_bloom_probe_equals_plain_version(cuda, Q, P, n_blocks, edge):
    rng = np.random.default_rng(P + Q)
    cap = TD.plane_capacity(P)
    blooms, pmin, _width, width_eff = bloom_inputs(rng, Q, P, cap, n_blocks)
    if edge == "zero":
        width_eff[:] = 0
    elif edge == "wide":
        width_eff[32:64] = rng.integers(0, 3, 32)
        width_eff[45], pmin[45] = 20_000, -10_000
    words = torch.from_numpy(ops.pack_blooms(blooms)).to(cuda)
    pmin_d, width_d = (torch.from_numpy(a).to(cuda)
                       for a in (pmin, width_eff))
    before = bloom_probe_batched.launches
    got = bloom_probe_batched(words, pmin_d, width_d, num_partitions=P)
    torch.cuda.synchronize()
    assert bloom_probe_batched.launches == before + 1
    want = bloom_probe_batched_ref(words, pmin_d, width_d, num_partitions=P)
    assert got.dtype == torch.int8 and tuple(got.shape) == (Q, P)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Q,P,k", [
    (3, 1, 1), (6, 700, 3), (9, 5000, 64), (5, 20_000, 128),
    # long candidate lists: many slabs per query, one histogram a query
    (3, 600_000, 128),
])
def test_topk_init_equals_plain_version(cuda, Q, P, k):
    rng = np.random.default_rng(P + k)
    cap = TD.plane_capacity(P)
    plane, lists = topk_inputs(rng, Q, P, cap)
    offsets, ids = ops.pack_candidates(lists)
    args = (torch.from_numpy(plane).to(cuda),
            torch.from_numpy(offsets).to(cuda), torch.from_numpy(ids).to(cuda))
    before = topk_init_batched.launches
    got = topk_init_batched(*args, k)
    torch.cuda.synchronize()
    assert topk_init_batched.launches == before + 1
    want = topk_init_batched_ref(*args, k)
    assert tuple(got.shape) == (Q, k)
    assert torch.equal(got, want)


def _build_sides(case: str, rng) -> list:
    """Build sides for ``bloom_build``: Q3-sized sparse keys, heavy
    duplicates, NDV at and over the 4,096 limit, int64's ends and the key
    -1 (the hash set's empty slot), and all of them in one batch."""
    i64 = np.iinfo(np.int64)
    sides = {
        "q3": [rng.permutation(np.unique(rng.integers(1, 6_000_000_001,
                                                      252_000)))[:250_000]],
        "duplicates": [rng.integers(0, 3000, 100_000)],
        "ndv_at_limit": [np.repeat(rng.choice(10 ** 12, 4096,
                                              replace=False), 3)],
        "ndv_over_limit": [np.repeat(rng.choice(10 ** 12, 4097,
                                                replace=False), 3)],
        "extreme": [np.concatenate([np.tile([i64.min, i64.max, -1, 0], 50),
                                    -rng.integers(1, 2 ** 62, 9000)]),
                    np.tile(np.array([i64.min, -1, i64.max]), 9)],
    }
    if case == "batch":
        return [k for c in sides.values() for k in c]
    return sides[case]


@pytest.mark.parametrize("case", ["q3", "duplicates", "ndv_at_limit",
                                  "ndv_over_limit", "extreme", "batch"])
def test_bloom_build_equals_plain_version(cuda, case):
    from repro_torch.core.prune_join import summarize_build
    from repro_torch.kernels import bloom_build as bb

    sides = [np.asarray(k, dtype=np.int64)
             for k in _build_sides(case, np.random.default_rng(len(case)))]
    plan = bb.plan_builds([k.size for k in sides], 4096, 16)
    staged = torch.from_numpy(np.concatenate([plan.reshape(-1), *sides]))
    before = bb.bloom_build.launches
    head, dist, words = bb.bloom_build(staged.to(cuda), plan, 4096, 16)
    torch.cuda.synchronize()
    assert bb.bloom_build.launches == before + 1
    want_head, want_dist, want_words = bb.bloom_build(staged, plan, 4096, 16)
    head, dist, words = head.cpu(), dist.cpu(), words.cpu()
    assert torch.equal(head[:, :5], want_head[:, :5])
    assert torch.equal(words, want_words)
    for g, ndv in enumerate(head[:, 0].tolist()):
        if ndv <= 4096:
            assert torch.equal(torch.sort(dist[g, :ndv]).values,
                               want_dist[g, :ndv])
    # and through the wrapper, field for field against numpy
    for got, keys in zip(ops.summarize_build_batched_device(sides, 4096,
                                                            device=cuda),
                         sides):
        want = summarize_build(keys, ndv_limit=4096)
        assert (got.min, got.max, got.count, got.size_bytes) == \
            (want.min, want.max, want.count, want.size_bytes)
        if want.bloom is None:
            assert np.array_equal(got.distinct, want.distinct)
        else:
            assert got.bloom.n_blocks == want.bloom.n_blocks
            assert np.array_equal(got.bloom.words, want.bloom.words)


@pytest.mark.parametrize("kernel", ["join_overlap_batched",
                                    "bloom_probe_batched",
                                    "topk_init_batched"])
def test_new_kernel_launch_failure_raises(cuda, monkeypatch, kernel):
    """Each wrapper turns a CUDA error returned by its launch into a
    KernelError and counts no launch."""
    # every entry point returns cudaErrorInvalidValue
    monkeypatch.setattr(build, "entry", lambda _name: lambda *_a: 1)
    rng = np.random.default_rng(0)
    fn = WRAPPERS[kernel]
    before = fn.launches
    if kernel == "join_overlap_batched":
        pmin, pmax, lists = join_inputs(rng, 2, 16, 16)
        args = (torch.from_numpy(ops.pack_distinct(lists)),
                torch.from_numpy(pmin), torch.from_numpy(pmax))
    elif kernel == "bloom_probe_batched":
        blooms, pmin, _w, width_eff = bloom_inputs(rng, 2, 16, 16)
        args = (torch.from_numpy(ops.pack_blooms(blooms)),
                torch.from_numpy(pmin), torch.from_numpy(width_eff))
    else:
        plane, lists = topk_inputs(rng, 3, 16, 16)
        args = (torch.from_numpy(plane),
                *(torch.from_numpy(a) for a in ops.pack_candidates(lists)), 4)
    args = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(KernelError, match="cudaError 1"):
        fn(*args)
    assert fn.launches == before


def test_mixed_service_on_card_equals_cpu(cuda):
    """Filter, JOIN (distinct and Bloom summaries) and top-k through
    run_batch on the card: identical reports to the CPU service, one
    launch per table group and stage, no demotion."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import (JoinSpec, PruningPipeline, Query,
                                       TableScanSpec)
    from repro_torch.data.generator import (make_events_table,
                                            make_users_table)
    from repro_torch.serve.prune_service import PruningService
    ev = make_events_table(np.random.default_rng(0), n_rows=40_000,
                           rows_per_partition=20, user_clustering=0.99999)
    us = make_users_table(np.random.default_rng(1), n_rows=4000,
                          rows_per_partition=100)
    rng = np.random.default_rng(2)
    qs = []
    for i in range(48):
        pred = E.col("ts") >= float(rng.integers(0, 10_000_000))
        if i % 3 == 0:
            qs.append(Query(scans={"e": TableScanSpec(ev, pred)},
                            limit=int(rng.integers(1, 100)),
                            order_by=("e", "num_sightings", i % 2 == 0)))
        elif i % 3 == 1:
            qs.append(Query(
                scans={"u": TableScanSpec(us, E.col("age") >= int(
                    rng.integers(60, 90))), "e": TableScanSpec(ev, pred)},
                join=JoinSpec("u", "e", "id", "user_id")))
        else:
            qs.append(Query(scans={"e": TableScanSpec(ev, pred)}))
    svc = PruningService()
    pipe = PruningPipeline(filter_mode="device", service=svc,
                           join_ndv_limit=256)
    got = svc.run_batch(qs, pipe)
    cpu = PruningService(device="cpu")
    want = cpu.run_batch(qs, PruningPipeline(filter_mode="device",
                                             service=cpu, join_ndv_limit=256))
    for g, w in zip(got, want):
        for name in w.scan_sets:
            np.testing.assert_array_equal(g.scan_sets[name].part_ids,
                                          w.scan_sets[name].part_ids)
            np.testing.assert_array_equal(g.scan_sets[name].match,
                                          w.scan_sets[name].match)
        if w.topk is not None:
            np.testing.assert_array_equal(g.topk.values, w.topk.values)
            np.testing.assert_array_equal(g.topk.skipped, w.topk.skipped)
    tech = got[0].counters["technique"]
    assert tech == want[0].counters["technique"]
    assert tech["join"]["launches"] == 1
    assert tech["join_bloom"]["launches"] == 1
    assert tech["topk"]["launches"] == 2            # asc and desc groups
    assert not any(got[0].counters["resilience"]["demotions"].values())


# ---------------------------------------------------------------------------
# the per-query kernels: minmax_prune, join_overlap, topk_boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,P", [
    (1, 1), (3, 7), (2, 2047), (1, 2048), (3, 2049), (2, 100_000),
    # conjunctions longer than the kernel's 2048-slot shared tile
    (2049, 3000), (8192, 4097),
])
def test_minmax_prune_equals_plain_version(cuda, K, P):
    rng = np.random.default_rng(K * 7 + P)
    args = [torch.from_numpy(a).to(cuda)
            for a in range_problem(rng, K, P, edges=True, denormals=True)]
    before = minmax_prune.launches
    got = minmax_prune(*args)
    torch.cuda.synchronize()
    assert minmax_prune.launches == before + 1
    want = minmax_prune_ref(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("K,P,offset", [
    (1, 4097, 0), (2, 4098, 0), (3, 4099, 0),     # P = 1, 2, 3 mod 4
    (2, 100_000, 1), (3, 4096, 2), (1, 4096, 3),  # rows off 16 bytes
    (2049, 1001, 1), (2, 1 << 20, 0), (2, (1 << 20) + 3, 2),
])
def test_minmax_prune_alignment_equals_plain_version(cuda, K, P, offset):
    """The 16-byte loads and stores against the plain version where the
    stat rows are not 16-byte aligned: P not a multiple of 4 (rows after
    the first start off 16 bytes) and the three planes as views of one
    tensor at ``offset`` floats; ``launch_checked`` (the launch alone)
    equals the wrapper."""
    rng = np.random.default_rng(K * 13 + P + offset)
    lo, hi, *planes = range_problem(rng, K, P, edges=True, denormals=True)
    buf = torch.zeros(offset + 3 * K * P, device=cuda)
    stats = [buf[offset + i * K * P:offset + (i + 1) * K * P].view(K, P)
             for i in range(3)]
    for view, a in zip(stats, planes):
        view.copy_(torch.from_numpy(a))
    assert (stats[0].data_ptr() % 16 != 0) == (offset != 0)
    args = [torch.from_numpy(lo).to(cuda), torch.from_numpy(hi).to(cuda),
            *stats]
    before = minmax_prune.launches
    got = minmax_prune(*args)
    alone = minmax_mod.launch_checked(*args)
    torch.cuda.synchronize()
    assert minmax_prune.launches == before + 2
    want = minmax_prune_ref(*args)
    assert torch.equal(got, want) and torch.equal(alone, want)


@pytest.mark.parametrize("P,D", [
    (1, 1), (7, 60), (2049, 4096), (100_000, 4097),
    # key lists longer than the kernel's staged capacity: in place
    (5000, 9000),
])
def test_join_overlap_equals_plain_version(cuda, P, D):
    rng = np.random.default_rng(P + D)
    args = [torch.from_numpy(a).to(cuda)
            for a in overlap_problem(rng, P, D, edges=True,
                                     denormals=True)]
    before = join_overlap.launches
    got = join_overlap(*args)
    torch.cuda.synchronize()
    assert join_overlap.launches == before + 1
    want = join_overlap_ref(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("P,offset,n_keys", [
    (4097, 0, 60), (4098, 0, 60), (4099, 0, 60),   # P = 1, 2, 3 mod 4
    (100_000, 1, 400), (5000, 2, 3000), (4096, 3, 40),  # rows off 16 bytes
    ((1 << 20) + 3, 0, 7132),                     # phase 4's widest join
])
def test_join_overlap_clustered_alignment(cuda, P, offset, n_keys):
    """The windowed kernel on clustered intervals (mostly empty windows,
    an all-empty run of tiles, keys at both infinities and -0.0) where
    the rows are not 16-byte aligned: P not a multiple of 4 and the
    interval rows and keys as views at an odd offset; ``launch_checked``
    (the launch alone) equals the wrapper, the plain version and the
    windowed one."""
    rng = np.random.default_rng(P + offset)
    tile = ref_mod.JOIN_TILE_SINGLE
    t0 = (P // 3) // tile * tile
    pmin, pmax = clustered_plane(rng, P, P, np.float32(np.inf),
                                 empty_run=(t0, t0 + 2 * tile))
    keys = clustered_keys(rng, pmin, pmax, P, n_keys, tile)
    keys = np.unique(np.concatenate([keys, [-np.inf, np.inf, 0.0]])
                     ).astype(np.float32)
    keys[keys == 0] = np.float32(-0.0)
    pmin[1:4], pmax[1:4] = [0.0, 7.0, np.inf], [0.0, np.inf, np.inf]
    args = _views((pmin, pmax, keys), offset, cuda)
    before = join_overlap.launches
    got = join_overlap(*args)
    alone = join_mod.launch_checked(*args)
    torch.cuda.synchronize()
    assert join_overlap.launches == before + 2
    want = join_overlap_ref(*args)
    assert torch.equal(got, want) and torch.equal(alone, want)
    assert torch.equal(got, ref_mod.join_overlap_windowed_ref(
        args[2], args[0], args[1], tile))


@pytest.mark.parametrize("sizes", [
    (0, 1, 32, 33, 1023, 1024, 4096, 4097),
    (9000, 0, 0, 4096, 64, 1, 1500, 40),
])
def test_join_overlap_window_paths(cuda, sizes):
    """Tiles whose key windows take each path of the single-query kernel:
    empty, held in a warp's lanes, staged in shared memory, and in place
    (below the least staged window and past the capacity); keys on every
    tile's min and max."""
    rng = np.random.default_rng(len(sizes))
    tile = ref_mod.JOIN_TILE_SINGLE
    pmin, pmax, keys = window_problem(rng, sizes, tile, np.float32(np.inf))
    args = [torch.from_numpy(a).to(cuda) for a in (pmin, pmax, keys)]
    a, b = ref_mod.join_windows(args[2][None], args[0], args[1], tile)
    assert (b - a)[0].tolist() == list(sizes)
    assert min(ref_mod.window_paths(a, b).values()) > 0
    got = join_overlap(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, join_overlap_ref(*args))


@pytest.mark.parametrize("P,k,order,lo,hi", [
    (1, 1, "random", -1000, 1000), (300, 1, "descending", -20, 20),
    (2049, 8, "random", -20, 20), (100_000, 64, "descending", -1000, 1000),
    (3000, 4, "ascending", -1000, 1000),      # every row merges
    (40, MAX_K_SCAN, "random", -50, 50),      # the largest heap
])
def test_topk_boundary_equals_plain_version(cuda, P, k, order, lo, hi):
    rng = np.random.default_rng(P + k)
    rows, b_init = topk_problem(rng, P, k, order=order, lo=lo, hi=hi)
    if order != "ascending":
        rows[rng.random(P) < 0.1] = -np.inf    # all -inf rows
    rows_d = torch.from_numpy(rows).to(cuda)
    for b in (float("-inf"), float(b_init)):
        before = topk_boundary.launches
        skip, heap = topk_boundary(rows_d, b)
        torch.cuda.synchronize()
        assert topk_boundary.launches == before + 1
        want_skip, want_heap = topk_boundary_ref(rows_d, b)
        assert skip.dtype == torch.int32 and tuple(skip.shape) == (P,)
        assert torch.equal(skip, want_skip) and torch.equal(heap, want_heap)
    if order == "ascending":
        assert not skip.any()


def signed_zero_rows(rng, P, k):
    """[P, k] rows of small integers with -0.0 beside +0.0 (equal
    values the merges must keep in order), 10% all -inf."""
    rows, _ = topk_problem(rng, P, k, lo=-3, hi=3)
    rows[(rows == 0) & (rng.random(rows.shape) < 0.5)] = -0.0
    rows[rng.random(P) < 0.1] = -np.inf
    return np.ascontiguousarray(-np.sort(-rows, axis=1))


@pytest.mark.parametrize("P,k,order,tile", [
    # tile edges at the wrapper's tile (2048 rows up to P = 264 x 2048 on
    # 132 SMs; 4096 at P = 2**20)
    (2047, 8, "random", None), (2048, 8, "random", None),
    (2049, 8, "random", None), (4095, 25, "descending", None),
    (4096, 25, "random", None), (4097, 25, "random", None),
    ((1 << 20) - 1, 25, "descending", None),
    ((1 << 20) + 1, 25, "random", None),
    # phase 4's k at P = 2**20, and a heap of 200
    (1 << 20, 25, "random", None), (1 << 20, 200, "random", None),
    (1 << 20, 200, "descending", None),
    # tiles of a few rows, and k above the tile at a small P
    (3000, 8, "random", 1), (5000, 8, "ascending", 7),
    (3000, 25, "random", 64), (40, 3000, "random", 7),
    (60, 2048, "descending", 7),
])
def test_topk_boundary_tiles_equal_plain_version(cuda, P, k, order, tile):
    """The tiled scan (passes A-C) against the sequential plain version
    at the tile edges, at P = 2**20 and with tiles given by hand through
    ``scan_launch_checked``, which equals the wrapper; one count a call."""
    rng = np.random.default_rng(P + 31 * k)
    rows, b_init = topk_problem(rng, P, k, order=order, lo=-1000, hi=1000)
    if order != "ascending":
        rows[rng.random(P) < 0.1] = -np.inf
    rows_d = torch.from_numpy(rows).to(cuda)
    for b in (float("-inf"), float(b_init),
              float(np.median(rows[:, 0]))):
        before = topk_boundary.launches
        if tile is None:
            skip, heap = topk_boundary(rows_d, b)
            alone = topk_mod.scan_launch_checked(rows_d, b)
        else:
            skip, heap = topk_mod.scan_launch_checked(rows_d, b, tile)
            alone = topk_boundary(rows_d, b)
        torch.cuda.synchronize()
        assert topk_boundary.launches == before + 2
        want_skip, want_heap = topk_boundary_ref(rows_d, b)
        assert torch.equal(skip, want_skip) and torch.equal(heap, want_heap)
        assert torch.equal(alone[0], skip) and torch.equal(alone[1], heap)


@pytest.mark.parametrize("k", [4, 25])
def test_topk_boundary_every_row_merges_at_p_2_20(cuda, k):
    """Strictly rising heads at P = 2**20: every row merges, so no row is
    skipped and the heap is the top-k of all values (the sequential plain
    version would take a million sorts)."""
    P = 1 << 20
    rows = (2.0 * torch.arange(P, device=cuda, dtype=torch.float32))[:, None] \
        - torch.arange(k, device=cuda, dtype=torch.float32)[None, :]
    skip, heap = topk_boundary(rows.contiguous())
    torch.cuda.synchronize()
    assert not skip.any()
    assert torch.equal(heap, torch.topk(rows.flatten(), k).values)


@pytest.mark.parametrize("P,k,tile", [
    (3000, 8, None), (3000, 8, 7), (5000, 25, 64), (300, 3, 1),
])
def test_topk_boundary_keeps_signed_zeros_in_order(cuda, P, k, tile):
    """-0.0 beside +0.0: the heap's bits equal the stable tiled plain
    version's (equal values in row order), its values the sequential plain
    version's, and the skips both."""
    rng = np.random.default_rng(P + k)
    rows = signed_zero_rows(rng, P, k)
    rows_d = torch.from_numpy(rows).to(cuda)
    for b in (float("-inf"), 0.0, -0.0, 1.0):
        skip, heap = topk_mod.scan_launch_checked(rows_d, b, tile)
        torch.cuda.synchronize()
        want_skip, want_heap = topk_boundary_tiled_ref(
            torch.from_numpy(rows), b, 97)
        assert torch.equal(skip.cpu(), want_skip)
        assert torch.equal(heap.cpu().view(torch.int32),
                           want_heap.view(torch.int32))
        seq_skip, seq_heap = topk_boundary_ref(rows_d, b)
        assert torch.equal(skip, seq_skip) and torch.equal(heap, seq_heap)


def test_per_query_kernels_reject_inputs_on_the_card(cuda):
    rng = np.random.default_rng(5)
    pmin, pmax, _keys = (torch.from_numpy(a).to(cuda)
                         for a in overlap_problem(rng, 50, 20))
    for bad in ([3.0, 1.0, 2.0], [1.0, np.nan]):      # unsorted, NaN
        with pytest.raises(KernelError, match="sorted"):
            join_overlap(pmin, pmax, torch.tensor(bad, device=cuda))
    rows = torch.zeros((4, MAX_K_SCAN + 1), device=cuda)
    with pytest.raises(KernelError, match="k "):
        topk_boundary(rows)
    lo, hi, mins, maxs, nullable = (torch.from_numpy(a).to(cuda)
                                    for a in range_problem(rng, 2, 30))
    with pytest.raises(KernelError):
        minmax_prune(lo, hi, mins.double(), maxs, nullable)
    with pytest.raises(KernelError, match="cpu"):
        minmax_prune(lo, hi, mins, maxs, nullable.cpu())


@pytest.mark.parametrize("kernel", ["minmax_prune", "join_overlap",
                                    "topk_boundary"])
def test_per_query_launch_failure_raises(cuda, monkeypatch, kernel):
    """Each per-query wrapper turns a CUDA error returned by its launch
    into a KernelError and counts no launch."""
    monkeypatch.setattr(build, "entry", lambda _name: lambda *_a: 1)
    rng = np.random.default_rng(1)
    if kernel == "minmax_prune":
        fn, args = minmax_prune, range_problem(rng, 3, 64)
    elif kernel == "join_overlap":
        fn, args = join_overlap, overlap_problem(rng, 64, 30)
    else:
        fn, args = topk_boundary, topk_problem(rng, 64, 8)[:1]
    before = fn.launches
    with pytest.raises(KernelError, match="cudaError 1"):
        fn(*(torch.from_numpy(a).to(cuda) for a in args))
    assert fn.launches == before


def test_per_query_ops_on_card_equal_cpu(cuda):
    """The per-query ops on the card and on the CPU: the same verdicts,
    hits, skips and heap, each through its kernel."""
    from repro_torch.core import expr as E
    from repro_torch.core.prune_filter import extract_ranges
    from repro_torch.data.generator import make_events_table
    ev = make_events_table(np.random.default_rng(0), n_rows=40_000,
                           rows_per_partition=20)
    rng = np.random.default_rng(3)
    launches = (ops.minmax_prune.launches, ops.join_overlap.launches,
                ops.topk_boundary.launches)
    for i in range(8):
        pred = (E.col("ts") >= float(rng.integers(0, 10_000_000))) \
            & (E.col("score") < float(rng.random()))
        ranges = extract_ranges(pred, ev.stats)
        np.testing.assert_array_equal(
            ops.prune_ranges_device(ranges, ev.stats),
            ops.prune_ranges_device(ranges, ev.stats, device="cpu"))
        keys = np.unique(rng.integers(0, 20_000, int(rng.integers(1, 3000))))
        np.testing.assert_array_equal(
            ops.join_overlap_device(ev.stats, "user_id", keys),
            ops.join_overlap_device(ev.stats, "user_id", keys, device="cpu"))
    vals, _ = ev.global_ctx().col("num_sightings")
    rows = ops.build_block_topk(vals, ev.part_bounds, 16)
    rows = rows[np.argsort(-ev.stats.col_max("num_sightings"), kind="stable")]
    for mode in ("auto", "prefix"):
        got = ops.topk_boundary_device(rows, mode=mode)
        want = ops.topk_boundary_device(rows, mode=mode, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (ops.minmax_prune.launches - launches[0] == 8
            and ops.join_overlap.launches - launches[1] == 8
            and ops.topk_boundary.launches - launches[2] == 1)


# ---------------------------------------------------------------------------
# flash_attention (the LM prefill): f32 and bf16, held to the JAX package's
# bounds (2e-5 f32, 2e-2 bf16, rtol and atol): f32 sums in another order
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("BH,Sq,Sk,D,causal", [
    (1, 1, 1, 8, True), (3, 7, 7, 16, True), (2, 130, 130, 32, True),
    (1, 256, 256, 64, True), (3, 128, 128, 128, True), (2, 130, 130, 256, True),
    (3, 1, 2048, 128, False), (2, 130, 7, 64, False), (1, 256, 130, 256, False),
    (4, 2048, 2048, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_plain_version(cuda, BH, Sq, Sk, D, causal,
                                              dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(BH + Sq + Sk + D)
    q, k, v = (torch.randn((BH, S, D), generator=gen, device=cuda).to(dtype)
               for S in (Sq, Sk, Sk))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (BH, Sq, D)
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [8, 72, 100, 128, 200, 256])
@pytest.mark.parametrize("BH,Sq,Sk,causal", [
    (2, 130, 300, True), (2, 300, 130, True), (3, 1, 77, False),
    (1, 1, 1, True), (2, 65, 65, True), (1, 200, 129, False)])
@pytest.mark.parametrize("odd", [False, True])
def test_flash_attention_bf16_template_edges(cuda, D, BH, Sq, Sk, causal,
                                             odd):
    """The tensor-core template at head dims padded to a multiple of 16
    (72, 100, 200 too), Sq != Sk, Sq = 1 and lengths that are not
    multiples of 64; ``odd`` makes q, k, v views one element into their
    buffers, so their data_ptr is off 16 bytes (the element-load path)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(D + Sq + Sk)
    shapes = [(BH, S, D) for S in (Sq, Sk, Sk)]
    q, k, v = (torch.randn(int(np.prod(sh)) + odd, generator=gen,
                           device=cuda).bfloat16()[int(odd):].view(sh)
               for sh in shapes)
    assert (q.data_ptr() % 16 != 0) == odd
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("edge", TOPK_EDGES)
@pytest.mark.parametrize("k", [1, 2, 17, 100, 127, 128])
def test_topk_init_edges_equal_plain_version(cuda, edge, k):
    """The query-wide threshold under ties (equal heads, equal values,
    signed zeros), all -inf rows, empty queries, repeated ids and queries
    with fewer than k values."""
    rng = np.random.default_rng(TOPK_EDGES.index(edge) * 1000 + k)
    plane, lists = topk_edge_inputs(rng, edge, 3000)
    offsets, ids = ops.pack_candidates(lists)
    args = (torch.from_numpy(plane).to(cuda),
            torch.from_numpy(offsets).to(cuda), torch.from_numpy(ids).to(cuda))
    got = topk_init_batched(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got, topk_init_batched_ref(*args, k))


def test_topk_init_more_queries_than_a_grid_row(cuda):
    """70,000 queries: more than the 65,535 blocks a grid holds in y."""
    rng = np.random.default_rng(70)
    P = 500
    plane, _ = topk_inputs(rng, 1, P, P)
    lists = [rng.integers(0, P, int(rng.integers(0, 4))).astype(np.int32)
             for _ in range(70_000)]
    offsets, ids = ops.pack_candidates(lists)
    args = (torch.from_numpy(plane).to(cuda),
            torch.from_numpy(offsets).to(cuda), torch.from_numpy(ids).to(cuda))
    got = topk_init_batched(*args, 3)
    torch.cuda.synchronize()
    want = topk_init_batched_ref(*(a.cpu() for a in args), 3)
    assert torch.equal(got.cpu(), want)


def test_flash_attention_launch_failure_raises(cuda, monkeypatch):
    from repro_torch.kernels.flash_attention import flash_attention
    monkeypatch.setattr(build, "entry", lambda _name: lambda *_a: 1)
    q = torch.zeros((2, 8, 64), device=cuda)
    before = flash_attention.launches
    with pytest.raises(KernelError, match="cudaError 1"):
        flash_attention(q, q, q)
    assert flash_attention.launches == before
    with pytest.raises(KernelError, match="head dim"):
        flash_attention(*(torch.zeros((1, 4, 512), device=cuda),) * 3)


def recording(model, logits, forced=None):
    """``model`` with its prefill and decode steps appending the logits
    they return to the list ``logits``; with ``forced`` [B, steps], decode
    step i is fed ``forced[:, i]`` in place of the caller's token (teacher
    forcing)."""
    fed = []

    def prefill(params, batch, max_seq):
        out, cache = model.prefill_fn(params, batch, max_seq)
        logits.append(out)
        return out, cache

    def decode(params, cache, tok, position):
        if forced is not None:
            tok = torch.as_tensor(np.asarray(forced)[:, len(fed):len(fed) + 1],
                                  device=tok.device)
            fed.append(tok)
        out, cache = model.decode_fn(params, cache, tok, position)
        logits.append(out)
        return out, cache

    return model._replace(prefill_fn=prefill, decode_fn=decode)


def recording_batcher(model, params, **kw):
    """A ``ContinuousBatcher`` and a dict that its model fills with, for
    each request id, the logits [V] that chose each of its tokens: the k-th
    prefill is request k (ids count up from 0 at submit and the queue is
    first in, first out), and row s of a decode step is the request that
    held slot s when the step ran."""
    from repro_torch.serve.batcher import ContinuousBatcher
    seen = {}

    def prefill(params, batch, max_seq):
        out, kv = model.prefill_fn(params, batch, max_seq)
        seen[len(seen)] = [out[0]]
        return out, kv

    def decode(params, cache, tok, position):
        out, cache = model.decode_fn(params, cache, tok, position)
        for slot, req in enumerate(batcher.slot_req):
            if req is not None:
                seen[req.rid].append(out[slot])
        return out, cache

    batcher = ContinuousBatcher(
        model._replace(prefill_fn=prefill, decode_fn=decode), params, **kw)
    return batcher, seen


def test_served_path_reaches_the_kernel_and_equals_cpu(cuda):
    """The glm4 smoke model's prefill and decode on the card launch the
    flash kernel once a layer per prefill and agree with the CPU run
    (bf16: 2e-2 of max |logit|)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.sharding import init_params, tree_map
    from repro_torch.serve.serve_step import Generator
    cfg = get_smoke_config("glm4-9b")
    cpu_model = build_model(cfg, device="cpu")
    params = init_params(cpu_model.specs, torch.Generator().manual_seed(0),
                         "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    want = []
    want_toks = Generator(recording(cpu_model, want), params, max_seq=48,
                          device="cpu").generate(prompts, steps=6)
    got = []
    before = flash_attention.launches
    Generator(recording(build_model(cfg, device=cuda), got, forced=want_toks),
              tree_map(lambda t: t.to(cuda), params), max_seq=48,
              device=cuda).generate(prompts, steps=6)
    assert flash_attention.launches == before + cfg.n_layers
    want, got = torch.stack(want, dim=1), torch.stack(got, dim=1).cpu()
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


# ---------------------------------------------------------------------------
# the tree wrappers (kernels/ops.py): the card against the CPU
# ---------------------------------------------------------------------------

def _tree_planes(dev, seed=0, P=3000, fanout=16):
    """Clustered stat planes with dropped partitions, their tree entry,
    and the key, enumeration and block-top-k planes of the same P, on
    ``dev``."""
    rng = np.random.default_rng(seed)
    C = 3
    mins = np.empty((P, C))
    mins[:, 0] = np.sort(rng.integers(0, 100_000, P))
    mins[:, 1] = rng.integers(-1000, 1000, P)
    mins[:, 2] = rng.integers(0, 500, P)
    maxs = mins + np.stack([rng.integers(0, 60, P), rng.integers(0, 400, P),
                            rng.integers(0, 6, P)], axis=1)
    drop = rng.choice(P, 40, replace=False)
    mins[drop], maxs[drop] = np.inf, -np.inf
    stats = PartitionStats([ColumnMeta(f"c{i}", "int") for i in range(C)],
                           mins, maxs, np.zeros((P, C), np.int64),
                           np.full(P, 5, np.int64))
    d = TD.DeviceStats.stage(stats, capacity=TD.plane_capacity(P),
                             device=dev)
    cap = d.capacity
    pmin = np.full(cap, F32_MAX, dtype=np.float32)
    pmax = np.full(cap, -F32_MAX, dtype=np.float32)
    pmin[:P] = np.clip(TD.round_down_f32(mins[:, 0]), -F32_MAX, F32_MAX)
    pmax[:P] = np.clip(TD.round_up_f32(maxs[:, 0]), -F32_MAX, F32_MAX)
    emin = np.zeros(cap, dtype=np.int32)
    width = np.zeros(cap, dtype=np.int32)
    live = np.isfinite(mins[:, 2])
    emin[:P] = np.where(live, mins[:, 2], 0)
    width[:P] = np.where(live, maxs[:, 2] - mins[:, 2] + 1, 0)
    plane = np.full((cap, 8), -np.inf, dtype=np.float32)
    plane[:P][live] = -np.sort(-rng.integers(-1000, 1000, (int(live.sum()),
                                                           8)), axis=1)
    to = (lambda a: torch.from_numpy(a).to(dev))
    return (d, TD.tree_entry_for(d, fanout=fanout), mins,
            (to(pmin), to(pmax)), (to(emin), to(width)), to(plane))


def test_tree_wrappers_on_card_equal_cpu(cuda):
    """Each tree wrapper on CUDA planes returns what it returns on the
    CPU, taking the same path with the same densities, and launches the
    flat kernels."""
    rng = np.random.default_rng(1)
    d_cpu, te_cpu, mins, keys_cpu, enum_cpu, plane_cpu = _tree_planes("cpu")
    d_gpu, te_gpu, _, keys_gpu, enum_gpu, plane_gpu = _tree_planes(cuda)
    anchors = mins[np.isfinite(mins[:, 0]), 0][[5, 800, 2500]]
    filters = [[(0, float(a), float(a) + 300.0)] for a in anchors] + [
        [(0, float(anchors[1]), float(anchors[1]) + 900.0),
         (2, 100.0, 110.0)]]
    wide = [[(1, -200.0, 200.0)]]
    dist = [np.unique(rng.integers(a, a + 500, 6)).astype(np.float64)
            for a in (100, 40_000)]
    blooms = []
    for _ in range(3):
        b = BlockedBloom(64)
        b.add(rng.integers(0, 500, 40))
        blooms.append(b)
    lists = [np.array([3, 4, 17, 18, 2000, 2001]), np.array([5]),
             np.array([31, 32, 700, 1999])]
    P = d_cpu.num_partitions
    before = {n: getattr(ops, n).launches for n in (
        "minmax_prune_batched", "join_overlap_batched",
        "bloom_probe_batched", "topk_init_batched")}
    paths = []
    for fn, args_cpu, args_gpu in (
            (ops.prune_ranges_batched_tree, (filters, d_cpu, te_cpu),
             (filters, d_gpu, te_gpu)),
            (ops.prune_ranges_batched_tree, (wide, d_cpu, te_cpu),
             (wide, d_gpu, te_gpu)),
            (ops.join_overlap_batched_tree,
             (dist, *keys_cpu, P, te_cpu, 0), (dist, *keys_gpu, P, te_gpu,
                                               0)),
            (ops.bloom_probe_batched_tree,
             (blooms, *enum_cpu, 1024, P, te_cpu),
             (blooms, *enum_gpu, 1024, P, te_gpu)),
            (ops.topk_init_batched_tree, (plane_cpu, lists, 4, te_cpu),
             (plane_gpu, lists, 4, te_gpu))):
        want = fn(*args_cpu)
        note = ops.last_tree_stats()
        got = fn(*args_gpu)
        assert ops.last_tree_stats() == note, fn.__name__
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
        paths.append(note["path"])
    after = {n: getattr(ops, n).launches for n in before}
    # the tree filter evaluates by gathers (no kernel); its dense
    # fallback, the join, the Bloom probe and the top-k launch once each
    assert paths[:2] == ["tree", "flat_dense"], paths
    assert all(after[n] == before[n] + 1 for n in before), (before, after)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_wrappers_on_card_equal_cpu(cuda, n):
    """A logical mesh of n shards on the card: each batched wrapper and
    tree wrapper equals its unsharded CPU run; every live shard launches
    its kernel once, on a view of the resident plane; and each shard's
    launch equals the plain version of the same shard."""
    from repro_torch.launch.mesh import make_plane_mesh
    mesh = make_plane_mesh([cuda] * n)
    rng = np.random.default_rng(2)
    d_cpu, te_cpu, mins, keys_cpu, enum_cpu, plane_cpu = _tree_planes("cpu")
    d_gpu, te_gpu, _, keys_gpu, enum_gpu, plane_gpu = _tree_planes(cuda)
    P, cap = d_cpu.num_partitions, d_cpu.capacity
    live_shards = sum(1 for s in ops._shard_spans(cap, n, P) if s[2])
    filters = [[(1, -200.0, 200.0)], [(0, 5000.0, 9000.0), (2, 100.0, 300.0)]]
    dist = [np.unique(rng.integers(0, 100_000, 300)).astype(np.float64)
            for _ in range(3)]
    blooms = []
    for _ in range(3):
        b = BlockedBloom(64)
        b.add(rng.integers(0, 500, 40))
        blooms.append(b)
    lists = [np.sort(rng.choice(P, 900, replace=False)) for _ in range(4)]
    for fn, args_cpu, args_gpu, name, launches in (
            (ops.prune_ranges_batched_device, (filters, d_cpu),
             (filters, d_gpu), "minmax_prune_batched", live_shards),
            (ops.join_overlap_batched_device, (dist, *keys_cpu, P),
             (dist, *keys_gpu, P), "join_overlap_batched", live_shards),
            (ops.bloom_probe_batched_device, (blooms, *enum_cpu, 1024, P),
             (blooms, *enum_gpu, 1024, P), "bloom_probe_batched",
             live_shards),
            (ops.topk_init_batched_device, (plane_cpu, lists, 8),
             (plane_gpu, lists, 8), "topk_init_batched", live_shards)):
        want = fn(*args_cpu)
        before = getattr(ops, name).launches
        got = fn(*args_gpu, mesh=mesh)
        assert ops.last_launch_shards() == n
        assert getattr(ops, name).launches - before == launches, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for fn, args_cpu, args_gpu in (
            (ops.prune_ranges_batched_tree, (filters, d_cpu, te_cpu),
             (filters, d_gpu, te_gpu)),
            (ops.join_overlap_batched_tree, (dist, *keys_cpu, P, te_cpu, 0),
             (dist, *keys_gpu, P, te_gpu, 0)),
            (ops.bloom_probe_batched_tree,
             (blooms, *enum_cpu, 1024, P, te_cpu),
             (blooms, *enum_gpu, 1024, P, te_gpu)),
            (ops.topk_init_batched_tree, (plane_cpu, lists, 8, te_cpu),
             (plane_gpu, lists, 8, te_gpu))):
        np.testing.assert_array_equal(fn(*args_gpu, mesh=mesh),
                                      fn(*args_cpu), err_msg=fn.__name__)
    # each shard's launch against the plain version of that shard
    cids, lo, hi, _ = ops.pack_ranges(filters, d_gpu)
    Q = len(filters)
    for s, e, live in ops._shard_spans(cap, n, P):
        views = [ops._shard_of(a, 1, s, e, cuda) for a in d_gpu.planes]
        assert views[0].data_ptr() == d_gpu.mins.data_ptr() + 4 * s
        args = [torch.from_numpy(np.ascontiguousarray(a[:Q])).to(cuda)
                for a in (cids, lo, hi)]
        got = minmax_prune_batched(*args, *views, num_partitions=live)
        want = minmax_prune_batched_ref(
            *(a.cpu() for a in args),
            *(v.cpu()[:, :live] for v in views))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_verdict_cache_on_card_equals_cpu(cuda):
    """The verdict cache on the card: a repeated batch is served from
    resident rows with no filter launch, an append is repaired in place,
    and every batch equals the CPU service's."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.data.generator import make_events_table
    from repro_torch.serve.prune_service import PruningService
    ev = make_events_table(np.random.default_rng(0), n_rows=20000,
                           rows_per_partition=20)
    rng = np.random.default_rng(1)
    preds = [E.col("ts") >= float(rng.integers(0, 10_000_000))
             for _ in range(8)]
    qs = [Query(scans={"e": TableScanSpec(ev, preds[i % 8])})
          for i in range(24)]
    gpu, cpu = PruningService(), PruningService(device="cpu")

    def check():
        got, want = gpu.run_batch(qs), cpu.run_batch(qs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.scan_sets["e"].part_ids,
                                          w.scan_sets["e"].part_ids)
            np.testing.assert_array_equal(g.scan_sets["e"].match,
                                          w.scan_sets["e"].match)
        return got[0].counters

    c = check()                         # every key seen 3x: admitted
    assert c["resilience"]["verdict_deduped"] == 16
    before = ops.minmax_prune_batched.launches
    c = check()
    assert ops.minmax_prune_batched.launches == before
    assert c["resilience"]["verdict_hits"] == 8
    row = next(iter(gpu.cache.verdict_planes.values())).arrays[0]
    assert row.device.type == "cuda"
    ev.append_partitions({c: ev.decode(c, ev.data[c][:400])
                          for c in ev.columns}, rows_per_partition=20)
    c = check()
    assert ops.minmax_prune_batched.launches == before
    assert gpu.cache.integrity["verdict_repairs"] == 8
    # repaired into a copy that is swapped in: the old row is untouched
    assert next(iter(gpu.cache.verdict_planes.values())).arrays[0] is not row


def test_frontend_prestage_shares_the_launch_stream(cuda):
    """Threaded front-end on the card: the batcher thread's prestage and
    the worker's launches run on one CUDA stream, the front-end's."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.data.generator import make_events_table
    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.prune_service import PruningService
    ev = make_events_table(np.random.default_rng(0), n_rows=20000,
                           rows_per_partition=20)
    svc = PruningService(verdict_cache=False)
    streams = []
    real_prestage, real_kernel = svc.prestage, ops.minmax_prune_batched

    def prestage(queries):
        streams.append(("prestage", torch.cuda.current_stream()))
        return real_prestage(queries)

    def kernel(*a, **kw):
        streams.append(("launch", torch.cuda.current_stream()))
        return real_kernel(*a, **kw)

    svc.prestage = prestage
    ops.minmax_prune_batched = kernel
    try:
        # a deadline batch: the batcher stages the pending queries while
        # it waits (a burst that fills the size cap dispatches unstaged)
        with ServingFrontend(svc, max_batch=64, deadline_s=0.5) as fe:
            futs = []
            for i in range(8):
                futs.append(fe.submit(Query(scans={"e": TableScanSpec(
                    ev, E.col("ts") >= float(100_000 * i))})))
                time.sleep(0.02)
            resps = [f.result(timeout=60) for f in futs]
    finally:
        ops.minmax_prune_batched = real_kernel
    kinds = {k for k, _ in streams}
    assert kinds == {"prestage", "launch"}
    assert all(s == fe.stream for _, s in streams)
    want = PruningService(device="cpu", verdict_cache=False).run_batch(
        [Query(scans={"e": TableScanSpec(
            ev, E.col("ts") >= float(100_000 * i))}) for i in range(8)])
    for r, w in zip(resps, want):
        np.testing.assert_array_equal(r.report.scan_sets["e"].part_ids,
                                      w.scan_sets["e"].part_ids)


# ---------------------------------------------------------------------------
# F1: a replay on one thread never tears a launch on another (the CPU
# side is tests/test_torch_replay_race.py; its inputs, on the card)
# ---------------------------------------------------------------------------

RACE_P, RACE_FANOUT = 1 << 14, 16


def _race_versions():
    p = np.arange(RACE_P, dtype=np.int64)
    a = np.stack([10 * p, 10 * p + 9], axis=1).reshape(-1)
    return a, a + 5


def _race_ranges(n=64):
    rng = np.random.default_rng(0)
    ps = rng.integers(0, RACE_P, n)
    gs = rng.integers(1, RACE_P // RACE_FANOUT, n // 2)
    return ([[(0, float(10 * p + 5), float(10 * p + 9))] for p in ps]
            + [[(0, float(10 * RACE_FANOUT * g),
                 float(10 * RACE_FANOUT * g + 4))] for g in gs])


def _race_table():
    from repro_torch.data.table import Table
    return Table.build("t", {"v": _race_versions()[0],
                             "w": np.arange(2 * RACE_P) % 7},
                       rows_per_partition=2)


@pytest.mark.parametrize("streams", ["one", "two"])
def test_held_replay_never_tears_a_launch_on_the_card(cuda, monkeypatch,
                                                      streams):
    """The launcher takes the planes; a replay to version B on another
    thread (on the launcher's stream, or on a stream of its own) is held
    after its first row write while the kernel launches on the old
    planes: its verdicts are A's, none FULL."""
    import dataclasses
    import threading
    t = _race_table()
    want_a = ops.prune_ranges_batched_device(
        _race_ranges(), TD.DeviceStatsCache(device="cpu").get(t),
        mode="torch")
    cache = TD.DeviceStatsCache(tree_fanout=RACE_FANOUT)
    launch_stream = torch.cuda.Stream()
    replay_stream = launch_stream if streams == "one" else torch.cuda.Stream()
    with torch.cuda.stream(launch_stream):
        dstats = dataclasses.replace(cache.get(t))
    t.update_column("v", _race_versions()[1])
    paused, resume = threading.Event(), threading.Event()
    armed = []
    real = torch.Tensor.__setitem__

    def setitem(x, idx, value):
        real(x, idx, value)
        if armed and threading.current_thread() is armed[0]:
            armed.clear()
            paused.set()
            assert resume.wait(60)

    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)

    def replay():
        armed.append(threading.current_thread())
        with torch.cuda.stream(replay_stream):
            cache.get(t)

    th = threading.Thread(target=replay)
    th.start()
    assert paused.wait(60)
    before = ops.minmax_prune_batched.launches
    try:
        with torch.cuda.stream(launch_stream):
            got = ops.prune_ranges_batched_device(_race_ranges(), dstats)
    finally:
        resume.set()
        th.join(60)
    assert ops.minmax_prune_batched.launches == before + 1
    assert not (got == 2).any()
    np.testing.assert_array_equal(got, want_a)
    want_b = ops.prune_ranges_batched_device(
        _race_ranges(), TD.DeviceStatsCache(device="cpu").get(t),
        mode="torch")
    np.testing.assert_array_equal(
        ops.prune_ranges_batched_device(_race_ranges(), cache.get(t)),
        want_b)


def test_two_services_sharing_a_cache_on_two_streams(cuda):
    """Two services share ``cache=`` from two threads, each on its own
    stream: one launches batch after batch, the other alternates the
    table between versions A and B (its DML under the cache lock, so
    only plane reads race) and replays.  Every answer is A's or B's; the
    swapped-out planes' memory is not reused under a running kernel
    (``record_stream``)."""
    import threading
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.serve.prune_service import PruningService
    t = _race_table()
    a, b = _race_versions()
    preds = [(E.col("v") >= lo) & (E.col("v") <= hi)
             for ((_c, lo, hi),) in _race_ranges(32)]
    qs = [Query(scans={"t": TableScanSpec(t, p)}) for p in preds]

    def rows(reports):
        out = np.zeros((len(reports), t.num_partitions), dtype=np.int8)
        for i, r in enumerate(reports):
            ss = r.scan_sets["t"]
            out[i, ss.part_ids] = ss.match
        return out

    truth = []
    for vals in (b, a):
        t.update_column("v", vals)
        truth.append(rows(PruningService(device="cpu", verdict_cache=False)
                          .run_batch(qs)))
    s1 = PruningService(verdict_cache=False)
    s2 = PruningService(verdict_cache=False, cache=s1.cache)
    answers, errors = [], []
    stop = threading.Event()

    def launcher():
        with torch.cuda.stream(torch.cuda.Stream()):
            try:
                while not stop.is_set():
                    answers.append(rows(s1.run_batch(qs)))
            except BaseException as exc:          # pragma: no cover
                errors.append(exc)

    def writer():
        with torch.cuda.stream(torch.cuda.Stream()):
            try:
                for i in range(24):
                    with s1.cache._lock:
                        t.update_column("v", b if i % 2 == 0 else a)
                    s2.prestage(qs[:1])
            except BaseException as exc:          # pragma: no cover
                errors.append(exc)

    th = [threading.Thread(target=launcher), threading.Thread(target=writer)]
    for x in th:
        x.start()
    th[1].join(600)
    stop.set()
    th[0].join(600)
    torch.cuda.synchronize()
    assert not errors
    assert len(answers) > 0
    for got in answers:
        assert any(np.array_equal(got, w) for w in truth)
    assert s1.cache.delta_stages > 0



# ---------------------------------------------------------------------------
# the MoE block (plain PyTorch, no kernel of its own): the card's run equal
# to the CPU's, routes and drops included
# ---------------------------------------------------------------------------

def _moe_inputs(arch, B, S, repeat, seed, **kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.models.sharding import init_params, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    specs = build_model(cfg, device="cpu").specs["layers"]["ffn"]
    p = init_params(specs, torch.Generator().manual_seed(seed), "cpu")
    p = tree_map(lambda t: t[0].float(), p)
    rng = np.random.default_rng(seed)
    if repeat:
        rows = rng.normal(size=(repeat, cfg.d_model)).astype(np.float32)
        x = rows[rng.integers(0, repeat, B * S)].reshape(B, S, cfg.d_model)
    else:
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return cfg, p, torch.from_numpy(x)


@pytest.mark.parametrize("dispatch", ["scatter", "grouped"])
@pytest.mark.parametrize("arch,B,S,repeat,cf,chunk", [
    ("qwen3-moe-30b-a3b", 2, 24, 0, 1.25, 256),
    ("kimi-k2-1t-a32b", 3, 64, 0, 1.25, 16),        # chunked
    ("qwen3-moe-30b-a3b", 4, 200, 3, 0.5, 256),     # many ties, many drops
    ("kimi-k2-1t-a32b", 2, 4096, 5, 1.0, 256),      # ties across 16 chunks
])
def test_moe_block_on_card_equals_cpu(cuda, arch, B, S, repeat, cf, chunk,
                                      dispatch):
    from repro_torch.models import moe
    from repro_torch.models.sharding import tree_map
    cfg, p, x = _moe_inputs(arch, B, S, repeat, 0, capacity_factor=cf,
                            moe_seq_chunk=chunk, moe_dispatch=dispatch)
    assert not torch.backends.cuda.matmul.allow_tf32
    want, want_aux = moe.moe_block(p, x, cfg)
    _, _, idx_cpu = moe.route(p, x, cfg)
    pc = tree_map(lambda t: t.to(cuda), p)
    got, got_aux = moe.moe_block(pc, x.to(cuda), cfg)
    _, _, idx_card = moe.route(pc, x.to(cuda), cfg)
    assert torch.equal(idx_card.cpu(), idx_cpu)
    flat = idx_cpu.reshape(-1, cfg.experts_per_tok)
    C = moe.capacity(flat.shape[0], cfg)
    assert torch.equal(moe.kept_slots(idx_card.reshape(flat.shape), C).cpu(),
                       moe.kept_slots(flat, C))
    if repeat:
        assert not bool(moe.kept_slots(flat, C).all())   # drops among ties
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-5
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_moe_router_refuses_tf32_on_the_card(cuda, monkeypatch):
    from repro_torch.models import moe
    from repro_torch.models.sharding import tree_map
    cfg, p, x = _moe_inputs("qwen3-moe-30b-a3b", 1, 8, 0, 0)
    pc = tree_map(lambda t: t.to(cuda), p)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        moe.route(pc, x.to(cuda), cfg)


# ---------------------------------------------------------------------------
# the Mamba2 scan and the ssm, hybrid, encdec and vlm families (plain
# PyTorch but for the flash kernel): the card's run against the CPU's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 11, 3, 4, 5, 4),            # padded
    (2, 300, 8, 16, 32, 64),        # padded, 5 chunks
    (1, 2048, 64, 64, 128, 256),    # Mamba2-1.3B's layer at S = 2,048
])
def test_ssd_scan_on_card_equals_cpu(cuda, b, s, h, p, n, chunk):
    from repro_torch.models import mamba
    rng = np.random.default_rng(s)
    args = [rng.normal(size=(b, s, h, p)),
            rng.uniform(0.05, 1.5, size=(b, s, h)),
            -rng.uniform(0.5, 1.5, size=(h,)),
            rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))]
    args = [torch.from_numpy(a.astype(np.float32)) for a in args]
    s0 = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(np.float32))
    assert not torch.backends.cuda.matmul.allow_tf32
    want = mamba.ssd_scan(*args, chunk, s0=s0)
    got = mamba.ssd_scan(*(a.to(cuda) for a in args), chunk, s0=s0.to(cuda))
    for g, w in zip(got, want):
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        assert err <= 2e-4
    if s <= 300:                    # and the recurrence on the card
        y, st = mamba.ssd_recurrence(*(a.to(cuda) for a in args),
                                     s0=s0.to(cuda))
        assert float((y.cpu() - want[0]).abs().max()
                     / want[0].abs().max()) <= 2e-4


def test_ssd_scan_refuses_tf32_on_the_card(cuda, monkeypatch):
    from repro_torch.models import mamba
    x = torch.zeros(1, 4, 2, 3, device=cuda)
    dt = torch.ones(1, 4, 2, device=cuda)
    A = -torch.ones(2, device=cuda)
    B = C = torch.zeros(1, 4, 5, device=cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        mamba.ssd_scan(x, dt, A, B, C, 4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-small", "llava-next-34b"])
def test_family_prefill_and_decode_on_card_equal_cpu(cuda, arch):
    """Each family's smoke model served on the card (bf16, the flash
    kernel) against the same served on the CPU: logits within 2e-2 of max
    |logit| (the bf16 bound of the model tests), teacher-forced on the
    CPU's tokens; the kernel launched the family's count a prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.sharding import init_params, tree_map
    from repro_torch.serve.serve_step import Generator
    cfg = get_smoke_config(arch)
    cpu_model = build_model(cfg, device="cpu")
    params = init_params(cpu_model.specs, torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 40))
    prefix = (None if cfg.frontend == "none" else torch.from_numpy(
        rng.normal(size=(2, cfg.n_prefix, cfg.d_model)).astype(np.float32)))
    max_seq = 48 + (cfg.n_prefix if cfg.family == "vlm" else 0)
    want = []
    want_toks = Generator(recording(cpu_model, want), params,
                          max_seq=max_seq, device="cpu").generate(
        prompts, steps=6, prefix=prefix)
    got = []
    before = flash_attention.launches
    Generator(recording(build_model(cfg, device=cuda), got, forced=want_toks),
              tree_map(lambda t: t.to(cuda), params), max_seq=max_seq,
              device=cuda).generate(
        prompts, steps=6, prefix=None if prefix is None else prefix.to(cuda))
    launches = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
                    cfg.family, cfg.n_layers)
    assert flash_attention.launches == before + launches
    want, got = torch.stack(want, dim=1), torch.stack(got, dim=1).cpu()
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


# ---------------------------------------------------------------------------
# training: the attention Function's backward, the losses' gradients and
# the SSD scan's backward on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,Sq,Sk,D,causal", [
    (3, 24, 24, 16, True), (2, 40, 17, 80, False), (4, 130, 130, 128, True),
    (48, 4096, 4096, 128, True)])        # Llama-3.2-3B's training shape
def test_flash_backward_on_card_equals_plain_autograd(cuda, BH, Sq, Sk, D,
                                                      causal):
    """The Function's forward launches the kernel once and its backward is
    the plain ``flash_attention_bwd_ref``: in f32 it equals
    ``torch.autograd.grad`` of ``flash_attention_ref`` within 1e-5 of max
    |.| (both f32 plain code), and its bf16 gradients are that f32
    gradient rounded (within a bf16 step of max |.|)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(BH + Sq + D)
    q, k, v = (torch.randn((BH, S, D), generator=gen, device=cuda)
               .bfloat16().requires_grad_(True) for S in (Sq, Sk, Sk))
    do = torch.randn((BH, Sq, D), generator=gen, device=cuda).bfloat16()
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*f32, causal=causal),
                               f32, do.float())
    plain = ref.flash_attention_bwd_ref(*(t.detach() for t in f32),
                                        do.float(), causal)
    for g, p, w in zip(got, plain, want):
        scale = float(w.abs().max())
        assert float((p - w).abs().max()) <= 1e-5 * scale
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w).abs().max()) <= 2.0 ** -8 * scale


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b"])
def test_loss_grads_on_card_equal_cpu(cuda, arch):
    """A smoke model's f32 loss and gradients on the card (the flash
    kernel's forward, the plain backward) against the CPU's: the loss
    within 1e-5, each leaf within 1e-3 of its largest entry (the kernel's
    f32 forward is within 2e-5 of the plain one, sums run in other
    orders), and every leaf's gradient non-zero: the attention weights
    get theirs through the kernel (F3)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.sharding import init_params, tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    cfg = get_smoke_config(arch)
    params = tree_map(lambda t: t.float(), init_params(
        build_model(cfg, device="cpu").specs,
        torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 40)),
             "labels": rng.integers(0, cfg.vocab, (2, 40))}
    assert not torch.backends.cuda.matmul.allow_tf32
    want_loss, _, want = loss_and_grads(build_model(cfg, device="cpu"),
                                        params, batch)
    before = flash_attention.launches
    got_loss, _, got = loss_and_grads(build_model(cfg, device=cuda),
                                      tree_map(lambda t: t.to(cuda), params),
                                      batch)
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    # the forward and, under remat, its recompute
    assert flash_attention.launches == before + 2 * attn
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = g.cpu()
        assert float(g.abs().max()) > 0
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


def test_ssd_scan_backward_on_card_equals_cpu(cuda):
    from repro_torch.models import mamba
    rng = np.random.default_rng(3)
    b, s, h, p, n, chunk = 2, 300, 8, 16, 32, 64
    args = [rng.normal(size=(b, s, h, p)),
            rng.uniform(0.05, 1.5, size=(b, s, h)),
            -rng.uniform(0.5, 1.5, size=(h,)),
            rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, h, p, n))]
    wy = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a.astype(np.float32)).to(dev)
              .requires_grad_(True) for a in args]
        y, st = mamba.ssd_scan(*ts[:5], chunk, s0=ts[5])
        grads.append(torch.autograd.grad((y * wy.to(dev)).sum() + st.sum(),
                                         ts))
    for w, g in zip(*grads):
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        assert err <= 2e-4


# ---------------------------------------------------------------------------
# the mesh (one-rank NCCL group; two gloo ranks on the card)
# ---------------------------------------------------------------------------

def _state_bits(state):
    from repro_torch.models.sharding import tree_leaves
    out = [state.opt.step]
    for tree in (state.params, state.opt.m, state.opt.v):
        out += tree_leaves(tree)
    return [t.detach().reshape(-1).view(torch.uint8).cpu() for t in out]


def test_one_rank_mesh_step_equals_the_step_without_a_mesh(cuda):
    """``make_host_mesh()`` on one card is a (1, 1) NCCL mesh; the smoke
    model's train step from the same state under ``use_mesh`` equals the
    step without a mesh bit for bit (deterministic algorithms on: the
    embedding backward otherwise sums in no fixed order)."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import mesh_shape, use_mesh
    from repro_torch.train.elastic import plan_mesh, reshard
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_smoke_config("llama3.2-3b")
    model = build_model(cfg, device=cuda)
    opt = AdamW(lr=lambda s: 1e-3)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 64)),
             "labels": rng.integers(0, cfg.vocab, (4, 64))}
    step = make_train_step(model, opt, microbatches=2)
    try:
        mesh = make_host_mesh()
        assert dist.get_backend() == "nccl"
        assert mesh_shape(mesh) == {"data": 1, "model": 1}
        assert mesh_shape(plan_mesh()) == {"data": 1, "model": 1}
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = []
        for on_mesh in (False, True):
            state = init_state(model, opt, torch.Generator(cuda).manual_seed(0),
                               device=cuda)
            if on_mesh:
                state = reshard(state, model.specs, mesh)
                with use_mesh(mesh):
                    state, met = step(state, batch)
            else:
                state, met = step(state, batch)
            runs.append((met["loss"].cpu(), _state_bits(state)))
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    (la, a), (lb, b) = runs
    assert torch.equal(la.view(torch.int32), lb.view(torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_compressed_psum_over_one_nccl_rank(cuda):
    """Over a one-rank NCCL group ``compressed_psum`` is bit for bit the
    dequantisation of ``_quantize``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train.compress import _quantize, compressed_psum
    x = torch.randn(1 << 20, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda) * 3
    try:
        mesh = make_host_mesh()
        with use_mesh(mesh):
            got = compressed_psum(x, "data")
    finally:
        dist.destroy_process_group()
    q, scale = _quantize(x)
    want = q.to(torch.float32) * scale
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _local_flash_rank(rank, world, store, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import (NamedSharding, P, constrain,
                                             use_mesh)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator(dev).manual_seed(0)
        q, k, v = (torch.randn(2, 256, 8, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        sh = NamedSharding(mesh, P("data", None, "model", None))
        dq, dk, dv = (distribute_tensor(t, mesh, sh.placements(),
                                        src_data_rank=None) for t in (q, k, v))
        before = ops.flash_attention.launches
        with use_mesh(mesh):
            o = L.chunked_attention(dq, dk, dv, causal=True, chunk=64)
            o = constrain(o, "batch", None, "heads", None)
        launched = ops.flash_attention.launches - before
        local = o.to_local()
        # each rank's heads against the same heads of the whole run (no
        # gather: gloo's functional all-gather of CUDA tensors kills a
        # rank, tools/gloo_cuda_probe.py)
        want = L.chunked_attention(q, k, v, causal=True, chunk=64)
        h = local.shape[2]
        torch.save({"launched": launched, "local_heads": h,
                    "equal": bool(torch.equal(
                        local, want[:, :, rank * h:(rank + 1) * h]))},
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_local_map_flash_on_dtensor_heads_equals_the_whole_tensor(cuda,
                                                                  tmp_path):
    """On two gloo ranks of the card, a (1, 2) (data, model) mesh: the
    attention of q, k, v sharded on their heads runs the kernel once a
    rank on its 4 local heads, and each rank's output equals the kernel
    on the whole tensors at those heads bit for bit (attention is local
    to a head)."""
    import torch.multiprocessing as mp
    mp.spawn(_local_flash_rank, args=(2, str(tmp_path / "store"),
                                      str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res == {"launched": 1, "local_heads": 4, "equal": True}, r
