"""The hand-written CUDA kernel against its plain version, on the card.

These tests need a CUDA device and the CUDA compiler; without a card
each one skips (a skip is no pass: on a machine without a GPU the kernel
is checked only by ``chip_smoke.py`` on the card).  Run them there with

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import device_stats as TD
from repro_torch.core.metadata import ColumnMeta, PartitionStats
import importlib

from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
from repro_torch.kernels.ref import minmax_prune_batched_ref

F32_MAX = np.float32(np.finfo(np.float32).max)
tmpb = importlib.import_module("repro_torch.kernels.minmax_prune_batched")


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


@pytest.mark.parametrize("Q,Kb,C,P", [
    (1, 1, 1, 1), (7, 2, 6, 31), (64, 4, 6, 4097), (300, 8, 33, 5000),
    # conjunctions longer than the kernel's 2048-slot shared tile
    (3, 3000, 6, 700), (2, 8192, 6, 4097),
])
def test_kernel_equals_plain_version(cuda, Q, Kb, C, P):
    rng = np.random.default_rng(P)
    cap = TD.plane_capacity(P)
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(rng, Q, Kb, C, P, cap)]
    before = minmax_prune_batched.launches
    got = minmax_prune_batched(*args, num_partitions=P)
    torch.cuda.synchronize()
    assert minmax_prune_batched.launches == before + 1
    want = minmax_prune_batched_ref(*args, num_partitions=P)
    assert got.dtype == torch.int8 and tuple(got.shape) == (Q, P)
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
    tmpb.load_kernel()
    monkeypatch.setattr(tmpb, "_fn", lambda *_a: 1)   # cudaErrorInvalidValue
    with pytest.raises(KernelError, match="cudaError 1"):
        svc.run_batch([Query(scans={"e": TableScanSpec(
            ev, E.col("ts") >= 5_000_000)})])
    assert not any(svc.resilience["demotions"].values())
    assert svc.resilience["salvaged_batches"] == 0
