"""Sublinear batched pruning: the hierarchical tree plane at large P.

The flat batched kernel is one launch for Q queries — but that launch
still scans all P partitions per query, so qps collapses linearly as a
table grows.  The tree plane family makes the *pruning decision itself*
sublinear, the paper's thesis applied to its own metadata:

  1. **group hulls** — the `[C, P]` min/max/demote plane aggregates
     into `[C, G]` per-group hulls (G = capacity / fanout) plus a tiny
     host-resident coarse root.  A range that misses a group's hull
     provably misses every member partition.
  2. **pay before you launch** — the coarse root is evaluated on the
     host first.  If a predicate keeps more than half the groups, the
     pre-pass cannot win and the engine runs the flat launch directly
     (zero extra launches on dense workloads); otherwise gathered
     evaluations touch only surviving groups' members, so device cost
     scales with survivors, not P.
  3. **same answers** — group pruning only ever *removes* provably-NO
     partitions; FULL is never decided above leaves.  Verdicts are
     bit-identical to the flat path and the f64 host oracle, and the
     tree planes ride the same delta staging, memory budget, CRC
     integrity protocol, and degradation ladder (rungs
     ``sharded_tree``/``tree`` demote to the flat rungs on any fault).

This walkthrough stages one clustered table at a few sizes and prints
the flat-vs-tree wall time plus the counters that show which path ran.
(``launches`` counts kernel launches; a filter group on the gathered tree
path launches none and counts under ``tree_launches`` alone.)

Run:  PYTHONPATH=src python examples_torch/sublinear_pruning.py [--device cpu]
"""

import time

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core.device_stats import (DeviceStats, plane_capacity,
                                           resolve_device, tree_entry_for)
from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
from repro_torch.core.metadata import ColumnMeta, PartitionStats
from repro_torch.data.table import Table
from repro_torch.kernels import ops
from repro_torch.serve.prune_service import PruningService

Q = 64
SPAN_PARTS = 256          # absolute survivor span per query


def clustered_stats(rng, P):
    """Sorted minima: the natural clustering that makes pruning work."""
    mins = np.sort(rng.uniform(0.0, 1e6, (P, 2)), axis=0)
    maxs = mins + (1e6 / P) * rng.uniform(0.5, 4.0, (P, 2))
    return PartitionStats(
        columns=[ColumnMeta("ts", "float"), ColumnMeta("score", "float")],
        mins=mins, maxs=maxs,
        null_counts=np.zeros((P, 2), dtype=np.int64),
        row_counts=np.full(P, 100, dtype=np.int64))


def narrow_queries(rng, P):
    """Fixed absolute span: survivors stay constant as P grows."""
    width = np.float32(1e6 * SPAN_PARTS / P)
    out = []
    for _ in range(Q):
        lo = np.float32(rng.uniform(0.0, 1e6 - float(width)))
        out.append([(0, float(lo), float(np.float32(lo + width)))])
    return out


def _timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def kernel_level(rng, dev):
    print(f"== kernel level: flat vs tree, Q={Q} narrow queries ==")
    for P in (100_000, 1_000_000):
        stats = clustered_stats(rng, P)
        dstats = DeviceStats.stage(stats, capacity=plane_capacity(P),
                                   device=dev)
        tree = tree_entry_for(dstats)
        queries = narrow_queries(rng, P)

        def flat():
            return ops.prune_ranges_batched_device(queries, dstats)

        def treed():
            return ops.prune_ranges_batched_tree(queries, dstats, tree)

        tv_flat, tv_tree = flat(), treed()        # warm + verify
        np.testing.assert_array_equal(tv_tree, tv_flat)
        _, s_flat = _timed(flat, dev)
        _, s_tree = _timed(treed, dev)
        note = ops.last_tree_stats()
        print(f"  P={P:>9,}: flat {s_flat * 1e3:8.1f} ms   "
              f"tree {s_tree * 1e3:7.1f} ms   "
              f"({s_flat / s_tree:6.1f}x, path={note['path']}, "
              f"coarse density {note.get('coarse_density', 0):.3f}) "
              f"- bit-identical")

    # dense workload: the coarse root declines the pre-pass, zero extra
    # launches
    stats = clustered_stats(rng, 100_000)
    dstats = DeviceStats.stage(stats, capacity=plane_capacity(100_000),
                               device=dev)
    tree = tree_entry_for(dstats)
    wide = [[(0, 0.0, 1e6)] for _ in range(Q)]
    ops.prune_ranges_batched_tree(wide, dstats, tree)
    print(f"  dense predicate -> path={ops.last_tree_stats()['path']} "
          "(pre-pass skipped, one flat launch)")


def service_level(rng, dev):
    print("\n== service level: tree rungs in the degradation ladder ==")
    rows = 40_960
    table = Table.build("events", {
        "ts": np.sort(rng.integers(0, 1_000_000, rows)).astype(np.int64),
        "score": rng.integers(0, 1_000, rows).astype(np.int64),
    }, rows_per_partition=10)                     # 4096 partitions
    svc = PruningService(device=dev, tree_fanout=64)
    pipe = PruningPipeline(filter_mode="device", service=svc)
    lo = 500_000
    qs = [Query(scans={"events": TableScanSpec(
        table, (E.col("ts") >= lo + i) & (E.col("ts") <= lo + i + 5_000))})
        for i in range(16)]
    reports = svc.run_batch(qs, pipe)
    kept = sum(len(r.scan_sets["events"].part_ids) for r in reports)
    c = reports[0].counters
    print(f"  {len(qs)} queries over {table.num_partitions} partitions: "
          f"kept {kept} partition scans total")
    print(f"  launches={c['launches']} tree_launches={c['tree_launches']} "
          f"host_fallbacks={c['host_fallbacks']}")

    # DML: the tree plane delta-replays alongside the flat plane
    table.append_partitions({
        "ts": np.sort(rng.integers(0, 1_000_000, 640)).astype(np.int64),
        "score": rng.integers(0, 1_000, 640).astype(np.int64),
    }, rows_per_partition=10)
    svc.run_batch(qs, pipe)
    snap = svc.cache.staging_snapshot()
    print(f"  after append: delta_stages={snap['delta_stages']} "
          f"full_restages={snap['full_restages']} "
          "(tree groups re-aggregated in place)")


def main(device=None):
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    kernel_level(rng, dev)
    service_level(rng, dev)


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
