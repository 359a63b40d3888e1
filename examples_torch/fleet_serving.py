"""Fleet serving: thousands of tables under a device-memory budget.

The paper's pruning numbers assume the min/max metadata is *always hot*
— which, fleet-wide, only works if residency is bounded.  This example
drives a many-table workload with skewed, shifting table popularity
through the budgeted engine and reads the knobs off the counters:

  1. **budget sizing** — stage the fleet once unbounded and read
     ``cache.resident_bytes``: that is the working set.  A budget is a
     fraction of it; the counters tell you whether the fraction holds.
  2. **eviction counters** — ``counters["memory"]`` per batch:
     ``hits / misses`` (plane getter traffic), ``evictions`` (LRU
     pressure), ``restage_storms`` (a previously-evicted plane came
     back: the thrash signal — if it climbs every round, the budget is
     too small for the workload's hot set).
  3. **the invariants** — ``bytes_in_use`` never exceeds the budget
     (``over_budget_events == 0``) because every launch pins its planes
     only while in flight.

With more than one card the same engine partition-shards every launch
over the plane mesh (``shard_mesh=True``), so one table's planes can
outgrow a single card; outputs are bit-identical either way.

Run:  PYTHONPATH=src python examples_torch/fleet_serving.py [--device cpu]
"""

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
from repro_torch.core.device_stats import resolve_device
from repro_torch.data.table import Table
from repro_torch.serve.prune_service import PruningService

N_TABLES = 48
ROUNDS = 6
QUERIES_PER_ROUND = 64


def build_fleet(rng, n):
    """n small fact tables: same schema, independent data."""
    tables = []
    for i in range(n):
        rows = 240
        tables.append(Table.build(f"events_{i:03d}", {
            "ts": np.sort(rng.integers(0, 100_000, rows)).astype(np.int64),
            "user_id": rng.integers(0, 5_000, rows).astype(np.int64),
            "score": rng.integers(0, 1_000, rows).astype(np.int64),
        }, rows_per_partition=10))
    return tables


def skewed_queries(rng, tables, popularity, n):
    """Zipf-popular tables; filter + top-k mix (tight windows)."""
    qs = []
    for _ in range(n):
        t = tables[int(rng.choice(len(tables), p=popularity))]
        lo = int(rng.integers(0, 90_000))
        if rng.random() < 0.25:
            qs.append(Query(
                scans={t.name: TableScanSpec(t, E.col("ts") >= lo)},
                limit=5, order_by=(t.name, "score", True)))
        else:
            qs.append(Query(scans={t.name: TableScanSpec(
                t, (E.col("ts") >= lo) & (E.col("ts") <= lo + 8_000))}))
    return qs


def zipf(n, s=2.2):
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def main(device=None):
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    tables = build_fleet(rng, N_TABLES)

    # -- 1. budget sizing: measure the unbounded working set ---------------
    probe = PruningService(device=dev)
    probe_pipe = PruningPipeline(filter_mode="device", service=probe)
    probe.run_batch(skewed_queries(rng, tables,
                                   np.full(N_TABLES, 1 / N_TABLES),
                                   2 * N_TABLES), probe_pipe)
    working_set = probe.cache.resident_bytes
    budget = int(working_set * 0.25)   # holds the zipf hot set, not the tail
    print(f"unbounded working set ~{working_set:,} B -> budget {budget:,} B "
          f"(25%)\n")

    # -- 2. the budgeted (and, with several cards, sharded) fleet engine ---
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    shard = n_dev > 1
    svc = PruningService(device=dev, budget_bytes=budget,
                         shard_mesh=True if shard else None)
    pipe = PruningPipeline(filter_mode="device", service=svc)
    print(f"devices={n_dev} sharded={'yes' if shard else 'no'}\n")

    popularity = zipf(N_TABLES)
    for rnd in range(ROUNDS):
        if rnd == ROUNDS // 2:
            # popularity shifts mid-run: yesterday's cold tables become hot
            # — the LRU follows, at the price of restage storms
            popularity = popularity[::-1].copy()
            print("-- popularity flipped --")
        reports = svc.run_batch(skewed_queries(rng, tables, popularity,
                                               QUERIES_PER_ROUND), pipe)
        m = reports[0].counters["memory"]
        print(f"round {rnd}: hits={m['hits']:4d} misses={m['misses']:3d} "
              f"evictions={m['evictions']:3d} "
              f"storms={m['restage_storms']:3d} | "
              f"in_use {m['bytes_in_use']:>9,} / {budget:,} B "
              f"(peak {m['peak_bytes']:,})")

    # -- 3. the invariants + lifetime summary ------------------------------
    summary = svc.fleet_summary()
    mem = summary["memory"]
    assert mem["over_budget_events"] == 0, "budget was exceeded"
    assert mem["peak_bytes"] <= budget
    print(f"\nlifetime: plane hit rate {summary['plane_hit_rate']:.1%}, "
          f"{mem['evictions']} evictions, {mem['restage_storms']} restage "
          f"storms, {summary['counters']['sharded_launches']} sharded "
          f"launches")
    print("budget never exceeded; pinned launches never lost a plane.")


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
