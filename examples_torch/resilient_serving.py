"""Resilient serving: fail prune-less, never wrong, never crash.

Pruning's saving grace is that a safe degraded answer always exists —
keeping a partition is always correct, the scan just reads more.  The
resilience layer turns that into a degradation ladder every batched
launch runs through:

    sharded device kernel -> device kernel -> host kernel
        -> host oracle -> no-prune passthrough

Each rung gets bounded retries with exponential backoff and a per-stage
deadline; each demotion lands in ``counters["resilience"]``.  Beneath
the ladder, every staged metadata plane carries a CRC stamp that a
sampled read schedule re-verifies — a torn plane is quarantined and
restaged (a counter), never served as a wrong verdict.  (A kernel that
fails to build or launch raises ``KernelError`` and is never demoted:
the faults below are injected at the ladder's seams.)

This example injects three escalating failure waves through the
``FaultInjector`` chaos seam and reads the story off the counters:

  1. **transient launch blips** — retries absorb them, no demotion;
  2. **the device path goes dark** — every launch demotes to the host
     kernel; answers stay bit-identical to the oracle;
  3. **torn planes** — staged bytes corrupted in flight; the checksum
     verifier quarantines and restages, verdicts never change.

Run:  PYTHONPATH=src python examples_torch/resilient_serving.py [--device cpu]
"""

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
from repro_torch.data.table import Table
from repro_torch.serve.prune_service import PruningService
from repro_torch.serve.resilience import BackoffPolicy, FaultInjector

N_TABLES = 8
QUERIES_PER_ROUND = 32


def build_tables(rng, n):
    tables = []
    for i in range(n):
        rows = 240
        tables.append(Table.build(f"events_{i:03d}", {
            "ts": np.sort(rng.integers(0, 100_000, rows)).astype(np.int64),
            "score": rng.integers(0, 1_000, rows).astype(np.int64),
        }, rows_per_partition=10))
    return tables


def queries(rng, tables, n):
    qs = []
    for _ in range(n):
        t = tables[int(rng.integers(0, len(tables)))]
        lo = int(rng.integers(0, 90_000))
        qs.append(Query(scans={t.name: TableScanSpec(
            t, (E.col("ts") >= lo) & (E.col("ts") <= lo + 8_000))}))
    return qs


def kept(report, q):
    (name,) = q.scans
    return set(report.scan_sets[name].part_ids.tolist())


def main(device=None):
    rng = np.random.default_rng(0)
    tables = build_tables(rng, N_TABLES)
    oracle = PruningPipeline()          # the f64 host reference

    injector = FaultInjector(seed=7)
    svc = PruningService(device=device, fault_injector=injector,
                         backoff=BackoffPolicy(retries=2, base_delay=0.001),
                         integrity_sample=1)   # verify every read (demo;
                                               # the default samples every
                                               # 64th)
    pipe = PruningPipeline(filter_mode="device", service=svc)

    def wave3():
        injector.add("stage.stat", kind="corrupt", prob=0.5)
        for t in tables:                 # force restaging so the torn-plane
            svc.cache.invalidate(t.name)  # path actually runs this wave

    waves = [
        ("calm: no faults", lambda: None),
        ("wave 1: transient device blips (retries absorb them)",
         lambda: injector.add("launch.filter:device", times=2)),
        ("wave 2: device path dark (ladder demotes to the host kernel)",
         lambda: injector.add("launch.filter:device")),
        ("wave 3: torn planes (checksum quarantines + restages)", wave3),
    ]

    for title, arm in waves:
        injector.clear()
        arm()
        qs = queries(rng, tables, QUERIES_PER_ROUND)
        reports = svc.run_batch(qs, pipe)       # never raises
        res = reports[0].counters["resilience"]   # this batch's delta
        integ = reports[0].counters["integrity"]
        exact = all(kept(r, q) == kept(o, q) for r, q, o in
                    zip(reports, qs, (oracle.run(q) for q in qs)))
        demoted = {r: n for r, n in res["demotions"].items() if n}
        print(f"{title}\n"
              f"  retries={res['retries']} demotions={demoted or '{}'} "
              f"passthroughs={res['passthroughs']}\n"
              f"  planes: verified={integ['verifications']} "
              f"torn={integ['checksum_failures']} "
              f"quarantined={integ['quarantines']}\n"
              f"  verdicts vs host oracle: "
              f"{'bit-identical' if exact else 'superset (degraded)'}\n")
        assert exact, "every rung at or above the host oracle is exact"

    summary = svc.fleet_summary()
    print(f"lifetime: {summary['resilience']['retries']} retries, "
          f"{sum(summary['resilience']['demotions'].values())} demotions, "
          f"{summary['integrity']['quarantines']} quarantines — "
          f"0 wrong verdicts, 0 exceptions reached the caller.")


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
