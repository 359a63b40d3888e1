"""Streaming ingest: append -> prune -> drop on delta-staged device planes.

A streaming workload continuously creates and drops micro-partitions.
Without delta staging, ANY DML bumps the table version and forces a full
``[C, P]`` restage of every resident device plane — O(table) staging per
append.  With it, the planes are allocated with padded partition
capacity and replay the table's delta log: appends stage only the new
``[C, ΔP]`` columns, drops scatter no-op sentinels, and only a rewrite
or capacity overflow pays a full restage.  The staging counters in
``PruningReport.counters["staging"]`` make the difference visible.

Run:  PYTHONPATH=src python examples_torch/streaming_ingest.py [--device cpu]
"""

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
from repro_torch.data.table import Table
from repro_torch.serve.prune_service import PruningService


def main(device=None):
    rng = np.random.default_rng(0)

    def batch(n, t0, span=10_000):
        """One ingest flush: n event rows from a moving time window."""
        return {
            "ts": (t0 + rng.integers(0, span, n)).astype(np.int64),
            "user_id": rng.integers(0, 5_000, n).astype(np.int64),
            "score": rng.integers(0, 1_000, n).astype(np.int64),
        }

    # A fact table with 200 initial micro-partitions, clustered by time.
    events = Table.build("events", batch(200_000, 0, span=10_000_000),
                         rows_per_partition=1000)
    events.update_column("ts", np.sort(events.data["ts"]).astype(np.int64))

    svc = PruningService(device=device)
    pipe = PruningPipeline(filter_mode="device", service=svc)

    def recent_window(k=None):
        q = Query(scans={"events": TableScanSpec(
            events, E.col("ts") >= int(events.data["ts"].max()) - 20_000)})
        if k:
            q.limit, q.order_by = k, ("events", "score", True)
        return q

    def show(tag, rep):
        f = rep.per_scan["events"]["filter"]
        s = rep.counters["staging"]
        e = rep.counters["planes"]["events"]
        print(f"{tag:>22}: {f.before:4d} -> {f.after:3d} partitions | "
              f"staged {s['staged_bytes']:>9,} B "
              f"(delta={s['delta_stages']}, full={s['full_restages']}) | "
              f"epoch v{e['version']} live={e['live']}/{e['capacity']}")

    # -- 1. first batch stages the full [C, cap] planes (once) -------------
    rep = svc.run_batch([recent_window()], pipe)[0]
    show("initial staging", rep)

    # -- 2. streaming appends: each flush stages only the [C, ΔP] delta ----
    t0 = 10_000_000
    for i in range(4):
        events.append_partitions(batch(2_000, t0 + i * 10_000),
                                 rows_per_partition=1000)
        rep = svc.run_batch([recent_window()], pipe)[0]
        show("append +2 partitions", rep)

    # -- 3. retention: drop the oldest partitions (sentinel scatter) -------
    events.drop_partitions(np.arange(8))
    rep = svc.run_batch([recent_window()], pipe)[0]
    show("drop 8 oldest", rep)

    # -- 4. runtime techniques ride the same delta-synced planes -----------
    rep = svc.run_batch([recent_window(k=10)], pipe)[0]
    t = rep.per_scan["events"]["topk"]
    show("top-k over deltas", rep)
    print(f"{'':>22}  top-k boundary skipped "
          f"{t.before - t.after} of {t.before} partitions "
          f"(path: {t.detail['path']})")

    # -- 5. an in-place rewrite is the one op that restages in full --------
    pid = int(np.where(events.live_mask)[0][0])
    n = int(np.diff(events.part_bounds)[pid])
    events.rewrite_partitions([pid], batch(n, t0))
    rep = svc.run_batch([recent_window()], pipe)[0]
    show("rewrite 1 partition", rep)

    host = PruningPipeline().run(recent_window())
    assert np.array_equal(rep.scan_sets["events"].part_ids,
                          host.scan_sets["events"].part_ids)
    print(f"{'':>22}  device scan set == host oracle after all DML ✓")


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
