"""Quickstart: the paper's four pruning techniques in ~60 lines.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Each query runs through ``PruningPipeline(filter_mode="device")``: its
filter, LIMIT, JOIN and top-k stages on the resident planes of the card
(or, with ``--device cpu``, the kernels' plain versions on the CPU).
"""

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core.flow import (JoinSpec, PruningPipeline, Query,
                                   TableScanSpec)
from repro_torch.data.generator import make_events_table, make_users_table
from repro_torch.data.scan import execute_query


def main(device=None):
    rng = np.random.default_rng(0)
    pipe = PruningPipeline(filter_mode="device", device=device)

    # A production-shaped fact table: 200 micro-partitions, clustered by
    # time.
    events = make_events_table(rng, n_rows=200_000, rows_per_partition=1000,
                               user_clustering=0.995)
    users = make_users_table(rng, n_rows=20_000)

    # -- 1. filter pruning (Sec. 3): a tight recent-time window -----------
    q = Query(scans={"events": TableScanSpec(events,
                                             E.col("ts") >= 9_950_000)})
    report = pipe.run(q)
    f = report.per_scan["events"]["filter"]
    print(f"filter pruning : {f.before} -> {f.after} partitions "
          f"({f.ratio:.1%} pruned)")

    # -- 2. LIMIT pruning (Sec. 4): fully-matching partitions --------------
    q = Query(scans={"events": TableScanSpec(events,
                                             E.col("ts") >= 5_000_000)},
              limit=100)
    report = pipe.run(q)
    lim = report.per_scan["events"]["limit"]
    print(f"LIMIT pruning  : {lim.before} -> {lim.after} partitions "
          f"(category: {lim.detail['category']})")
    res = execute_query(q, report)
    print(f"                 {res.num_rows} rows returned, "
          f"{res.total_bytes()/1e6:.2f} MB scanned")

    # -- 3. top-k pruning (Sec. 5): boundary values -------------------------
    q = Query(scans={"events": TableScanSpec(events, E.col("score") >= 0.5)},
              limit=10, order_by=("events", "num_sightings", True))
    report = pipe.run(q)
    t = report.per_scan["events"]["topk"]
    print(f"top-k pruning  : {t.before} -> {t.after} partitions "
          f"({t.ratio:.1%} skipped by the boundary value)")

    # -- 4. join pruning (Sec. 6): build-side summaries ---------------------
    q = Query(
        scans={
            "users": TableScanSpec(users, E.col("age") >= 80),
            "events": TableScanSpec(events),
        },
        join=JoinSpec("users", "events", "id", "user_id"),
    )
    report = pipe.run(q)
    j = report.per_scan["events"]["join"]
    print(f"join pruning   : {j.before} -> {j.after} partitions "
          f"({j.ratio:.1%} pruned, summary={j.detail['summary_kind']}, "
          f"{j.detail['summary_bytes']} bytes shipped)")

    # -- everything together (the paper's guiding example shape) ------------
    q = Query(
        scans={
            "users": TableScanSpec(users, E.col("age") >= 80),
            "events": TableScanSpec(events, E.col("score") >= 0.25),
        },
        join=JoinSpec("users", "events", "id", "user_id"),
        limit=3, order_by=("events", "num_sightings", True),
    )
    report = pipe.run(q)
    print(f"combined       : overall pruning ratio {report.overall_ratio:.1%}")


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
