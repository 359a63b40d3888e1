#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 5] [--json PATH]

Phases (each failure exits non-zero; nothing is caught and passed over):

  1. environment: torch version, the card's name and power limit, and the
     build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  2. kernel vs plain version on the card: ``minmax_prune_batched`` against
     ``ref.minmax_prune_batched_ref`` on the same inputs, exact equality of
     every verdict, over Q x Kb x C x P grids with drop sentinels inside P
     and in the capacity tail, (-inf, +inf) no-op slots, bounds equal to a
     stat and denormal bounds and stats, and conjunctions of up to 8192
     ranges (longer than the kernel's shared-memory tile);
  3. the main path at full size: ``PruningService.run_batch`` over the
     production-like events table (2**24 rows in 1,048,576
     micro-partitions, 6 columns) and a 600-row users dimension table, one
     batch of 256 queries (192 filter-only, 64 plain LIMIT) — one warm-up
     batch, then ``--batches`` timed ones.  Every batch must be
     bit-identical to the same service on the CPU (the plain version),
     bit-identical to the f64 host pipeline on int/dictionary predicates,
     keep every partition the host pipeline keeps, and run with no
     demotion, salvage or passthrough and exactly one kernel launch per
     table group.  Then the split of one batch's time by stage.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed just before them.  Without a CUDA device, or without the rest of
the repository beside this file, the script exits non-zero before any
result is printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory rate and f32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events around
    each run), with the 50 MB L2 cache flushed before every run: a batch
    finds the resident planes cold, not in L2 from the previous launch."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for e0, e1 in zip(starts, ends):
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / reps


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

F32_MAX = np.float32(np.finfo(np.float32).max)
DENORMALS = np.array([1e-45, 1e-40, 1.1754942e-38, -1e-45, -1e-40, 0.0,
                      -0.0], dtype=np.float32)


def random_planes(rng, C: int, P: int, cap: int):
    """[C, cap] planes: integer-ish intervals, denormal values, all-null
    style demotes, drop sentinels inside P and the sentinel tail."""
    mins = rng.integers(-1000, 1000, (C, cap)).astype(np.float32)
    maxs = mins + rng.integers(0, 200, (C, cap)).astype(np.float32)
    den = rng.random((C, cap)) < 0.05
    mins[den] = rng.choice(DENORMALS, int(den.sum()))
    maxs[den] = np.maximum(mins[den], rng.choice(DENORMALS, int(den.sum())))
    demote = (rng.random((C, cap)) < 0.25).astype(np.float32)
    drop = rng.random((C, cap)) < 0.05
    drop[:, P:] = True
    mins[drop], maxs[drop], demote[drop] = F32_MAX, -F32_MAX, 1.0
    return mins, maxs, demote


def random_constraints(rng, Q: int, Kb: int, C: int, mins, maxs, P: int):
    cids = rng.integers(0, C, (Q, Kb)).astype(np.int32)
    lo = rng.integers(-1100, 1100, (Q, Kb)).astype(np.float32)
    hi = lo + rng.integers(0, 400, (Q, Kb)).astype(np.float32)
    # bounds equal to a stat of some partition (inclusive ends)
    pick = rng.integers(0, max(P, 1), (Q, Kb))
    eq = rng.random((Q, Kb)) < 0.3
    lo[eq] = mins[cids[eq], pick[eq]]
    eq = rng.random((Q, Kb)) < 0.3
    hi[eq] = maxs[cids[eq], pick[eq]]
    # denormal bounds
    den = rng.random((Q, Kb)) < 0.15
    lo[den] = rng.choice(DENORMALS, int(den.sum()))
    den = rng.random((Q, Kb)) < 0.15
    hi[den] = rng.choice(DENORMALS, int(den.sum()))
    # one-sided and no-op slots
    lo[rng.random((Q, Kb)) < 0.1] = -F32_MAX
    hi[rng.random((Q, Kb)) < 0.1] = F32_MAX
    noop = rng.random((Q, Kb)) < 0.25
    lo[noop], hi[noop] = -np.inf, np.inf
    return cids, lo, hi


def phase_kernel_vs_plain(seed: int, dev, sizes=(1, 31, 4097, 1 << 20)
                          ) -> dict:
    import torch

    from repro_torch.core.device_stats import plane_capacity
    from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
    from repro_torch.kernels.ref import minmax_prune_batched_ref

    rng = np.random.default_rng(seed)
    cases = 0
    max_err = 0
    max_p = 0
    for C in (1, 6, 33):
        for P in sizes:
            cap = plane_capacity(P)
            mins, maxs, demote = random_planes(rng, C, P, cap)
            planes = [torch.from_numpy(a).to(dev) for a in (mins, maxs, demote)]
            for Q in (1, 7, 256, 300):
                for Kb in (1, 2, 4, 8):
                    cids, lo, hi = random_constraints(rng, Q, Kb, C, mins,
                                                      maxs, P)
                    cq = [torch.from_numpy(a).to(dev) for a in (cids, lo, hi)]
                    got = minmax_prune_batched(*cq, *planes, num_partitions=P)
                    sync(dev)
                    want = minmax_prune_batched_ref(*cq, *planes,
                                                    num_partitions=P)
                    err = int((got.int() - want.int()).abs().max().item())
                    if err or got.shape != want.shape:
                        raise SystemExit(
                            f"kernel != plain version at Q={Q} Kb={Kb} "
                            f"C={C} P={P}: max abs err {err}")
                    max_err = max(max_err, err)
                    max_p = max(max_p, P)
                    cases += 1
            del planes
    # conjunctions longer than the kernel's 2048-slot shared tile: a
    # block stages its slots in chunks
    for Q, Kb, P in ((3, 3000, 4097), (2, 8192, 4097), (33, 2049, 31)):
        C = 6
        mins, maxs, demote = random_planes(rng, C, P, plane_capacity(P))
        cids, lo, hi = random_constraints(rng, Q, Kb, C, mins, maxs, P)
        # keep the long conjunctions satisfiable: mostly no-op slots
        keep = rng.random((Q, Kb)) < 0.02
        lo[~keep], hi[~keep] = -np.inf, np.inf
        args = [torch.from_numpy(a).to(dev)
                for a in (cids, lo, hi, mins, maxs, demote)]
        got = minmax_prune_batched(*args, num_partitions=P)
        sync(dev)
        want = minmax_prune_batched_ref(*args, num_partitions=P)
        err = int((got.int() - want.int()).abs().max().item())
        if err or got.shape != want.shape:
            raise SystemExit(f"kernel != plain version at Q={Q} Kb={Kb} "
                             f"C={C} P={P}: max abs err {err}")
        cases += 1
    return dict(cases=cases, max_abs_err=max_err, max_p=max_p)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
# The traffic is a copy of the reference benchmark's production mix
# (benchmarks/workload.py: sample_filter_pred, small_table,
# sample_limit_query) written against the port's own expression module.

def sample_filter_pred(rng, E):
    u = rng.random()
    ts_max = 10_000_000
    if u < 0.28:
        # recent-data scan: selectivity lognormal around ~1%
        frac = float(np.exp(rng.normal(np.log(0.01), 1.4)))
        frac = min(frac, 1.0)
        return E.col("ts") >= ts_max * (1 - frac)
    if u < 0.42:
        # time window + categorical
        frac = float(np.exp(rng.normal(np.log(0.03), 1.0)))
        lo = ts_max * (1 - min(frac, 1.0))
        grp = rng.choice(["ok", "warn", "err", "crit"])
        return (E.col("ts") >= lo) & E.startswith(E.col("status"), str(grp))
    if u < 0.75:
        # categorical only
        grp = rng.choice(["ok", "warn", "err", "crit"])
        return E.like(E.col("status"), f"{grp}-%")
    # unselective predicate (prunes nothing)
    return E.col("score") >= float(rng.uniform(0.0, 0.2))


def sample_limit_query(rng, events, users, E, Query, TableScanSpec,
                       sample_limit_k):
    with_pred = rng.random() < (2.23 / 2.60)
    if rng.random() < 0.72:
        # dashboard-style LIMIT over the small dimension table
        pred = (E.col("age") >= int(rng.integers(20, 60))) if with_pred \
            else E.true()
        scans = {"events": TableScanSpec(users, pred)}
    else:
        pred = sample_filter_pred(rng, E) if with_pred else E.true()
        scans = {"events": TableScanSpec(events, pred)}
    return Query(scans=scans, limit=sample_limit_k(rng),
                 offset=int(rng.integers(0, 10)) if rng.random() < 0.1 else 0)


def reports_equal(a, b) -> bool:
    if a.scan_sets.keys() != b.scan_sets.keys():
        return False
    for name in a.scan_sets:
        sa, sb = a.scan_sets[name], b.scan_sets[name]
        if not (np.array_equal(sa.part_ids, sb.part_ids)
                and np.array_equal(sa.match, sb.match)):
            return False
        if a.per_scan[name].keys() != b.per_scan[name].keys():
            return False
        for tech in a.per_scan[name]:
            ra, rb = a.per_scan[name][tech], b.per_scan[name][tech]
            if (ra.before, ra.after, ra.applied, ra.detail) != \
                    (rb.before, rb.after, rb.applied, rb.detail):
                return False
    return True


def keeps_superset(dev_rep, host_rep) -> bool:
    return all(np.isin(host_rep.scan_sets[n].part_ids,
                       dev_rep.scan_sets[n].part_ids).all()
               for n in host_rep.scan_sets)


def integral_only(q) -> bool:
    for spec in q.scans.values():
        for c in spec.pred.columns():
            if spec.table.columns[c].kind == "float":
                return False
    return True


def phase_main_path(seed: int, n_batches: int, card: str, dev,
                    n_rows: int = 2 ** 24) -> dict:
    import torch

    from repro_torch.core import expr as E
    from repro_torch.core.device_stats import plane_checksum
    from repro_torch.core.flow import (FilterTechnique, LimitTechnique,
                                       PruningPipeline, Query, TableScanSpec)
    from repro_torch.core.prune_filter import extract_ranges
    from repro_torch.data.generator import (make_events_table,
                                            make_users_table, sample_limit_k)
    from repro_torch.kernels import ops
    from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
    from repro_torch.kernels.ref import minmax_prune_batched_ref
    from repro_torch.serve.prune_service import PruningService

    t0 = time.perf_counter()
    events = make_events_table(np.random.default_rng(seed), n_rows=n_rows,
                               rows_per_partition=16, ts_clustering=0.995,
                               user_clustering=0.995)
    users = make_users_table(np.random.default_rng(seed + 99), n_rows=600,
                             rows_per_partition=750)
    log(f"[main] {card} host: tables built in {time.perf_counter() - t0:.1f} s: events "
        f"P={events.num_partitions} C={len(events.columns)}, users "
        f"P={users.num_partitions}")

    rng = np.random.default_rng(seed)
    queries = [Query(scans={"events": TableScanSpec(events,
                                                    sample_filter_pred(rng, E))})
               for _ in range(192)]
    queries += [sample_limit_query(rng, events, users, E, Query,
                                   TableScanSpec, sample_limit_k)
                for _ in range(64)]
    queries = [queries[i] for i in rng.permutation(len(queries))]

    # table groups with lowered predicates: one launch each per batch
    groups = {}
    non_lowering = 0
    for q in queries:
        for spec in q.scans.values():
            if isinstance(spec.pred, E.TruePred):
                continue
            ranges = extract_ranges(spec.pred, spec.table.stats)
            if ranges is None:
                non_lowering += 1
            else:
                groups.setdefault(spec.table.name, []).append(ranges)
    log(f"[main] {len(queries)} queries, table groups "
        f"{ {k: len(v) for k, v in groups.items()} }, "
        f"non-lowering predicates {non_lowering}")

    t0 = time.perf_counter()
    cpu_reports = PruningService(device="cpu").run_batch(queries)
    t_cpu = time.perf_counter() - t0
    host = PruningPipeline(filter_mode="host")
    t0 = time.perf_counter()
    host_reports = [host.run(q) for q in queries]
    t_host = time.perf_counter() - t0
    log(f"[main] {card} host: references: CPU plain service {t_cpu:.2f} s, f64 host "
        f"pipeline {t_host:.2f} s")
    exact_host = [integral_only(q) for q in queries]

    svc = PruningService(device=dev)
    minmax_prune_batched.launches = 0       # the main path's count from here
    times = []
    last = None
    for b in range(n_batches + 1):
        before = minmax_prune_batched.launches
        sync(dev)
        t0 = time.perf_counter()
        reports = svc.run_batch(queries)
        sync(dev)
        dt = time.perf_counter() - t0
        if b:
            times.append(dt)
        c = reports[0].counters
        res = c["resilience"]
        launched = minmax_prune_batched.launches - before
        problems = []
        if any(res["demotions"].values()):
            problems.append(f"demotions {res['demotions']}")
        if res["salvaged_batches"] or res["passthroughs"] or res["errors"]:
            problems.append(f"resilience {res}")
        if launched != len(groups):
            problems.append(f"{launched} kernel launches for "
                            f"{len(groups)} table groups")
        for i, (r, rc, rh) in enumerate(zip(reports, cpu_reports,
                                            host_reports)):
            if not reports_equal(r, rc):
                problems.append(f"query {i}: differs from the CPU run")
            if exact_host[i] and not reports_equal(r, rh):
                problems.append(f"query {i}: differs from the host pipeline")
            if not keeps_superset(r, rh):
                problems.append(f"query {i}: drops a partition the host "
                                f"pipeline keeps")
        if problems:
            raise SystemExit(f"batch {b}: " + "; ".join(problems[:10]))
        log(f"[main] {card}: batch {b}{' (warm-up)' if b == 0 else ''}: "
            f"{dt * 1e3:.2f} ms, launches {launched}, host fallbacks "
            f"{c['technique'].get('filter', {}).get('fallbacks', 0)}, "
            f"checks passed")
        last = reports
    main_launches = minmax_prune_batched.launches
    med = statistics.median(times)
    kept = sum(len(ss) for r in last for ss in r.scan_sets.values())
    touched = sum(s.table.num_partitions for q in queries
                  for s in q.scans.values())
    log(f"[main] {card}: median batch {med * 1e3:.3f} ms over "
        f"{len(times)} batches ({[round(t * 1e3, 3) for t in times]}), "
        f"{len(queries) / med:.1f} queries/s; partitions kept "
        f"{kept} of {touched} ({1 - kept / touched:.4%} pruned); "
        f"{sum(exact_host)} of {len(queries)} queries held bit-exact "
        f"to the host pipeline")

    # ---- split of one batch, events group ------------------------------
    ranges = groups["events"]
    dstats = svc.cache.get(events)
    split = {}
    t0 = time.perf_counter()
    cids, lo, hi, _safe = ops.pack_ranges(ranges, dstats)
    split["pack_ranges_ms"] = (time.perf_counter() - t0) * 1e3
    Q = len(ranges)
    sync(dev)
    t0 = time.perf_counter()
    cq = [torch.from_numpy(np.ascontiguousarray(a[:Q])).to(dev)
          for a in (cids, lo, hi)]
    sync(dev)
    split["h2d_ms"] = (time.perf_counter() - t0) * 1e3
    (mins, maxs, demote), P = dstats.planes_state
    args = (*cq, mins, maxs, demote)
    kernel_ms = cuda_ms(lambda: minmax_prune_batched(*args, num_partitions=P),
                        20)
    plain_ms = cuda_ms(lambda: minmax_prune_batched_ref(*args,
                                                        num_partitions=P), 3)
    got = minmax_prune_batched(*args, num_partitions=P)
    want = minmax_prune_batched_ref(*args, num_partitions=P)
    main_err = int((got.int() - want.int()).abs().max().item())
    if main_err:
        raise SystemExit(f"kernel != plain version at the main path's "
                         f"shape: max abs err {main_err}")
    split["kernel_ms"] = kernel_ms
    sync(dev)
    t0 = time.perf_counter()
    tv = got.cpu().numpy()
    sync(dev)
    split["d2h_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for row in tv:
        svc._scan_set(row, events)
    split["scan_sets_ms"] = (time.perf_counter() - t0) * 1e3
    pipe = PruningPipeline(filter_mode="device", service=svc)
    states = [pipe.make_state(q) for q in queries]
    t0 = time.perf_counter()
    FilterTechnique().run_batch(pipe, states, service=svc)
    split["filter_stage_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    LimitTechnique().run_batch(pipe, states, service=svc)
    split["limit_stage_ms"] = (time.perf_counter() - t0) * 1e3
    # the cache's sampled integrity check (every 64th getter hit by
    # default) reads the whole plane back and re-stamps it
    t0 = time.perf_counter()
    if plane_checksum(dstats.planes) != dstats.checksum:
        raise SystemExit("resident events plane fails its checksum")
    split["integrity_verify_ms"] = (time.perf_counter() - t0) * 1e3
    cols_used = len({c for r in ranges for c, _, _ in r})
    Kb = int(cids.shape[1])
    nbytes = 3 * 4 * cols_used * P + Q * P + Q * Kb * 12
    ops_count = 10 * Q * Kb * P
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops_count / F32_OPS_PER_S else "operations")
    log(f"[split] {card}: events group Q={Q} Kb={Kb} C={dstats.num_columns} "
        f"P={P} capacity={dstats.capacity}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[split] {card}: kernel {kernel_ms:.4f} ms vs bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB over 3.35 TB/s), plain "
        f"version {plain_ms:.3f} ms; resident plane bytes "
        f"{svc.cache.resident_bytes}; integrity {svc.cache.integrity_snapshot()}")
    return dict(
        queries=len(queries), groups={k: len(v) for k, v in groups.items()},
        non_lowering=non_lowering, batch_ms=[t * 1e3 for t in times],
        median_batch_ms=med * 1e3, queries_per_s=len(queries) / med,
        partitions_kept=kept, partitions_touched=touched,
        exact_host_queries=sum(exact_host), cpu_ref_s=t_cpu,
        host_ref_s=t_host, split_ms=split, kernel_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_bytes=nbytes, launches=main_launches, main_max_abs_err=main_err,
        resident_bytes=svc.cache.resident_bytes, shape=dict(
            Q=Q, Kb=Kb, C=dstats.num_columns, P=P,
            capacity=dstats.capacity, cols_used=cols_used))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--json", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.minmax_prune_batched import load_kernel

    t_start = time.perf_counter()
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t0 = time.perf_counter()
    load_kernel()
    build_s = time.perf_counter() - t0
    log(f"[env] {card}: kernels built and loaded in {build_s:.2f} s")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kv = phase_kernel_vs_plain(args.seed, dev)
    log(f"[kernel] {card}: {kv['cases']} cases, kernel == plain version exactly up "
        f"to P={kv['max_p']} (max abs err {kv['max_abs_err']}) in "
        f"{time.perf_counter() - t0:.1f} s")

    mp = phase_main_path(args.seed, args.batches, card, dev)
    log(f"[done] {card}: {time.perf_counter() - t_start:.1f} s in all")

    kernels = {"kernels": [dict(
        name="minmax_prune_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/minmax_prune_batched.cu",
        replaces="src/repro/kernels/minmax_prune_batched.py:82",
        launches=mp["launches"],
        max_abs_err=max(kv["max_abs_err"], mp["main_max_abs_err"]),
        ms=mp["kernel_ms"], plain_ms=mp["plain_ms"], bound_ms=mp["bound_ms"],
        bound_by=mp["bound_by"], library_ms=None)]}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, build_s=build_s,
                 kernel_vs_plain=kv, main_path=mp, **kernels), indent=1))
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
