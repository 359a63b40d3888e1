#!/usr/bin/env python3
"""Time the port's filter, join and Bloom kernels side by side at phase 3's
inputs.

    python3 tools/prune_variants.py [--parent DIR] [--n-rows N] [--json PATH]

Needs one CUDA card and ``nvcc``.  Builds ``chip_smoke.py``'s phase 3
events table and batch of 256 queries, runs the batch's filter, LIMIT
and JOIN stages through a CUDA ``PruningService`` with the
``minmax_prune_batched``, ``join_overlap_batched`` and
``bloom_probe_batched`` calls recorded, and takes the largest filter
group, the join group and the Bloom group as the inputs; the join also
runs on phase 2's random plane (P = 2**21, 48 rows of 4,096 keys: every
tile's key window the whole row).  At those inputs it times (CUDA
events, L2 flushed, 10 launches) each kernel's variants: the wrapper as
built; edited copies of its source (a design constant changed by text
substitution, built by ``tools/kernel_variants.py``); for the Bloom
kernel, tables of 8- and 32-bit entries in place of the wrapper's; and,
with ``--parent DIR``, those of the three sources of another checkout
(the parent commit unpacked with ``git archive``) that differ from this
one's, called through this checkout's entry points.  Every variant is
first held equal to the plain version at those inputs, except the edits
named "diagnostic"; the times are taken in
turns (forward, then backward over the variants), so a drift of the
card's clock favours none, plainly and behind a device-side spin
(``kernel_variants.spin_ms``: the device time alone).  Prints the card's
name and power limit, ptxas's registers and spills for each edited
build, the join inputs' (query, tile) windows by the kernel's path, one
line a variant with its times, and the device time of the join's launch
by kernel function, the parent's too (``torch.profiler``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kernel_variants import (compile_all, edited, parent_jobs,
                             profile_device_us, spin_ms, time_in_turns,
                             write_json)

ROOT = Path(__file__).resolve().parents[1]

MINMAX = "minmax_prune_batched"
JOIN = "join_overlap_batched"
BLOOM = "bloom_probe_batched"
# (kernel, variant) -> (what it changes, [(text in the source, its
# replacement)]); each is built from the checkout's source
EDITS = {
    (MINMAX, "V = 4, 256 threads"): (
        "4 partitions a thread, tiles of 1,024", [
            ("constexpr int kV = 16;", "constexpr int kV = 4;"),
            ("constexpr int kThreads = 128;",
             "constexpr int kThreads = 256;")]),
    (MINMAX, "V = 8, 256 threads"): (
        "8 partitions a thread, tiles of 2,048", [
            ("constexpr int kV = 16;", "constexpr int kV = 8;"),
            ("constexpr int kThreads = 128;",
             "constexpr int kThreads = 256;")]),
    (MINMAX, "V = 16, 64 threads"): (
        "16 partitions a thread, tiles of 1,024", [
            ("constexpr int kThreads = 128;",
             "constexpr int kThreads = 64;")]),
    (MINMAX, "diagnostic: every row into row 0"): (
        "every query's verdicts stored over row 0, which stays in L2 "
        "(output not checked)", [
            ("store_verdicts(tv + static_cast<int64_t>(sl.w) * P, p0, P, v);",
             "store_verdicts(tv, p0, P, v);")]),
    (JOIN, "tiles of 1,024"): (
        "4 partitions a thread, 4-byte stores", [
            ("constexpr int kV = 8;", "constexpr int kV = 4;")]),
    (JOIN, "tiles of 4,096"): (
        "16 partitions a thread, 16-byte stores", [
            ("constexpr int kV = 8;", "constexpr int kV = 16;")]),
    (JOIN, "V = 4, 512 threads"): (
        "tiles of 2,048, 4-byte stores", [
            ("constexpr int kV = 8;", "constexpr int kV = 4;"),
            ("constexpr int kThreads = 256;",
             "constexpr int kThreads = 512;")]),
    (JOIN, "V = 16, 128 threads"): (
        "tiles of 2,048, 16-byte stores", [
            ("constexpr int kV = 8;", "constexpr int kV = 16;"),
            ("constexpr int kThreads = 256;",
             "constexpr int kThreads = 128;")]),
    (JOIN, "5 blocks an SM"): (
        "launch bounds cap the registers at 51 a thread", [
            ("void __launch_bounds__(kThreads) join_overlap_batched_kernel(",
             "void __launch_bounds__(kThreads, 5) "
             "join_overlap_batched_kernel(")]),
    (JOIN, "6 blocks an SM"): (
        "launch bounds cap the registers at 42 a thread", [
            ("void __launch_bounds__(kThreads) join_overlap_batched_kernel(",
             "void __launch_bounds__(kThreads, 6) "
             "join_overlap_batched_kernel(")]),
    (JOIN, "in place"): (
        "no window staged in shared memory: searched through L1", [
            ("constexpr int kStageKeys = 4096;",
             "constexpr int kStageKeys = 0;")]),
    (JOIN, "warp window at any size"): (
        "each warp narrows windows of kStageMin keys and more too", [
            ("} else if (kWarpWindow && m < kStageMin) {",
             "} else if (kWarpWindow) {")]),
    (JOIN, "no warp window"): (
        "each warp searches its tile's whole window", [
            ("constexpr bool kWarpWindow = true;",
             "constexpr bool kWarpWindow = false;")]),
    (JOIN, "staged from 33 keys"): (
        "every window of 33 to 4,096 keys staged (two barriers each)", [
            ("constexpr int kStageMin = 1024;",
             "constexpr int kStageMin = 33;")]),
    (JOIN, "binary lifting in memory"): (
        "in-memory probes at f + 2^j - 1, as in the shuffle search", [
            ("""  for (int n = cnt; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int e = 0; e < kV; ++e)
      if (keys[f[e] + half - 1] < lo[e]) f[e] += half;
    n -= half;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    f[e] += keys[f[e]] < lo[e];""",
             """  for (int step = 1 << (31 - __clz(cnt)); step; step >>= 1) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int nxt = f[e] + step;
      const float k = keys[(nxt < cnt ? nxt : cnt) - 1];
      if (nxt <= cnt && k < lo[e]) f[e] = nxt;
    }
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) {""")]),
    (JOIN, "window groups of 32 lanes"): (
        "a warp a tile-window search (16 for 8 lanes)", [
            ("constexpr int kGroup = 8;", "constexpr int kGroup = 32;")]),
    (JOIN, "diagnostic: no search"): (
        "every window taken as empty: the loads, the tile windows and the "
        "stores (output not checked)", [
            ("        if (m > 0) {\n          const float* kp = row + a;",
             "        if (false) {\n          const float* kp = row + a;")]),
    (BLOOM, "1024 threads"): (
        "blocks of 32 warps", [
            ("constexpr int kThreads = 512;",
             "constexpr int kThreads = 1024;")]),
}


def record_inputs(seed: int, n_rows: int, card: str, dev):
    """The largest filter group's and the Bloom group's (args, kwargs)
    from one batch's filter, LIMIT and JOIN stages on the card."""
    import chip_smoke as cs
    from repro_torch.core.flow import PruningPipeline
    from repro_torch.kernels import ops
    from repro_torch.serve.prune_service import PruningService

    queries, _ctx = cs.main_path_traffic(seed, card, n_rows)
    seen = {MINMAX: [], JOIN: [], BLOOM: []}
    real = {name: getattr(ops, name) for name in seen}

    def recorder(name):
        def rec(*a, **kw):
            seen[name].append((a, kw))
            return real[name](*a, **kw)
        return rec

    svc = PruningService(device=dev)
    pipe = PruningPipeline(filter_mode="device", service=svc)
    states = [pipe.make_state(q) for q in queries]
    for name in seen:
        setattr(ops, name, recorder(name))
    try:
        for tech in pipe.techniques:
            if tech.name != "topk":
                tech.run_batch(pipe, states, service=svc)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    if not seen[MINMAX] or not seen[BLOOM]:
        raise SystemExit(f"the batch made no call of "
                         f"{[n for n in seen if not seen[n]]}")
    largest = max(seen[MINMAX], key=lambda c: int(c[0][1].shape[0]))
    return {MINMAX: largest, JOIN: seen[JOIN][0], BLOOM: seen[BLOOM][0]}


def random_join_inputs(seed: int, dev, P: int = 1 << 21, Q: int = 48,
                       n_keys: int = 4096):
    """Phase 2's random join-key plane at P (integer intervals at most 100
    wide over [-5000, 10000), 10% and the capacity tail the drop sentinel)
    and Q rows of ``n_keys`` draws: (args, kwargs) of the wrapper."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.device_stats import plane_capacity
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    cap = plane_capacity(P)
    pmin = rng.integers(-5000, 10_000, cap).astype(np.float32)
    pmax = pmin + rng.integers(0, 100, cap).astype(np.float32)
    drop = rng.random(cap) < 0.1
    drop[P:] = True
    pmin[drop], pmax[drop] = cs.F32_MAX, -cs.F32_MAX
    lists = [np.unique(rng.integers(-5000, 10_000, n_keys)).astype(np.float32)
             for _ in range(Q)]
    dist = torch.from_numpy(ops.pack_distinct(lists)).to(dev)
    return ((dist, *(torch.from_numpy(a).to(dev) for a in (pmin, pmax))),
            dict(num_partitions=P))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernel sources to time too")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rows", type=int, default=2 ** 24)
    ap.add_argument("--json", default=None, help="also write the times here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prune_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import bloom_probe, build, ops, ref

    card = cs.card_line()
    dev = torch.device("cuda")
    ops.load_kernels()
    jobs = {f"{kernel}: {name}": (kernel, edited(
        (build.CSRC / f"{kernel}.cu").read_text(), subs, name))
        for (kernel, name), (_what, subs) in EDITS.items()}
    jobs.update(parent_jobs(args.parent, (MINMAX, JOIN, BLOOM)))
    regs = compile_all(jobs, ROOT / "build" / "prune_variants")
    for label, r in regs.items():
        print(f"[variants] {card}: {label}: ptxas {r}", flush=True)

    inputs = record_inputs(args.seed, args.n_rows, card, dev)
    mm_a, mm_kw = inputs[MINMAX]
    cids, lo, hi, mins, maxs, demote = mm_a
    Q, Kb = lo.shape
    C, Pc = mins.shape
    P = mm_kw["num_partitions"]
    bl_a, bl_kw = inputs[BLOOM]
    words, pmin, width = bl_a
    Qb, W = words.shape
    Pb = bl_kw["num_partitions"]
    bits, _nbytes = bloom_probe.table_plan(Qb, W // 16)
    joins = {"phase 3": inputs[JOIN],
             "random": random_join_inputs(args.seed, dev)}
    for role, (a, kw) in joins.items():
        paths = ref.window_paths(*ref.join_windows(
            *a, ref.JOIN_TILE_BATCHED, kw["num_partitions"]))
        print(f"[variants] {card}: join group ({role}) Q={a[0].shape[0]} "
              f"Db={a[0].shape[1]} P={kw['num_partitions']} "
              f"Pc={a[1].shape[0]}; tiles of {ref.JOIN_TILE_BATCHED}, "
              f"windows by path: " + ", ".join(
                  f"{k} {v}" for k, v in paths.items()), flush=True)
    print(f"[variants] {card}: filter group Q={Q} Kb={Kb} C={C} P={P} "
          f"Pc={Pc}; Bloom group Q={Qb} blocks={W // 16} P={Pb}, "
          f"{bits}-bit table entries", flush=True)

    def minmax_entry(label, last):
        def call():
            tv = torch.empty((Q, P + 128), dtype=torch.int8, device=dev)
            build.launch(label, dev, *mm_a, tv, Q, Kb, P, Pc, last)
            return tv.view(-1)[:Q * P].view(Q, P)   # room for a diagnostic
        return call

    def bloom_entry(label, bits=None):
        def call():
            hit = torch.empty((Qb, Pb), dtype=torch.int8, device=dev)
            if bits is None:            # the parent's entry point
                build.launch(label, dev, words, pmin, width, hit, Qb,
                             W // 16, Pb)
                return hit
            table = torch.empty(-(-Qb // bits) * W * 32 * bits // 8,
                                dtype=torch.uint8, device=dev)
            build.launch(label, dev, words, pmin, width, hit, table, Qb,
                         W // 16, Pb, bits)
            return hit
        return call

    def join_entry(label, a, kw):
        def call():
            dist, pmin, pmax = a
            Qj, Db = dist.shape
            Pj = kw["num_partitions"]
            hit = torch.empty((Qj, Pj), dtype=torch.int8, device=dev)
            build.launch(label, dev, dist, pmin, pmax, hit, Qj, Db, Pj)
            return hit
        return call

    want_mm = ref.minmax_prune_batched_ref(*mm_a, **mm_kw)
    want_bl = ref.bloom_probe_batched_ref(*bl_a, **bl_kw)
    # kernel -> name -> (what, the call, its plain output or None)
    variants = {
        MINMAX: {"as built": (
            "the wrapper", lambda: ops.minmax_prune_batched(*mm_a, **mm_kw),
            want_mm)},
        BLOOM: {"as built": (
            f"the wrapper: {bits}-bit entries",
            lambda: ops.bloom_probe_batched(*bl_a, **bl_kw), want_bl)},
    }
    variants[JOIN] = {}
    for role, (a, kw) in joins.items():
        want = ref.join_overlap_batched_ref(*a, **kw)
        variants[JOIN][f"{role}: as built"] = (
            "the wrapper", lambda a=a, kw=kw: ops.join_overlap_batched(
                *a, **kw), want)
        for (kernel, name), (what, _subs) in EDITS.items():
            if kernel == JOIN:
                variants[JOIN][f"{role}: {name}"] = (
                    what, join_entry(f"{kernel}: {name}", a, kw),
                    None if name.startswith("diagnostic") else want)
        if f"{JOIN}: parent" in jobs:
            variants[JOIN][f"{role}: parent"] = (
                "the parent's source (one query a block)",
                join_entry(f"{JOIN}: parent", a, kw), want)
    for b in (8, 16, 32):
        if b != bits:
            variants[BLOOM][f"{b}-bit tables"] = (
                f"{-(-Qb // b)} chunk(s) of {b} queries",
                bloom_entry(BLOOM, b), want_bl)
    for (kernel, name), (what, _subs) in EDITS.items():
        if kernel == JOIN:
            continue
        label = f"{kernel}: {name}"
        checked = not name.startswith("diagnostic")
        variants[kernel][name] = (
            what, minmax_entry(label, C) if kernel == MINMAX
            else bloom_entry(label, bits),
            (want_mm if kernel == MINMAX else want_bl) if checked else None)
    if f"{MINMAX}: parent" in jobs:
        variants[MINMAX]["parent"] = (
            "the parent's source", minmax_entry(f"{MINMAX}: parent", C),
            want_mm)
    if f"{BLOOM}: parent" in jobs:
        variants[BLOOM]["parent"] = (
            "the parent's source", bloom_entry(f"{BLOOM}: parent", bits),
            want_bl)

    # yardstick: PyTorch's fill of a [Q, P] int8 tensor, the verdict
    # store alone
    fill = torch.empty((Q, P), dtype=torch.int8, device=dev)
    variants[MINMAX]["yardstick: fill_"] = (
        "torch's fill_ of the [Q, P] int8 output (not a port kernel)",
        lambda: fill.fill_(2), None)
    for kernel, vs in variants.items():
        for name, (_what, fn, want) in vs.items():
            got = fn()
            if want is not None:
                cs.require_equal(f"{kernel} ({name})", got, want,
                                 "phase 3's inputs")
    del want_mm, want_bl, want
    times = {}
    for kernel, vs in variants.items():
        calls = {name: fn for name, (_w, fn, _x) in vs.items()}
        plain = time_in_turns(calls, 10)
        spun = time_in_turns(calls, 10, timer=spin_ms)
        for name in calls:
            times[f"{kernel}: {name}"] = dict(plain=plain[name],
                                              spin=spun[name])
            print(f"[variants] {card}: {kernel} {name} ({vs[name][0]}): "
                  f"plain {plain[name][0]:.4f} / {plain[name][1]:.4f} ms, "
                  f"behind a spin {spun[name][0]:.4f} / {spun[name][1]:.4f}"
                  f" ms", flush=True)
    prof = {name: profile_device_us(variants[JOIN][name][1])
            for name in variants[JOIN]
            if name.endswith(("as built", "parent"))}
    for name, kernels in prof.items():
        print(f"[variants] {card}: {JOIN} {name}, device time a call by "
              f"kernel (torch.profiler): " + "; ".join(
                  f"{k} {us:.2f} us" for k, us in kernels.items()),
              flush=True)
    print(card)
    if args.json:
        write_json(args.json, dict(
            card=card, ms=times, ptxas=regs, profiler_us=prof,
            shapes=dict(filter=dict(Q=Q, Kb=Kb, C=C, P=P, Pc=Pc),
                        join={r: dict(Q=int(a[0].shape[0]),
                                      Db=int(a[0].shape[1]),
                                      P=kw["num_partitions"])
                              for r, (a, kw) in joins.items()},
                        bloom=dict(Q=Qb, blocks=W // 16, P=Pb))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
