#!/usr/bin/env python3
"""Time the per-query ``minmax_prune``, ``join_overlap`` and ``topk_boundary``
side by side at phase 4's inputs.

    python3 tools/per_query_variants.py [--parent DIR] [--n-rows N] [--json PATH]

Needs one CUDA card and ``nvcc``.  Builds ``chip_smoke.py``'s events table
and traffic and takes phase 4's inputs: ``minmax_prune`` at the widest
filter conjunction and at the one whose data needs the most bytes,
``join_overlap`` at the widest join (the longest key list), the median
one and the longest distinct summary on the events table's ``user_id``
intervals, and beside them on a random plane of the same P (every
tile's key window the whole list), and
``topk_boundary`` at the first unfiltered top-k query's ordered rows with
no upfront boundary.  At those inputs it times, in turns (CUDA events, L2
flushed, 10 runs a reading): each kernel's wrapper and its launch alone;
edited copies of its source (a design constant changed by text
substitution, built by ``tools/kernel_variants.py``); for the scan, other
tile sizes; and, with
``--parent DIR``, those sources of another checkout (the parent commit
unpacked with ``git archive``) that differ from this one's, called
through this checkout's entry points and behind the same checks as the
wrapper.  Every variant is first held equal
to the plain version at those inputs, except the edits named
"diagnostic", which stop the scan after a pass or leave out its merges
(to split its time by pass) or store the join's zeros without a search.
Each is read twice: plainly
(``chip_smoke.cuda_ms``, which also times the host's enqueue whenever the
card outruns it) and behind a device-side spin that keeps the card busy
while the host enqueues (``kernel_variants.spin_ms``: the device time
alone).  Prints the card's name and power limit, ptxas's registers and
spills for each edited build, the join inputs' (query, tile) windows by
the kernel's path, one line a variant with its four times, and the
device time of each kernel function that the launch alone of the widest
``minmax_prune``, of the scan and of each join runs, the parent's too
(``torch.profiler``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kernel_variants import (compile_all, edited, parent_jobs,
                             profile_device_us, spin_ms, time_in_turns,
                             write_json)

ROOT = Path(__file__).resolve().parents[1]

MINMAX = "minmax_prune"
JOIN = "join_overlap"
SCAN = "topk_boundary"
# the scan launcher's pass B and pass C launches, where a diagnostic stops
_PASS_B = "  if (m > 1) {\n    scan_kernel<<<groups"
_PASS_C = "  const int first = n > 1 ? 1 : 0;"
# (kernel, variant) -> (what it changes, [(text in the source, its
# replacement)]); each is built from the checkout's source
EDITS = {
    (MINMAX, "2 partitions a thread"): (
        "8-byte loads and stores", [
            ("constexpr int kV = 4;", "constexpr int kV = 2;")]),
    (MINMAX, "every nullable row read"): (
        "a constraint's nullable flags read with its min and max", [
            ("if (need) load_v(nullable + off, n, nl);",
             "load_v(nullable + off, n, nl);")]),
    (MINMAX, "128 threads a block"): (
        "blocks of 128 threads", [
            ("constexpr int kThreads = 256;   // threads a block",
             "constexpr int kThreads = 128;   // threads a block")]),
    (JOIN, "tiles of 2,048"): (
        "8 partitions a thread", [
            ("constexpr int kV = 4;", "constexpr int kV = 8;")]),
    (JOIN, "tiles of 4,096"): (
        "16 partitions a thread", [
            ("constexpr int kV = 4;", "constexpr int kV = 16;")]),
    (JOIN, "512 threads a block"): (
        "tiles of 2,048, 4 partitions a thread", [
            ("constexpr int kThreads = 256;          // threads a block",
             "constexpr int kThreads = 512;          // threads a block")]),
    (JOIN, "in place"): (
        "no window staged in shared memory: searched through L1", [
            ("constexpr int kStageKeys = 4096;",
             "constexpr int kStageKeys = 0;")]),
    (JOIN, "staged from 33 keys"): (
        "every window of 33 to 4,096 keys staged first", [
            ("constexpr int kStageMin = 1024;",
             "constexpr int kStageMin = 33;")]),
    (JOIN, "warp window at any size"): (
        "each warp narrows windows of kStageMin keys and more too", [
            ("} else if (kWarpWindow && m < kStageMin) {",
             "} else if (kWarpWindow) {")]),
    (JOIN, "no warp window"): (
        "each warp searches its tile's whole window", [
            ("constexpr bool kWarpWindow = true;",
             "constexpr bool kWarpWindow = false;")]),
    (JOIN, "searches one after another"): (
        "a thread's in-memory searches run one at a time, not interleaved", [
            ("""  for (int n = cnt; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int e = 0; e < kV; ++e)
      if (keys[f[e] + half - 1] < lo[e]) f[e] += half;
    n -= half;
  }""", """#pragma unroll 1
  for (int e = 0; e < kV; ++e) {
    for (int n = cnt; n > 1;) {
      const int half = n >> 1;
      if (keys[f[e] + half - 1] < lo[e]) f[e] += half;
      n -= half;
    }
  }""")]),
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
    (JOIN, "no register cap"): (
        "no minimum of 8 blocks an SM in the launch bounds", [
            ("__launch_bounds__(kThreads, kBlocksPerSM)",
             "__launch_bounds__(kThreads)")]),
    (JOIN, "diagnostic: no search"): (
        "every window taken as empty: the loads, the tile window and the "
        "stores (output not checked)", [
            ("    if (m > 0) {\n      const float* kp = distinct + a;",
             "    if (false) {\n      const float* kp = distinct + a;")]),
    (SCAN, "heads from the rows"): (
        "pass C reads each head from its row, no compact array", [
            ("const int use_heads = n > 1;", "const int use_heads = 0;")]),
    (SCAN, "8 rows staged"): (
        "at most 8 candidate rows loaded at once", [
            ("constexpr int kMaxStage = 32;", "constexpr int kMaxStage = 8;")]),
    (SCAN, "a warp's heads on 256 consecutive rows"): (
        "each warp's 8 head loads read one run of 256 rows", [
            ("auto hrow = [&](int r) { return r * kThreads + tid; };",
             "auto hrow = [&](int r) { return warp * 256 + r * 32 + lane; "
             "};")]),
    (SCAN, "pass B in one block"): (
        "one block scans all n - 1 tile heaps", [
            ("const int group = m > 1 ? scan_group(m) : 1;",
             "const int group = m > 1 ? m : 1;")]),
    (SCAN, "diagnostic: pass A alone"): (
        "the launches stop after pass A (output not checked)", [
            (_PASS_B, "  if (n > 1) return 0;\n" + _PASS_B)]),
    (SCAN, "diagnostic: passes A and B"): (
        "the launches stop before pass C (output not checked)", [
            (_PASS_C, "  if (n > 1) return 0;\n" + _PASS_C)]),
    (SCAN, "diagnostic: pass A's heads alone"): (
        "pass A reads and writes the heads and merges nothing, then the "
        "launches stop (output not checked)", [
            (_PASS_B, "  if (n > 1) return 0;\n" + _PASS_B),
            ("    while (true) {", "    while (kReplay) {")]),
    (SCAN, "diagnostic: pass C merges nothing"): (
        "pass C reads the heads and writes skips but stages and merges "
        "no row (output not checked)", [
            ("    while (true) {", "    while (!kReplay) {")]),
}
# scan tiles timed beside the wrapper's own (rows a tile)
SCAN_TILES = (2048, 8192, 16384)


def phase4_inputs(seed: int, n_rows: int, card: str, dev):
    """(minmax args by role, join args by role, scan rows [P, k]) as phase
    4 takes them; the join's roles are the widest and the median join,
    the longest distinct summary (the widest list a batched join takes)
    and a random plane of the same P with the widest join's count of
    keys."""
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.core.flow import PruningPipeline
    from repro_torch.kernels import ops

    _queries, ctx = cs.main_path_traffic(seed, card, n_rows)
    stats = ctx["events"].stats
    lowered = cs.lowered_filters(ctx)
    _need, widest, heaviest = cs.minmax_roles(lowered, stats, dev)
    by_q = dict(lowered)
    mm = {role: ops._stage_ranges(by_q[i], stats, dev)[0]
          for role, i in (("widest", widest), ("heaviest", heaviest))}
    lists = sorted(cs.join_key_lists(ctx), key=len)
    ndv = PruningPipeline(filter_mode="host").join_ndv_limit
    join = {role: ops._stage_join(stats, "user_id", keys, dev)
            for role, keys in (
                ("widest", lists[-1]), ("median", lists[len(lists) // 2]),
                ("summary", max((k for k in lists if len(k) <= ndv),
                                key=len)))}
    rng = np.random.default_rng(seed)
    P, D = stats.num_partitions, len(lists[-1])
    pmin = rng.integers(-5000, 10_000, P).astype(np.float32)
    pmax = pmin + rng.integers(0, 100, P).astype(np.float32)
    keys = np.sort(rng.choice(np.arange(-5000, 10_100), D, replace=False))
    join["random"] = tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                           for a in (pmin, pmax, keys))
    q = cs.picked_topk(ctx)[0]
    rows_all, _order = cs.ordered_topk_rows(ctx["events"], [q])[q.order_by[2]]
    rows = torch.from_numpy(np.ascontiguousarray(
        rows_all[:, :q.limit])).to(dev)
    return mm, join, rows


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
        print("per_query_variants: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import join_overlap as join_mod
    from repro_torch.kernels import minmax_prune as minmax_mod
    from repro_torch.kernels import topk_boundary as topk_mod

    card = cs.card_line()
    dev = torch.device("cuda")
    ops.load_kernels()
    jobs = {f"{kernel}: {name}": (kernel, edited(
        (build.CSRC / f"{kernel}.cu").read_text(), subs, name))
        for (kernel, name), (_what, subs) in EDITS.items()}
    jobs.update(parent_jobs(args.parent, (MINMAX, JOIN, SCAN)))
    regs = compile_all(jobs, ROOT / "build" / "per_query_variants")
    for label, r in regs.items():
        print(f"[variants] {card}: {label}: ptxas {r}", flush=True)

    mm_args, join_args, rows = phase4_inputs(args.seed, args.n_rows, card,
                                             dev)
    P, k = rows.shape
    b = float("-inf")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = topk_mod.scan_tile(P, k, sms)
    print(f"[variants] {card}: minmax_prune K = "
          f"{[int(a[0].shape[0]) for a in mm_args.values()]} (widest, "
          f"heaviest) at P = {int(mm_args['widest'][2].shape[1])}; "
          f"topk_boundary P = {P}, k = {k}, {-(-P // tile)} tiles of {tile} "
          f"rows on {sms} SMs", flush=True)
    for role, (pmin, pmax, d) in join_args.items():
        paths = ref.window_paths(*ref.join_windows(
            d[None], pmin, pmax, ref.JOIN_TILE_SINGLE))
        print(f"[variants] {card}: join_overlap {role}: D = {d.numel()}, "
              f"P = {pmin.numel()}; tiles of {ref.JOIN_TILE_SINGLE}, windows "
              f"by path: " + ", ".join(f"{k} {v}" for k, v in paths.items()),
              flush=True)

    def minmax_entry(label, a):
        def call():
            K, Pm = a[2].shape
            tv = torch.empty(Pm, dtype=torch.int32, device=dev)
            build.launch(label, dev, *a, tv, K, Pm)
            return tv
        return call

    def checked(call, a):
        """``call`` behind the wrapper's own checks (the parent's wrapper
        made the same ones)."""
        def run():
            K, Pm = a[2].shape
            for name, t, shape in (("lo", a[0], (K,)), ("hi", a[1], (K,)),
                                   ("mins", a[2], (K, Pm)),
                                   ("maxs", a[3], (K, Pm)),
                                   ("nullable", a[4], (K, Pm))):
                build.check_tensor(name, t, torch.float32, shape,
                                   a[2].device)
            return call()
        return run

    def join_entry(label, a, wrapped=False):
        def call():
            pmin, pmax, d = a
            if wrapped:                 # the wrapper's checks
                for name, t in (("pmin", pmin), ("pmax", pmax),
                                ("distinct", d)):
                    build.check_tensor(name, t, torch.float32, t.shape,
                                       pmin.device)
                join_mod.check_keys(pmin, pmax, d)
            hit = torch.empty(pmin.numel(), dtype=torch.int32, device=dev)
            build.launch(label, dev, pmin, pmax, d, hit, d.numel(),
                         pmin.numel())
            return hit
        return call

    def scan_entry(label, T):
        def call():
            n = -(-P // T)
            skip = torch.empty(P, dtype=torch.int32, device=dev)
            heap = torch.full((k,), b, dtype=torch.float32, device=dev)
            work = torch.empty(2 * n * k + P, dtype=torch.float32,
                               device=dev)
            build.launch(label, dev, rows, b, skip, heap, work, P, k, T)
            return skip, heap
        return call

    # name -> (what, the call, its plain output)
    variants = {}
    for role, a in mm_args.items():
        want = ref.minmax_prune_ref(*a)
        variants[f"{MINMAX} {role}: wrapper"] = (
            "as built, the wrapper", lambda a=a: ops.minmax_prune(*a), want)
        variants[f"{MINMAX} {role}: launch"] = (
            "as built, the launch alone",
            lambda a=a: minmax_mod.launch_checked(*a), want)
        for (kernel, name), (what, _subs) in EDITS.items():
            if kernel == MINMAX:
                variants[f"{MINMAX} {role}: {name}"] = (
                    what, minmax_entry(f"{kernel}: {name}", a), want)
        if f"{MINMAX}: parent" in jobs:
            launch = minmax_entry(f"{MINMAX}: parent", a)
            variants[f"{MINMAX} {role}: parent wrapper"] = (
                "the parent's source behind the wrapper's checks",
                checked(launch, a), want)
            variants[f"{MINMAX} {role}: parent launch"] = (
                "the parent's source, the launch alone", launch, want)
    for role, a in join_args.items():
        want = ref.join_overlap_ref(*a)
        variants[f"{JOIN} {role}: wrapper"] = (
            "as built, the wrapper", lambda a=a: ops.join_overlap(*a), want)
        variants[f"{JOIN} {role}: launch"] = (
            "as built, the launch alone",
            lambda a=a: join_mod.launch_checked(*a), want)
        for (kernel, name), (what, _subs) in EDITS.items():
            if kernel == JOIN:
                variants[f"{JOIN} {role}: {name}"] = (
                    what, join_entry(f"{kernel}: {name}", a),
                    None if name.startswith("diagnostic") else want)
        if f"{JOIN}: parent" in jobs:
            variants[f"{JOIN} {role}: parent wrapper"] = (
                "the parent's source behind the wrapper's checks",
                join_entry(f"{JOIN}: parent", a, wrapped=True), want)
            variants[f"{JOIN} {role}: parent launch"] = (
                "the parent's source, the launch alone",
                join_entry(f"{JOIN}: parent", a), want)
    want = ref.topk_boundary_ref(rows, b)
    variants[f"{SCAN}: wrapper"] = (
        f"as built, the wrapper: tiles of {tile}",
        lambda: ops.topk_boundary(rows, b), want)
    variants[f"{SCAN}: launch"] = (
        "as built, the launches alone",
        lambda: topk_mod.scan_launch_checked(rows, b), want)
    for T in SCAN_TILES:
        if T != tile and (-(-P // T) - 1) * k <= topk_mod.SCAN_FLOATS:
            variants[f"{SCAN}: tiles of {T}"] = (
                f"{-(-P // T)} tiles", scan_entry(SCAN, T), want)
    for (kernel, name), (what, _subs) in EDITS.items():
        if kernel == SCAN:
            variants[f"{SCAN}: {name}"] = (
                what, scan_entry(f"{kernel}: {name}", tile),
                None if name.startswith("diagnostic") else want)
    if f"{SCAN}: parent" in jobs:
        variants[f"{SCAN}: parent launch"] = (
            "the parent's source, the launch alone",
            scan_entry(f"{SCAN}: parent", tile), want)

    for name, (_what, fn, want) in variants.items():
        got = fn()
        if want is None:
            continue
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                cs.require_equal(name, g, w, "phase 4's inputs")
        else:
            cs.require_equal(name, got, want, "phase 4's inputs")
    calls = {name: fn for name, (_w, fn, _x) in variants.items()}
    plain = time_in_turns(calls, 10)
    spun = time_in_turns(calls, 10, timer=spin_ms)
    times = {}
    for name, (what, _fn, _want) in variants.items():
        times[name] = dict(plain=plain[name], spin=spun[name])
        print(f"[variants] {card}: {name} ({what}): plain "
              f"{plain[name][0]:.4f} / {plain[name][1]:.4f} ms, behind a "
              f"spin {spun[name][0]:.4f} / {spun[name][1]:.4f} ms",
              flush=True)
    prof = {name: profile_device_us(calls[name]) for name in (
        f"{MINMAX} widest: launch", f"{SCAN}: launch",
        *(f"{JOIN} {role}: {how}" for role in join_args
          for how in ("launch", "parent launch")
          if how == "launch" or f"{JOIN}: parent" in jobs))}
    for name, kernels in prof.items():
        print(f"[variants] {card}: {name}, device time a call by kernel "
              f"(torch.profiler): " + "; ".join(
                  f"{k} {us:.2f} us" for k, us in kernels.items()),
              flush=True)
    print(card)
    if args.json:
        write_json(args.json, dict(
            card=card, ms=times, ptxas=regs, profiler_us=prof,
            shapes=dict(minmax={r: [int(x) for x in a[2].shape]
                                for r, a in mm_args.items()},
                        join={r: dict(P=int(a[0].numel()),
                                      D=int(a[2].numel()))
                              for r, a in join_args.items()},
                        topk=dict(P=P, k=k, tile=tile, sms=sms))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
