#!/usr/bin/env python3
"""Time the port's filter and Bloom kernels side by side at phase 3's inputs.

    python3 tools/prune_variants.py [--parent DIR] [--n-rows N] [--json PATH]

Needs one CUDA card and ``nvcc``.  Builds ``chip_smoke.py``'s phase 3
events table and batch of 256 queries, runs the batch's filter, LIMIT
and JOIN stages through a CUDA ``PruningService`` with the
``minmax_prune_batched`` and ``bloom_probe_batched`` calls recorded, and
takes the largest filter group and the Bloom group as the inputs.  At
those inputs it times (CUDA events, L2 flushed, 10 launches) each
kernel's variants: the wrapper as built; edited copies of its source (a
design constant changed by text substitution, built by
``tools/kernel_variants.py``); for the Bloom kernel, tables of 8- and
32-bit entries in place of the wrapper's; and, with ``--parent DIR``,
the two sources of another checkout (the parent commit unpacked with
``git archive``), called through their own entry points.  Every variant
is first held equal to the plain version at those inputs; the times are
taken in turns (forward, then backward over the variants), so a drift of
the card's clock favours none.  Prints the card's name and power limit,
ptxas's registers and spills for each edited build, and one line a
variant with its two times.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kernel_variants import compile_all, edited, time_in_turns, write_json

ROOT = Path(__file__).resolve().parents[1]

MINMAX = "minmax_prune_batched"
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
    seen = {MINMAX: [], BLOOM: []}
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
    return {MINMAX: largest, BLOOM: seen[BLOOM][0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose two kernel sources to time too")
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
    if args.parent:
        csrc = Path(args.parent) / "src" / "repro_torch" / "kernels" / "csrc"
        for kernel in (MINMAX, BLOOM):
            jobs[f"{kernel}: parent"] = (kernel,
                                         (csrc / f"{kernel}.cu").read_text())
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
    for b in (8, 16, 32):
        if b != bits:
            variants[BLOOM][f"{b}-bit tables"] = (
                f"{-(-Qb // b)} chunk(s) of {b} queries",
                bloom_entry(BLOOM, b), want_bl)
    for (kernel, name), (what, _subs) in EDITS.items():
        label = f"{kernel}: {name}"
        checked = not name.startswith("diagnostic")
        variants[kernel][name] = (
            what, minmax_entry(label, C) if kernel == MINMAX
            else bloom_entry(label, bits),
            (want_mm if kernel == MINMAX else want_bl) if checked else None)
    if args.parent:
        variants[MINMAX]["parent"] = (
            "the parent's source (32 queries a block)",
            minmax_entry(f"{MINMAX}: parent", max(1, min(32, 2048 // Kb))),
            want_mm)
        variants[BLOOM]["parent"] = ("the parent's source",
                                     bloom_entry(f"{BLOOM}: parent"),
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
    del want_mm, want_bl
    times = {}
    for kernel, vs in variants.items():
        got = time_in_turns({name: fn for name, (_w, fn, _x) in vs.items()},
                            10)
        for name, t in got.items():
            times[f"{kernel}: {name}"] = t
            print(f"[variants] {card}: {kernel} {name} ({vs[name][0]}): "
                  f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)
    print(card)
    if args.json:
        write_json(args.json, dict(
            card=card, ms=times, ptxas=regs,
            shapes=dict(filter=dict(Q=Q, Kb=Kb, C=C, P=P, Pc=Pc),
                        bloom=dict(Q=Qb, blocks=W // 16, P=Pb))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
