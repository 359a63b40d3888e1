#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--precision bfloat16] [--queries N]

For each seed it makes the cell's tables at the cell's size, draws the
queries a run judges (the stream's verified prefix and its seeded sample,
over the first ``N`` queries), answers them with the reference computed in
``--precision`` and judges those answers against the float64 reference.
The port stages its metadata in float32 with outward rounding; bfloat16
rounded to nearest is the step below it, and it has to come out not
correct.  float64 must judge itself correct.  The benchmark's own runs do
not run this; ``tests/test_portbench_faults.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from portbench import gen  # noqa: E402
from portbench.harness import Cell, unit_hash  # noqa: E402
from portbench.reference.engine import Reference  # noqa: E402
from portbench.reference.judge import CHECKS, judge  # noqa: E402
from portbench.traffic import Stream  # noqa: E402


def verified(stream: Stream, mix: dict, seed: int, n: int):
    """The indices a run of ``n`` window queries judges."""
    prefix = int(mix["verify_prefix"])
    rates = mix["verify_rate"]
    return [i for i in range(max(n, prefix))
            if i < prefix or unit_hash(seed, i)
            < rates.get(stream.spec_cls(i), 0.0)]


def control(cell: Cell, seed: int, precision: str, n: int,
            raw=None) -> dict:
    """Check counts of ``precision``'s answers against float64."""
    raw = raw if raw is not None else gen.make_tables(cell.config, seed)
    stream = Stream(cell.mix, seed)
    truth = Reference(raw, cell.config)
    other = Reference(raw, cell.config, precision)
    counts = {c: 0 for c in CHECKS}
    idx = verified(stream, cell.mix, seed, n)
    for i in idx:
        q = stream.spec(i)
        for c in judge(truth, q, other.answer(q)):
            counts[c] += 1
    return {"seed": seed, "precision": precision, "judged": len(idx),
            "checks": counts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--queries", type=int, default=1024)
    args = p.parse_args(argv)
    cell = Cell.load(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        raw = gen.make_tables(cell.config, seed)
        for prec in ("float64", args.precision):
            r = control(cell, seed, prec, args.queries, raw)
            r["seconds"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
