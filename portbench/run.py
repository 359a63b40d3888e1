#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: the port is imported from ``src/``.  It
needs the card(s) the cell asks for and exits non-zero without them; it
never falls back to the CPU.  The last line of standard output is the
JSON result; the last lines of standard error are the numbers compared,
each beside its limit.  ``--trace 1`` reports the per-layer metrics (with
the spans and ``torch.profiler`` on) instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from portbench.harness import (breakdown, forbidden_modules,  # noqa: E402
                               scanned_pct)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(cell, res) -> dict:
    run = res["run"]
    values = {"queries_per_s": len(run.window) / (run.t1 - run.t0),
              "partitions_scanned_pct": scanned_pct(run),
              "setup_s": res["setup_s"]}
    out = {}
    for m in cell.bench["end_to_end"]:
        if applies(m, cell.workload["name"]):
            if values.get(m["name"]) is None:
                raise RuntimeError(f"no reading for {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(cell, res) -> dict:
    out = {}
    for m in cell.bench["per_layer"]:
        if not applies(m, cell.workload["name"]):
            continue
        family = m["name"].split(".")[0]
        reader = importlib.import_module(f"portbench.metrics.{family}")
        v = reader.read(res["run"], m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell, res, traced: bool, device_info: dict) -> dict:
    """The contract's last line: the numbers compared come last."""
    checks = res["checks"]
    line = {"correct": res["judged"] > 0 and all(v == 0
                                                 for v in checks.values()),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": (per_layer(cell, res) if traced
                        else end_to_end(cell, res)),
            "device": dict(device_info)}
    tr = res["run"].trace
    if tr is not None:
        line["device"]["busy_s"] = sum(b - a for a, b in tr.busy_intervals())
        line["device"]["window_s"] = tr.t_close - tr.t_open
        line["breakdown"] = breakdown(tr)
    line["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return line


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    # a fault in native code (the profiler, a kernel's wrapper) prints every
    # thread's Python stack on standard error before the process dies
    faulthandler.enable(all_threads=True)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import Cell, run_cell

    cell = Cell.load(args.workload)
    chips = int(cell.workload["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[portbench] {args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    device = torch.device("cuda", 0)
    log(f"[portbench] {args.workload} seed {args.seed} on "
        f"{torch.cuda.get_device_name(0)} ({card_line()})")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START, log=log)
    line = result_line(cell, res, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": chips, "memory_peak_bytes": int(res["peak"])})
    # after every metric reader has been imported and has run
    loaded = forbidden_modules()
    if loaded:
        log(f"[portbench] the process loaded {loaded} (JAX or the JAX "
            f"package): no result")
        return 3
    for e in res["errors"]:
        log(f"[portbench] {e}")
    log(f"[portbench] answers judged: {res['judged']} (at least 1)")
    for k, v in res["checks"].items():
        log(f"[portbench] check {k}: {v} (limit 0)")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
