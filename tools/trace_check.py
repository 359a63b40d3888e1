#!/usr/bin/env python3
"""Where the program's launch spans lie against the profiler's trace, in
one traced run of a benchmark cell.

    python3 tools/trace_check.py --workload events-prod.mixed \\
        --seed 7 --seconds 20 [--root DIR] [--json FILE]

Runs the cell as ``portbench/run.py --trace 1`` does (from the checkout
``--root``, default this one), except that the profiler records every
thread (``profile_all_threads``) and the tracer mirrors the spans of
every thread (``tracing.mirror_all_threads``), so each ``launch.<kernel>``
span of the front-end's worker has its ``record_function`` twin in the
profiler's trace.  Both cost the traced run time: take the per-layer
readings from ``portbench/run.py``.  Prints the result line, then one
JSON line:

  * ``sites_a_batch``: the program spans recorded a batch in the window;
  * ``clock``: each ``launch.<kernel>`` span's start on the profiler's
    host clock (its twin, aligned by the benchmark's one marker at the
    window's start) less its start on ``time.perf_counter``, in ms;
  * ``one_clock``: of the ``minmax_prune_batched`` and
    ``topk_init_batched`` kernels in the device trace, the share placed
    inside a program ``launch.<kernel>`` span of the same name, placed
    by the kernel's own start (``device``: the device time line, aligned
    as the benchmark aligns it) and by the start of the runtime call
    that launched it (``launch_call``: matched by the profiler's
    correlation id, on its host clock);
  * ``launch_lag_ms``: each such kernel's start less its launch call's
    start, both as the profiler gives them; on one time line it is never
    negative.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

TOPK_INIT_FUNCS = ("first_pass", "next_pass", "gather_rows", "write_heap")
KERNELS = (("minmax_prune_batched", lambda n: "minmax_prune_batched" in n),
           ("topk_init_batched",
            lambda n: any(f in n for f in TOPK_INIT_FUNCS)))


def all_threads_tracer(trace_mod, raw: dict):
    """The benchmark's tracer, recording every thread and keeping the
    profiler's events and the markers' host times in ``raw``."""
    import os
    import tempfile

    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    base = trace_mod.Tracer
    for attr in ("start", "stop", "_mark", "_marks", "spans", "_prof"):
        if not hasattr(base(), attr):
            raise SystemExit(f"portbench.trace.Tracer has no {attr}: "
                             "this tool needs updating")

    class AllThreads(base):
        def start(self):
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
            self._prof.start()
            self._mark("portbench.open")

        def stop(self):
            self._mark("portbench.close")
            self._prof.stop()
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    raw["events"] = json.load(f).get("traceEvents", [])
            raw["marks"] = dict(self._marks)
            self._prof = None
            self.trace = trace_mod.parse(raw["events"], self._marks,
                                         self.spans.records)

    return AllThreads


def _anchor(raw: dict) -> float:
    """profiler seconds less perf_counter seconds at the open marker, as
    ``portbench/trace.py`` computes it."""
    for e in raw["events"]:
        if e.get("name") == "portbench.open" and e.get("ph") == "X":
            mid = (float(e["ts"]) + float(e.get("dur", 0.0)) / 2.0) / 1e6
            return mid - raw["marks"]["portbench.open"]
    raise RuntimeError("no alignment marker")


def clock_check(raw: dict, trace, spans: list) -> dict:
    import numpy as np

    anchor = _anchor(raw)
    ev = [e for e in raw["events"] if e.get("ph") == "X"]
    twins: dict = {}
    for e in ev:
        if e.get("name", "").startswith("launch.") and \
                e.get("cat") != "gpu_user_annotation":
            twins.setdefault(e["name"], []).append(
                float(e["ts"]) / 1e6 - anchor)
    err = []
    for s in spans:
        if s.name.startswith("launch.") and s.name in twins:
            at = np.asarray(twins[s.name])
            j = int(np.argmin(np.abs(at - s.t0)))
            if abs(at[j] - s.t0) < 0.02:
                err.append(at[j] - s.t0)
    out = {"clock": {"twinned_spans": len(err)}}
    if err:
        out["clock"]["err_ms"] = (1e3 * np.percentile(
            err, [0, 1, 50, 99, 100])).round(4).tolist()
    calls = {(e.get("args") or {}).get("correlation"): float(e["ts"]) / 1e6
             for e in ev if e.get("cat") == "cuda_runtime"}
    shares: dict = {}
    lag = []
    for kernel, match in KERNELS:
        iv = sorted((s.t0, s.t1) for s in spans
                    if s.name == f"launch.{kernel}")
        starts = {"device": [], "launch_call": []}
        for e in ev:
            if e.get("cat") != "kernel" or not match(e.get("name", "")):
                continue
            t = float(e["ts"]) / 1e6
            if not trace.t_open <= t - anchor <= trace.t_close:
                continue
            starts["device"].append(t - anchor)
            c = (e.get("args") or {}).get("correlation")
            if c in calls:
                starts["launch_call"].append(calls[c] - anchor)
                lag.append(t - calls[c])
        shares[kernel] = {}
        for how, ts in starts.items():
            inside = sum(1 for t in ts if any(a <= t <= b for a, b in iv))
            shares[kernel][how] = {
                "kernels": len(ts), "inside": inside,
                "share": inside / len(ts) if ts else None}
    out["one_clock"] = shares
    if lag:
        lag = np.asarray(lag)
        out["launch_lag_ms"] = {
            "kernels": len(lag), "negative": int((lag < 0).sum()),
            "pct": (1e3 * np.percentile(lag, [0, 1, 50, 99, 100])
                    ).round(4).tolist()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]

    import torch

    from portbench import run as run_py
    from portbench import trace as trace_mod
    from portbench.harness import Cell, run_cell
    from repro_torch import tracing

    cell = Cell.load(args.workload, root)
    device = torch.device("cuda", 0)
    run_py.log(f"[trace_check] {args.workload} seed {args.seed} from {root} "
               f"on {torch.cuda.get_device_name(0)} ({run_py.card_line()})")
    raw: dict = {}
    tracing.clear()
    tracing.mirror_all_threads()
    trace_mod.Tracer = all_threads_tracer(trace_mod, raw)
    res = run_cell(cell, args.seed, args.seconds, True, device, T_START,
                   log=run_py.log)
    line = run_py.result_line(cell, res, True, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1, "memory_peak_bytes": int(res["peak"])})
    print(json.dumps(line), flush=True)
    run = res["run"]
    tr = run.trace
    spans = [s for s in tracing.records() if tr.t_open <= s.t0 <= tr.t_close]
    batches = run.delta("latency")["batches"]
    checks = {"sites_a_batch": len(spans) / batches if batches else None,
              "dropped": tracing.dropped(),
              **clock_check(raw, tr, spans)}
    print(json.dumps(checks), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"line": line, "checks": checks}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
