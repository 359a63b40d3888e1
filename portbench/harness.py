"""One run of one cell: set-up, the measured window, the checks, the line.

The loop is closed: ``clients`` query engines each wait for their pruning
answer before they send the next query.  Each query is submitted through
``ServingFrontend.submit`` (``max_batch`` = clients) and its completion
callback submits the client's next one, so C queries stay outstanding
without a thread a client.  The window opens when the first C are
submitted and stops taking new queries after ``seconds``; it closes when
the last query in flight has its answer, so the rate counts all the work
and all the time of whole batches.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import threading
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import gen
from .reference.engine import Reference
from .reference.judge import CHECKS, judge
from .traffic import Stream, to_port

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix."""

    bench: dict
    workload: dict
    config: dict
    mix: dict

    @staticmethod
    def load(name: str, root: Path = REPO) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        w = find(bench["workloads"], name)
        entry = find(bench["configs"], w["config"])
        return Cell(bench, w, load_json(root / entry["file"]),
                    load_json(root / HERE.name / "mixes"
                              / f"{w['traffic']}.json"))


def port_tables(raw: Dict[str, gen.RawTable]) -> dict:
    """The program's ``Table`` for each raw table (copies of the arrays)."""
    from repro_torch.data.table import Table

    out = {}
    for name, t in raw.items():
        metas = {c: types.SimpleNamespace(kind=col.kind,
                                          dictionary=col.dictionary)
                 for c, col in t.columns.items()}
        out[name] = Table.from_arrays(
            name, metas, {c: col.values for c, col in t.columns.items()},
            {}, t.bounds)
    return out


def unit_hash(seed: int, i: int) -> float:
    """A uniform [0, 1) number fixed by (seed, i): splitmix64."""
    m = (1 << 64) - 1
    z = (gen.seed_key(seed) * 0x9E3779B97F4A7C15 + i + 1) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return ((z ^ (z >> 31)) & m) / float(1 << 64)


def plain_answer(report) -> dict:
    """The program's report as the judge reads it (arrays copied)."""
    scans = {n: (np.array(ss.part_ids, dtype=np.int64),
                 np.array(ss.match, dtype=np.int8))
             for n, ss in report.scan_sets.items()}
    tech = {n: {t: (r.before, r.after, dict(r.detail))
                for t, r in techs.items()}
            for n, techs in report.per_scan.items()}
    topk = None
    if report.topk is not None:
        topk = {"values": np.array(report.topk.values, dtype=np.float64),
                "skipped": np.array(report.topk.skipped, dtype=np.int64),
                "scan": report.topk_scan}
    return {"scans": scans, "tech": tech, "topk": topk}


class Clients:
    """C closed-loop clients over one seeded stream."""

    def __init__(self, frontend, stream: Stream, tables: dict, n: int,
                 keep, on_query=None, spans=None, prepared=None):
        self.fe = frontend
        self.prepared = prepared or {}   # i -> the program's Query, made
                                         # in set-up
        self.stream = stream
        self.tables = tables
        self.n = n
        self.keep = keep              # keep(i) -> hold the report
        self.on_query = on_query      # on_query(i, query): traced runs
        self.spans = spans
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.next = 0
        self.outstanding = 0
        self.t_end = float("inf")
        self.times: Dict[int, tuple] = {}     # i -> (t_submit, t_done, ok)
        self.reports: Dict[int, object] = {}
        self.scanned: Dict[int, int] = {}     # i -> partitions left to scan
        self.count_below = 0                  # record scanned for i < this
        self.errors: List[str] = []
        self.built_in_window = 0

    def _submit(self, i: Optional[int] = None) -> None:
        with self.lock:
            if i is None:
                i = self.next
                self.next += 1
            self.outstanding += 1
        q = self.prepared.pop(i, None)
        if q is None:
            q = to_port(self.stream.spec(i), self.tables)
            if self.t_end > 0.0:
                self.built_in_window += 1
        if self.on_query is not None:
            self.on_query(i, q)
        t = time.perf_counter()
        fut = self.fe.submit(q)
        fut.add_done_callback(lambda f, i=i, t=t: self._done(i, t, f))

    def _done(self, i: int, t_sub: float, fut) -> None:
        t = time.perf_counter()
        exc = fut.exception()
        with self.cv:
            self.times[i] = (t_sub, t, exc is None)
            if exc is not None:
                self.errors.append(f"query {i}: {exc!r}")
            else:
                rep = fut.result().report
                if self.keep(i):
                    self.reports[i] = rep
                if i < self.count_below:
                    self.scanned[i] = (
                        sum(len(ss) for ss in rep.scan_sets.values())
                        - (len(rep.topk.skipped) if rep.topk is not None
                           else 0))
            self.outstanding -= 1
            more = t < self.t_end
            if self.outstanding == 0:
                self.cv.notify_all()
        if more:
            if self.spans is not None:
                with self.spans.span("client.submit"):
                    self._submit()
            else:
                self._submit()

    def window(self, seconds: float, limit_s: float):
        """Run the closed loop for ``seconds``; (t_open, t_close)."""
        t0 = time.perf_counter()
        self.t_end = t0 + seconds
        for _ in range(self.n):
            self._submit()
        with self.cv:
            if not self.cv.wait_for(
                    lambda: self.outstanding == 0
                    and time.perf_counter() >= self.t_end, timeout=limit_s):
                raise RuntimeError(f"the window did not close within "
                                   f"{limit_s:.0f} s")
        t1 = max(t for _, t, _ in self.times.values())
        return t0, t1

    def finish(self, indices, limit_s: float) -> None:
        """Serve ``indices`` outside any window and wait for them all."""
        self.t_end = -1.0
        for i in indices:
            self._submit(i)
        with self.cv:
            if not self.cv.wait_for(lambda: self.outstanding == 0,
                                    timeout=limit_s):
                raise RuntimeError("queries left unanswered")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pool_size(mix: dict, seconds: float) -> int:
    """Queries planned in set-up: what ``rate_ceiling`` queries a second
    reach in the window, plus one a client."""
    return int(math.ceil(float(mix["rate_ceiling"]) * seconds)) \
        + int(mix["clients"])


def warmup_indices(stream: Stream, rounds: int) -> List[int]:
    """Each kind of the cycle ``rounds`` times: every table, plane family
    and stage the cell's traffic uses, staged and launched once."""
    first: Dict[str, int] = {}
    for i, k in enumerate(stream.cycle):
        first.setdefault(k, i)
    base = sorted(first.values())
    return [i + r * len(stream.cycle) for r in range(rounds) for i in base]


@dataclasses.dataclass
class Run:
    """What a finished run hands to the metric readers."""

    cell: Cell
    seed: int
    stream: Stream
    ref: Reference
    t0: float
    t1: float
    window: List[int]                  # stream indices served in the window
    latencies_ms: List[float]
    answers: Dict[int, dict]           # judged and prefix answers
    prefix: List[int]
    scanned: Dict[int, int]            # partitions left to scan, stream
                                       # queries below ``scanned_prefix``
    counters: dict                     # name -> (before, after)
    resident_bytes: int
    trace: Optional[object] = None     # trace.Trace in a traced run
    warmup: List[int] = dataclasses.field(default_factory=list)

    def delta(self, name: str) -> dict:
        before, after = self.counters[name]
        return {k: after[k] - before[k] for k in after
                if isinstance(after[k], (int, float))}


def counters_of(svc) -> dict:
    from repro_torch.serve.resilience import resilience_snapshot

    res = resilience_snapshot(svc.resilience)
    return {"latency": dict(svc.latency),
            "staging": svc.cache.staging_snapshot(),
            "demotions": dict(res["demotions"])}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=print) -> dict:
    """Set up, warm up, measure, check: the result line's fields."""
    import torch

    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.prune_service import PruningService

    mix = cell.mix
    raw = gen.make_tables(cell.config, seed)
    log(f"[portbench] tables made {time.perf_counter() - t_start:.3f} s "
        f"after start")
    tables = port_tables(raw)
    stream = Stream(mix, seed)
    svc = PruningService(device=device)
    log(f"[portbench] service built {time.perf_counter() - t_start:.3f} s "
        f"after start")
    fe = ServingFrontend(svc, max_batch=int(mix["clients"]),
                         deadline_s=float(mix["deadline_s"]))
    prefix_n = int(mix["verify_prefix"])
    scanned_n = int(mix["scanned_prefix"])
    rates = mix["verify_rate"]

    def keep(i: int) -> bool:
        if i < prefix_n:
            return True
        return unit_hash(seed, i) < rates.get(stream.spec_cls(i), 0.0)

    warm = Stream(mix, seed, salt=1)
    w_idx = warmup_indices(warm, int(mix.get("warmup_rounds", 1)))
    Clients(fe, warm, tables, 0, lambda i: False).finish(w_idx, 600.0)
    fe.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"[portbench] warmed up ({len(w_idx)} queries) "
        f"{time.perf_counter() - t_start:.3f} s after start")

    # the clients' queries are planned before the window, so the window
    # times the service and not the benchmark's query building: as many as
    # the mix's rate ceiling reaches in the window, and the clients.  The
    # pool only grows while it is made, so the collector, which would walk
    # it again and again, waits until it is whole.
    gc.disable()
    try:
        prepared = {i: to_port(stream.spec(i), tables)
                    for i in range(pool_size(mix, seconds))}
    finally:
        gc.enable()
    log(f"[portbench] planned {len(prepared)} queries "
        f"{time.perf_counter() - t_start:.3f} s after start")
    tracer = None
    if traced:
        from .trace import Tracer
        tracer = Tracer()
        tracer.install()
    clients = Clients(fe, stream, tables, int(mix["clients"]), keep,
                      on_query=tracer.on_query if tracer else None,
                      spans=tracer.spans if tracer else None,
                      prepared=prepared)
    clients.count_below = scanned_n
    before = counters_of(svc)
    if tracer is not None:
        tracer.start()
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] set-up {setup_s:.3f} s; window of {seconds} s opens")
    try:
        # a minute past the close for the batch in flight: a window that
        # never closes has lost a thread of the service
        t0, t1 = clients.window(seconds, limit_s=seconds + 60.0)
    except BaseException:
        if tracer is not None:
            tracer.abort()
            tracer.uninstall()
        raise
    if tracer is not None:
        # the trace ends with the service idle: the worker has left its
        # last batch, not only answered it
        fe.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if tracer is not None:
        tracer.stop()
        tracer.trace.t_open, tracer.trace.t_close = t0, t1
    after = counters_of(svc)
    resident = svc.cache.resident_bytes
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window = sorted(clients.times)
    latencies = [(clients.times[i][1] - clients.times[i][0]) * 1e3
                 for i in window]
    failed = sum(1 for i in window if not clients.times[i][2])
    log(f"[portbench] window {t1 - t0:.3f} s, {len(window)} queries, "
        f"{len(window) / (t1 - t0):.3f} queries/s")
    buckets = np.bincount([int((clients.times[i][1] - t0) // 5.0)
                           for i in window])
    log(f"[portbench] answers a 5 s of the window: {buckets.tolist()}")
    if clients.built_in_window:
        log(f"[portbench] the pool of {pool_size(mix, seconds)} planned "
            f"queries ran dry: {clients.built_in_window} were "
            f"built inside the window (the mix's rate_ceiling is too low)")
    missing = [i for i in range(max(prefix_n, scanned_n))
               if i not in clients.times]
    if missing:
        clients.finish(missing, 600.0)
    fe.close()
    if tracer is not None:
        tracer.uninstall()
    answers = {i: plain_answer(r) for i, r in clients.reports.items()}
    del clients.reports, fe, svc
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(raw, cell.config)
    t_ref = time.perf_counter()
    checks = {c: 0 for c in CHECKS}
    judged = sorted(set(answers) | set(range(prefix_n)))
    for i in judged:
        for c in judge(ref, stream.spec(i), answers.get(i)):
            checks[c] += 1
    checks["unanswered"] += len(clients.errors)
    log(f"[portbench] judged {len(judged)} answers in "
        f"{time.perf_counter() - t_ref:.3f} s")
    run = Run(cell, seed, stream, ref, t0, t1, window, latencies, answers,
              list(range(prefix_n)), dict(clients.scanned),
              {k: (before[k], after[k])
                                      for k in before}, resident,
              tracer.trace if tracer else None, w_idx)
    return dict(run=run, setup_s=setup_s, checks=checks, judged=len(judged),
                attempted=len(window), failed=failed, peak=peak,
                errors=clients.errors[:5])


def scanned_pct(run: Run) -> Optional[float]:
    """Partitions left to scan (kept, less those the top-k boundary
    skipped) over the partitions the stream's first ``scanned_prefix``
    queries touch."""
    n = int(run.cell.mix["scanned_prefix"])
    if any(i not in run.scanned for i in range(n)):
        return None
    touched = sum(run.ref.stats(table).num_partitions
                  for i in range(n)
                  for table, _c in run.stream.spec(i).scans.values())
    return 100.0 * sum(run.scanned[i] for i in range(n)) / touched


def breakdown(trace) -> dict:
    """The ten device operations that took most time, and idle time by the
    benchmark span open on the host while the card waited."""
    by_op: Dict[str, float] = {}
    for o in trace.ops:
        if trace.t_open <= o.t0 <= trace.t_close:
            by_op[o.name] = by_op.get(o.name, 0.0) + (o.t1 - o.t0)
    busy = trace.busy_intervals()
    edges = [trace.t_open] + [t for iv in busy for t in iv] + [trace.t_close]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    labels = trace.labels_at(np.array([(a + b) / 2.0 for a, b in gaps]))
    by_label: Dict[str, float] = {}
    for (a, b), lab in zip(gaps, labels):
        by_label[lab] = by_label.get(lab, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_label)}
