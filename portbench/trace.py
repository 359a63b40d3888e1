"""The traced run: the benchmark's own spans around the calls into each layer,
and the card's activity from ``torch.profiler``.

Spans are recorded in the benchmark's files, by wrappers installed over
the program's methods for the traced run alone and taken off after it:

  frontend.dispatch    ``ServingFrontend._execute`` (a batch, answers handed
                       back, the clients' next queries planned)
  frontend.prestage    ``PruningService.prestage`` (the batcher thread)
  service.run_batch    ``PruningService.run_batch``
  stage.<technique>    each ``Technique.run_batch`` of ``core/flow.py``
  stage.join.distinct  ``PruningService.join_hit_batch``
  stage.join.bloom     ``PruningService.bloom_hit_batch``
  stage.topk.init      ``PruningService.topk_init_batch``
  client.submit        a client planning and submitting its next query

The profiler's clock is tied to ``time.perf_counter`` by one marker
(``record_function``) whose host time is read around it, so device
activity and spans share one time line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Span:
    label: str
    thread: int
    t0: float
    t1: float
    payload: object = None


class Spans:
    def __init__(self):
        self.records: List[Span] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, label: str, payload=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = Span(label, threading.get_ident(), t0, time.perf_counter(),
                     payload)
            with self._lock:
                self.records.append(s)


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str            # kernel | gpu_memcpy | gpu_memset
    t0: float           # perf_counter seconds
    t1: float
    nbytes: int = 0


@dataclasses.dataclass
class Trace:
    spans: List[Span]
    ops: List[DeviceOp]
    t_open: float = 0.0
    t_close: float = 0.0

    def spans_of(self, label: str) -> List[Span]:
        return [s for s in self.spans if s.label == label
                and self.t_open <= s.t0 <= self.t_close]

    def kernels_in(self, spans: List[Span]) -> List[Tuple[Span, float]]:
        """(span, device seconds of the kernels that started inside it)."""
        ks = sorted((o.t0, o.t1 - o.t0) for o in self.ops
                    if o.cat == "kernel")
        starts = np.array([k[0] for k in ks])
        cum = np.concatenate([[0.0], np.cumsum([k[1] for k in ks])])
        out = []
        for s in spans:
            a = np.searchsorted(starts, s.t0, side="left")
            b = np.searchsorted(starts, s.t1, side="right")
            out.append((s, float(cum[b] - cum[a])))
        return out

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the window."""
        iv = sorted((max(o.t0, self.t_open), min(o.t1, self.t_close))
                    for o in self.ops if o.t1 > self.t_open
                    and o.t0 < self.t_close)
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def labels_at(self, times: np.ndarray) -> List[str]:
        """The innermost benchmark span open at each host time (the one
        that opened last), or ``frontend.wait`` where none is."""
        if not self.spans:
            return ["frontend.wait"] * len(times)
        t0 = np.array([s.t0 for s in self.spans])
        t1 = np.array([s.t1 for s in self.spans])
        out = []
        for t in times:
            open_ = (t0 <= t) & (t1 >= t)
            if not open_.any():
                out.append("frontend.wait")
            else:
                out.append(self.spans[int(np.argmax(
                    np.where(open_, t0, -np.inf)))].label)
        return out


class Tracer:
    """Installs the span wrappers and drives the profiler for one window."""

    def __init__(self):
        self.spans = Spans()
        # id of a query -> its stream index.  The query itself is not held:
        # the window's queries are freed once answered, as in an untraced
        # run, so the traced window's heap and its collections do not
        # grow with every query served.  A later query that reuses a freed
        # query's id overwrites its entry before it can be looked up.
        self.index_of: Dict[int, int] = {}
        self.summary_of: Dict[int, int] = {}
        self._undo: List[Tuple[object, str, object]] = []
        self._prof = None
        self._marks: Dict[str, float] = {}
        self.trace: Optional[Trace] = None

    def on_query(self, i: int, q) -> None:
        self.index_of[id(q)] = i

    def _idx(self, q) -> int:
        return self.index_of.get(id(q), -1)

    def _wrap(self, owner, attr: str, label: str, payload=None) -> None:
        orig = getattr(owner, attr)
        spans = self.spans

        def wrapper(*a, **kw):
            with spans.span(label, payload(*a, **kw) if payload else None):
                return orig(*a, **kw)

        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, wrapper)

    def install(self) -> None:
        from repro_torch.core import flow
        from repro_torch.serve.frontend import ServingFrontend
        from repro_torch.serve.prune_service import PruningService

        def states_payload(_self, _pipe, states, *a, **kw):
            return [self._idx(st.query) for st in states]

        def topk_payload(_self, _pipe, states, *a, **kw):
            # the ScanSet each top-k query hands the boundary init
            return {id(st.scan_sets.get(st.query.order_by[0])):
                    self._idx(st.query) for st in states
                    if st.query.order_by is not None}

        def summaries_payload(_self, _table, _col, summaries, *a, **kw):
            return [self.summary_of.get(id(s), -1) for s in summaries]

        def init_payload(_self, _table, _col, _desc, items, *a, **kw):
            return [id(ss) for ss, _k in items]

        self._wrap(ServingFrontend, "_execute", "frontend.dispatch")
        self._wrap(PruningService, "prestage", "frontend.prestage")
        self._wrap(PruningService, "run_batch", "service.run_batch")
        self._wrap(flow.FilterTechnique, "run_batch", "stage.filter",
                   states_payload)
        self._wrap(flow.LimitTechnique, "run_batch", "stage.limit")
        self._wrap(flow.JoinTechnique, "run_batch", "stage.join",
                   states_payload)
        self._wrap(flow.TopKTechnique, "run_batch", "stage.topk",
                   topk_payload)
        self._wrap(PruningService, "join_hit_batch", "stage.join.distinct",
                   summaries_payload)
        self._wrap(PruningService, "bloom_hit_batch", "stage.join.bloom",
                   summaries_payload)
        self._wrap(PruningService, "topk_init_batch", "stage.topk.init",
                   init_payload)
        orig = flow.JoinTechnique._summarize

        def summarize(_self, pipe, state):
            s = orig(_self, pipe, state)
            if s is not None:
                self.summary_of[id(s)] = self._idx(state.query)
            return s

        self._undo.append((flow.JoinTechnique, "_summarize",
                           flow.JoinTechnique.__dict__.get("_summarize")))
        flow.JoinTechnique._summarize = summarize

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, attr)       # the method was inherited
            else:
                setattr(owner, attr, orig)
        self._undo = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._mark("portbench.open")

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function

        a = time.perf_counter()
        with record_function(name):
            pass
        b = time.perf_counter()
        self._marks[name] = (a + b) / 2.0

    def abort(self) -> None:
        """Stop the profiler of a run that failed in its window, reading
        nothing: the process then ends with its error, not with a
        profiler still running while the interpreter tears down."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()

    def stop(self) -> None:
        self._mark("portbench.close")
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        self.trace = parse(events, self._marks, self.spans.records)


def parse(events: list, marks: Dict[str, float], spans: List[Span]) -> Trace:
    """Device operations of a chrome trace on the perf_counter time line."""
    anchor = None
    for e in events:
        if e.get("name") == "portbench.open" and e.get("ph") == "X":
            mid_us = float(e["ts"]) + float(e.get("dur", 0.0)) / 2.0
            anchor = mid_us / 1e6 - marks["portbench.open"]
            break
    if anchor is None:
        raise RuntimeError("the profiler's trace holds no alignment marker")
    ops = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        t0 = float(e["ts"]) / 1e6 - anchor
        args = e.get("args", {}) or {}
        ops.append(DeviceOp(e.get("name", "?"), cat, t0,
                            t0 + float(e.get("dur", 0.0)) / 1e6,
                            int(args.get("bytes", 0) or 0)))
    return Trace(list(spans), ops)
