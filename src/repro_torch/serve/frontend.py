"""Async serving front-end: admission, micro-batching, latency SLOs.

The batched engine (``PruningService.run_batch``) answers a *batch* of
queries per call; production traffic arrives one query at a time.  This
module is the admission layer between the two — the continuous-batching
shape of LLM serving systems applied to the pruning service:

  * ``submit(query) -> Future`` enqueues one query and returns
    immediately; the caller blocks on the future only when it needs the
    answer.
  * A micro-batcher accumulates pending submissions until **either** a
    deadline fires (``deadline_s`` since the oldest pending submission —
    the latency bound) **or** a size cap fills (``max_batch`` — the
    throughput bound), then dispatches the batch through the existing
    ``run_batch`` degradation ladder on a worker.  Results are therefore
    bit-identical to calling ``run_batch`` directly on the same queries:
    the front-end adds scheduling, never semantics.
  * **Plane staging ahead of the launch:** while the worker drives batch
    N's launches, the batcher thread prestages batch N+1's plane deltas
    through ``PruningService.prestage`` — ``pin_scope`` threaded around
    the prefetches so the ``PlaneMemoryManager`` can never evict a plane
    an in-flight launch is reading (pins are global refcounts; the
    launch scope's own pins are taken on the worker thread).  A delta
    replay writes a clone of the resident planes and swaps it in, so a
    launch the worker already started keeps reading the planes it got,
    whole (``core.device_stats``).  Both threads enter one CUDA stream
    (the stream current where the front-end was built), so the card
    also runs a replay's copies in order with the launches.  The overlap
    is the host work of staging (the host slices, casts and stamps) with
    the worker's host stages and launches, not two streams on the card.
  * Every response carries queue/stage/launch timestamps, and a
    ``counters["latency"]`` block (keys registered in
    ``COUNTER_REGISTRY``) accumulates per-batch p50/p99/max and
    saturation (queue-depth peak, deadline- vs size-fired dispatches),
    surfaced service-lifetime through ``fleet_summary()["latency"]``.

Clock injection: pass ``clock`` and ``threaded=False`` and the front-end
becomes a deterministic state machine — ``submit`` dispatches inline when
the size cap fills, ``poll()`` dispatches when the injected clock passes
the deadline, ``flush()`` forces the rest — so tests never sleep and
never race.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import tracing

# Latency sample window for the running p50/p99 (lifetime max is exact).
# Bounded so a long-lived service never grows host memory with traffic.
LATENCY_WINDOW = 4096


@dataclasses.dataclass
class FrontendResponse:
    """One query's answer plus its life-cycle timing.

    ``timestamps`` (clock units: ``time.perf_counter`` seconds unless a
    clock was injected, so they share the tracer's time line):
      queued      submit() admitted the query
      staged      its planes were prestaged (None: no prefetch overlap)
      dispatched  the micro-batch closed (deadline/size/flush fired)
      launched    the worker entered run_batch
      done        run_batch returned
    """

    rid: int
    report: object                 # core.flow.PruningReport
    cause: str                     # "deadline" | "size" | "flush"
    timestamps: Dict[str, Optional[float]]
    queue_ms: float                # queued -> dispatched
    latency_ms: float              # queued -> done (end to end)
    queue_depth: int               # pending depth observed at submit


@dataclasses.dataclass
class _Submission:
    query: object
    future: Future
    rid: int
    t_submit: float
    queue_depth: int
    staged: bool = False
    t_staged: Optional[float] = None


@dataclasses.dataclass
class _Batch:
    subs: List[_Submission]
    cause: str
    t_close: float


class ServingFrontend:
    """Async admission layer over a ``PruningService``.

    Parameters:
      service     the PruningService every batch dispatches through
      pipeline    forwarded to ``run_batch`` (None: the service builds
                  its own device pipeline — the synchronous default)
      max_batch   size cap Q: a batch dispatches the moment Q queries
                  are pending
      deadline_s  micro-batch deadline T: a batch dispatches at most T
                  after its oldest query was admitted
      clock       injectable monotonic clock (tests pin it; production
                  uses ``time.perf_counter``, the spans' clock); it
                  schedules, stamps and times the ``frontend.queue``
                  spans (the other spans read ``time.perf_counter``)
      threaded    True: a batcher thread (deadline timing + prestaging)
                  and a worker thread (dispatch) run the loop; False:
                  deterministic inline mode driven by ``submit`` /
                  ``poll`` / ``flush`` under the injected clock
      prefetch    overlap batch N+1's plane staging with batch N's
                  launches (inline mode prestages right before dispatch,
                  which still warms the planes but without overlap)

    Both threads enter the CUDA stream that was current on the service's
    device when the front-end was built (on the CPU there is none).
    """

    def __init__(self, service, pipeline=None, max_batch: int = 8,
                 deadline_s: float = 0.005, clock=None,
                 threaded: bool = True, prefetch: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        self.service = service
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.clock = clock if clock is not None else time.perf_counter
        self.threaded = bool(threaded)
        self.prefetch = bool(prefetch)
        dev = getattr(service, "device", None)
        # the one stream of both prestage and launches (see the module's
        # staging note)
        self.stream = (torch.cuda.current_stream(dev)
                       if dev is not None and dev.type == "cuda" else None)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List[_Submission] = []       # guarded by _cv
        self._batches: "collections.deque[_Batch]" = collections.deque()
        self._inflight = 0                          # batches in _execute
        self._closed = False
        self._flush_requested = False
        self._batcher_done = not self.threaded
        self._rid = 0
        self._samples: "collections.deque[float]" = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._threads: List[threading.Thread] = []
        if self.threaded:
            for name, target in (("frontend-batcher", self._batch_loop),
                                 ("frontend-worker", self._work_loop)):
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads.append(t)

    # -- API ----------------------------------------------------------------

    def submit(self, query) -> Future:
        """Admit one query; resolves to a ``FrontendResponse``."""
        inline: Optional[_Batch] = None
        with self._cv:
            if self._closed:
                raise RuntimeError("frontend is closed")
            sub = _Submission(query, Future(), self._rid, self.clock(),
                              len(self._pending) + 1)
            self._rid += 1
            self._pending.append(sub)
            lat = self.service.latency
            lat["requests"] += 1
            lat["queue_depth_peak"] = max(lat["queue_depth_peak"],
                                          len(self._pending))
            if len(self._pending) >= self.max_batch:
                if self.threaded:
                    self._cv.notify_all()   # batcher closes + dispatches
                else:
                    inline = self._close_locked("size")
            else:
                self._cv.notify_all()       # (re)arm the deadline wait
        if inline is not None:
            self._execute(inline)
        return sub.future

    def poll(self) -> Optional[str]:
        """Inline mode's clock edge: dispatch if the deadline (per the
        injected clock) has passed; returns the firing cause or None.
        Threaded mode never needs it (the batcher thread owns timing)."""
        if self.threaded:
            return None
        with self._cv:
            cause = self._due_locked()
            batch = self._close_locked(cause) if cause else None
        if batch is None:
            return None
        self._execute(batch)
        return batch.cause

    def flush(self) -> int:
        """Force-dispatch everything pending; returns how many queries
        were flushed (0 when nothing was pending)."""
        if not self.threaded:
            with self._cv:
                batches = []
                while self._pending:
                    batches.append(self._close_locked("flush"))
            for b in batches:
                self._execute(b)
            return sum(len(b.subs) for b in batches)
        with self._cv:
            n = len(self._pending)
            self._flush_requested = True
            self._cv.notify_all()
        return n

    def drain(self) -> None:
        """Block until every admitted query has resolved (flushes any
        partial batch rather than waiting out its deadline)."""
        self.flush()
        if not self.threaded:
            return
        with self._cv:
            self._cv.wait_for(lambda: not self._pending
                              and not self._batches and self._inflight == 0)

    def close(self) -> None:
        """Flush, drain, and stop the threads.  Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self.threaded:
            for t in self._threads:
                t.join()
            self._threads = []
        else:
            with self._cv:
                batches = []
                while self._pending:
                    batches.append(self._close_locked("flush"))
            for b in batches:
                self._execute(b)

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _on_stream(self):
        """Enter the front-end's CUDA stream (no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- scheduling ---------------------------------------------------------

    def _due_locked(self) -> Optional[str]:
        """What (if anything) should close the current micro-batch now.
        Size beats flush beats deadline: a full batch is dispatched as
        such even when a flush/close raced with the last submit."""
        if not self._pending:
            return None
        if len(self._pending) >= self.max_batch:
            return "size"
        if self._closed or self._flush_requested:
            return "flush"
        if self.clock() - self._pending[0].t_submit >= self.deadline_s:
            return "deadline"
        return None

    def _close_locked(self, cause: str) -> _Batch:
        subs, self._pending = (self._pending[:self.max_batch],
                               self._pending[self.max_batch:])
        if not self._pending:
            self._flush_requested = False
        return _Batch(subs, cause, self.clock())

    def _batch_loop(self) -> None:
        """Batcher thread: owns deadline timing, closes batches, and —
        while the worker runs batch N — prestages the pending (batch
        N+1) submissions' planes outside the condition lock.  This is
        the double-buffer overlap: staging happens on this thread while
        the worker's launches are in flight, and the launch-side
        ``pin_scope`` refcounts keep in-flight planes unevictable."""
        try:
            while True:
                unstaged: List[_Submission] = []
                with self._cv:
                    while True:
                        cause = self._due_locked()
                        if cause is not None:
                            self._batches.append(self._close_locked(cause))
                            self._cv.notify_all()
                            continue
                        if self._closed and not self._pending:
                            return
                        if self.prefetch:
                            unstaged = [s for s in self._pending
                                        if not s.staged]
                            if unstaged:
                                break       # go stage outside the lock
                        timeout = None
                        if self._pending:
                            timeout = max(
                                0.0, self._pending[0].t_submit
                                + self.deadline_s - self.clock())
                        self._cv.wait(timeout)
                # Off-lock staging: getters inside prestage take the
                # cache's own lock; holding our condition lock here
                # would serialize staging against submit/dispatch.
                with self._on_stream():
                    self.service.prestage([s.query for s in unstaged])
                now = self.clock()
                with self._cv:
                    for s in unstaged:
                        s.staged = True
                        s.t_staged = now
        finally:
            with self._cv:
                self._batcher_done = True
                self._cv.notify_all()

    def _work_loop(self) -> None:
        """Worker thread: dispatch closed batches through run_batch."""
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._batches or self._batcher_done)
                if not self._batches:
                    if self._batcher_done:
                        return
                    continue
                batch = self._batches.popleft()
                self._inflight += 1
            try:
                self._execute(batch)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    # -- dispatch -----------------------------------------------------------

    def _execute(self, batch: _Batch) -> None:
        """Dispatch one micro-batch through the service's ladder.

        Registered in ``LADDER_LAUNCH_SITES``: every kernel
        launch below this frame goes through ``run_batch``, whose stages
        execute exclusively via the service's registered rung builders.
        Resolves every submission's future — with a ``FrontendResponse``
        on success, with the exception if the dispatch itself failed
        (run_batch's own contract makes that an engine bug, not a
        query-shaped problem).
        """
        sp = tracing.span("frontend.batch")
        with sp:
            if sp:
                sp.set(rids=tuple(s.rid for s in batch.subs))
            self._dispatch(batch, sp)

    def _dispatch(self, batch: _Batch, sp) -> None:
        """``_execute``'s body, inside its ``frontend.batch`` span."""
        with self._on_stream():
            if self.prefetch and not self.threaded:
                # Inline mode has no staging thread: prestage right
                # before the launch so the getters hit resident planes.
                self.service.prestage(
                    [s.query for s in batch.subs if not s.staged])
                now = self.clock()
                for s in batch.subs:
                    if not s.staged:
                        s.staged = True
                        s.t_staged = now
            t_launch = self.clock()
            if sp:
                # each query's wait, from submit until run_batch starts
                for s in batch.subs:
                    tracing.record("frontend.queue", s.t_submit, t_launch,
                                   rid=s.rid)
            try:
                reports = self.service.run_batch(
                    [s.query for s in batch.subs], self.pipeline)
            except BaseException as exc:  # noqa: BLE001 — futures resolve
                for s in batch.subs:
                    s.future.set_exception(exc)
                raise
        t_done = self.clock()
        lat_ms: List[float] = []
        responses: List[FrontendResponse] = []
        for s, rep in zip(batch.subs, reports):
            ms = (t_done - s.t_submit) * 1e3
            lat_ms.append(ms)
            responses.append(FrontendResponse(
                rid=s.rid, report=rep, cause=batch.cause,
                timestamps=dict(queued=s.t_submit, staged=s.t_staged,
                                dispatched=batch.t_close, launched=t_launch,
                                done=t_done),
                queue_ms=(batch.t_close - s.t_submit) * 1e3,
                latency_ms=ms, queue_depth=s.queue_depth))
        block = self._account(batch, lat_ms)
        for rep in reports:
            # run_batch gave each report its own counters copy; the
            # batch's latency block joins the other per-batch sections
            rep.counters["latency"] = dict(block)
        for s, resp in zip(batch.subs, responses):
            s.future.set_result(resp)

    def _account(self, batch: _Batch, lat_ms: Sequence[float]) -> dict:
        """Fold one batch into the service-lifetime latency block and
        return the per-batch ``counters["latency"]`` section (every key
        declared in ``COUNTER_REGISTRY``)."""
        p50, p99 = np.percentile(np.asarray(lat_ms), (50.0, 99.0))
        staged = sum(1 for s in batch.subs if s.t_staged is not None)
        block = dict(requests=len(batch.subs), batches=1,
                     deadline_fired=0, size_fired=0, flush_fired=0,
                     queue_depth_peak=max(s.queue_depth for s in batch.subs),
                     prefetches=staged,
                     p50_ms=float(p50), p99_ms=float(p99),
                     max_ms=float(max(lat_ms)))
        block[batch.cause + "_fired"] = 1
        with self._lock:
            lat = self.service.latency
            lat["batches"] += 1
            lat[batch.cause + "_fired"] += 1
            lat["prefetches"] += staged
            self._samples.extend(lat_ms)
            window = np.asarray(self._samples)
            w50, w99 = np.percentile(window, (50.0, 99.0))
            lat["p50_ms"] = float(w50)
            lat["p99_ms"] = float(w99)
            lat["max_ms"] = max(lat["max_ms"], float(max(lat_ms)))
        return block
