"""The port's spans: one tracer shared by every layer, from the serving
front-end down to the kernel launches.

A span is a named interval of host time on ``time.perf_counter``, with a
span id, the id of the span it opened inside (its parent, from a
thread-local stack; 0 at the top), the thread, and attributes (counts,
a query's ``rid``).  ``span(name, **attrs)`` opens one as a context
manager; ``set(**attrs)`` adds attributes before it closes.

Tracing is on while a ``torch.profiler`` session records, in any thread
of the process (``torch.autograd.profiler._is_profiler_enabled``: the
profiler's own probe, ``torch._C._autograd._profiler_enabled()``, is per
thread, and the front-end runs its batches on a worker thread), or after
``enable()`` (operators and tests).  Off, ``span`` returns one shared
no-op object: a call costs two flag reads, and the no-op is falsy, so a
site that computes attributes guards them with ``if sp:``.

The one exporter is ``torch.profiler.record_function(name)``: on the
thread that started the profiler (the only thread a default session
records) every span also enters it, so the trace shows the program's
spans beside the kernels.  The front-end's worker is another thread; an
operator who profiles every thread (the profiler's
``profile_all_threads``) calls ``mirror_all_threads()`` to mirror the
spans of every thread.  A mirror costs the traced stages time, so it is
off by default where no default trace would show it.

Closed spans go into a bounded module-level ring (``RING`` spans); when
it is full the oldest span is dropped and counted (``dropped``).
``records()`` copies what is kept, ``clear()`` empties it.  The ring
outlives the objects that recorded into it, so a reader finds the spans
after the service is gone.

A query's ``rid`` is inherited: a span opened without one takes the
``rid`` of the nearest enclosing frame that has one, and ``query(rid)``
pushes a frame that carries a ``rid`` without recording a span of its
own, for code that calls functions which do not know the query.  No
span is opened inside a loop over partitions or rows: such loops count
into local ints that go on the enclosing span.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, List, NamedTuple

import torch
# its ``_is_profiler_enabled``: set for the whole process while a session
# records
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 18

_here = torch._C._autograd._profiler_enabled   # this thread is recorded
_enabled = False
_mirror_all = False
_local = threading.local()
_lock = threading.Lock()
# closed spans as flat tuples, Span's first six fields and then each
# attribute's key and value: a tuple of atoms (and tuples of atoms), which
# the garbage collector stops tracking at its first pass (it untracks
# exact tuples only, and never one that holds a dict).  Spans kept as
# objects would be swept by every full collection and bring the next one
# sooner, and the traced stages would pay for both.
_ring: Deque[tuple] = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_dropped = 0
_dropped_t1 = float("-inf")


class Span(NamedTuple):
    """A closed span, as ``records()`` hands it out."""

    name: str
    sid: int
    parent: int
    thread: int
    t0: float
    t1: float
    attrs: dict


class _Noop:
    """The shared span of tracing off: enters, exits and sets nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


def on() -> bool:
    """Whether spans are recorded now."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def enable(flag: bool = True) -> None:
    """Record spans without a profiler session (or stop, with False)."""
    global _enabled
    _enabled = bool(flag)


def mirror_all_threads(flag: bool = True) -> None:
    """Mirror the spans of every thread into ``record_function``, not only
    the profiler's own thread's: for a session that records every thread
    (or stop, with False)."""
    global _mirror_all
    _mirror_all = bool(flag)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def lookup(key: str):
    """The value of attribute ``key`` on the nearest enclosing frame of
    this thread that has it, or None."""
    for fr in reversed(_stack()):
        if key in fr.attrs:
            return fr.attrs[key]
    return None


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "sid", "parent", "t0", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].sid if st else 0
        if "rid" not in self.attrs:
            rid = lookup("rid")
            if rid is not None:
                self.attrs["rid"] = rid
        self.sid = next(_ids)
        st.append(self)
        self._rf = None
        if _mirror_all or _here():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _keep((self.name, self.sid, self.parent, threading.get_ident(),
               self.t0, t1, *itertools.chain.from_iterable(
                   self.attrs.items())))
        return False


class _Query:
    """A frame that gives the spans opened inside it a ``rid``."""

    __slots__ = ("attrs", "sid")

    def __init__(self, rid):
        self.attrs = {"rid": rid}

    def __enter__(self):
        st = _stack()
        self.sid = st[-1].sid if st else 0
        st.append(self)
        return self

    def __exit__(self, *exc):
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        return False


def span(name: str, **attrs):
    """A span named ``name`` (a context manager), or the shared no-op when
    tracing is off."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return NOOP
    return _Open(name, attrs)


def query(rid):
    """Spans opened inside belong to query ``rid`` (no span of its own)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return NOOP
    return _Query(rid)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Keep a span whose times were taken elsewhere (``perf_counter``
    seconds), as a child of the span open on this thread."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    st = _stack()
    _keep((name, next(_ids), st[-1].sid if st else 0, threading.get_ident(),
           t0, t1, *itertools.chain.from_iterable(attrs.items())))


def _keep(s: tuple) -> None:
    global _dropped, _dropped_t1
    with _lock:
        if len(_ring) == RING:
            _dropped += 1
            _dropped_t1 = max(_dropped_t1, _ring[0][5])
        _ring.append(s)


def records() -> List[Span]:
    """The spans kept so far, oldest first (a copy)."""
    with _lock:
        return [Span(*s[:6], dict(zip(s[6::2], s[7::2]))) for s in _ring]


def dropped() -> int:
    """How many spans the full ring has dropped since the last clear."""
    return _dropped


def dropped_through() -> float:
    """The latest end time of a dropped span (-inf when none was)."""
    return _dropped_t1


def clear() -> None:
    """Empty the ring and reset the count of dropped spans."""
    global _dropped, _dropped_t1
    with _lock:
        _ring.clear()
        _dropped = 0
        _dropped_t1 = float("-inf")


def self_seconds(spans: List[Span]) -> dict:
    """Each span's duration less what its child spans among ``spans``
    cover of it (a child ``record``ed from earlier times covers only its
    overlap), by span id."""
    by_id = {s.sid: s for s in spans}
    child: dict = collections.defaultdict(float)
    for s in spans:
        p = by_id.get(s.parent)
        if p is not None:
            child[p.sid] += max(0.0, min(s.t1, p.t1) - max(s.t0, p.t0))
    return {s.sid: (s.t1 - s.t0) - child[s.sid] for s in spans}
