"""Resilience layer: fail prune-less, never wrong, never crash the caller.

Pruning has a property the rest of the stack lacks: a *safe degraded
answer always exists*.  Keeping a partition is always correct (the scan
just reads more), and every cheaper prover — host
kernel, f64 host oracle, finally "keep everything" — only ever
over-approximates the kept set (the same safety argument Extensible Data
Skipping makes for its indexes: skipping metadata may only
over-approximate).  This module turns that property into machinery:

  * ``DegradationLadder`` executes a per-table batched launch through an
    ordered fallback chain (``RUNGS``): device kernel -> host kernel
    fallback (``kernels/ops.py``) -> host oracle technique -> no-prune
    passthrough.  Each rung gets a
    bounded number of retries with deterministic exponential backoff
    (injectable clock/sleep so tests never really sleep) and a per-stage
    deadline; every demotion is recorded in the service's
    ``counters["resilience"]`` block.
  * ``BackoffPolicy`` is the retry-delay schedule: exponential with a
    cap and seeded deterministic jitter.
  * ``FaultInjector`` is the chaos seam threaded through staging,
    eviction, getter, and kernel-launch call sites (``fire``/``corrupt``).
    It is **off by default**: every call site guards with
    ``if injector is not None``, so the disabled path costs one attribute
    load — no schedule lookups, no rng draws.

Counters contract (attached per batch as ``counters["resilience"]``):

    retries         failed attempts that were retried on the same rung
    deadline_hits   rung abandonments forced by the per-stage deadline
    passthroughs    launches that degraded all the way to no-prune
    errors          malformed query specs isolated to a passthrough
    salvaged_batches  whole-batch guard trips (per-query host salvage)
    demotions       {rung: times the ladder demoted INTO that rung}

The device rung's kernel is the hand-written CUDA kernel on a GPU.  A
``KernelError`` (the kernel failed to build, was handed inputs it does not
take, or failed to launch) is never demoted: ``execute`` re-raises it, so
a broken kernel cannot hide behind a host rung.  Injected faults, torn
planes and deadlines still demote, and ``counters["resilience"]`` is
where a run sees them.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.device_stats import PlaneIntegrityError  # noqa: F401  re-export
from ..core.device_stats import to_host
from ..kernels.build import KernelError

# The ordered fallback chain.  A launch enters at the top rung and only
# ever moves down; the bottom rung keeps every live partition as PARTIAL
# — a superset of any correct answer, never FULL (so LIMIT cannot trust
# uncertified rows).
RUNGS = ("device", "host_kernel", "host_oracle", "passthrough")

# Single registry of every counter key the serving layer may write —
# dict keys of the resilience / integrity counter stores, report-section
# names assembled by PruningService.run_batch, and the per-technique
# attribution families passed to ServiceCounters.bump(), so a new counter
# cannot ship in a shape fleet_summary() silently drops.
COUNTER_REGISTRY = frozenset({
    # resilience counters (new_resilience_counters / DegradationLadder)
    "retries", "deadline_hits", "passthroughs", "errors",
    "salvaged_batches", "demotions",
    # plane-integrity counters (core.device_stats.DeviceStatsCache)
    "verifications", "checksum_failures", "quarantines",
    # per-technique attribution (ServiceCounters.bump / .technique)
    "filter", "launches", "fallbacks",
    # report sections attached to each batch (PruningService.run_batch)
    "technique", "staging", "memory", "resilience", "integrity", "planes",
})


def new_resilience_counters() -> dict:
    return dict(retries=0, deadline_hits=0, passthroughs=0, errors=0,
                salvaged_batches=0,
                demotions={r: 0 for r in RUNGS[1:]})


def resilience_snapshot(c: dict) -> dict:
    out = {k: v for k, v in c.items() if k != "demotions"}
    out["demotions"] = dict(c["demotions"])
    return out


def resilience_delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in after if k != "demotions"}
    out["demotions"] = {r: after["demotions"][r] - before["demotions"].get(r, 0)
                        for r in after["demotions"]}
    return out


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Deterministic exponential backoff: delay(i) = base * mult**i,
    capped at ``max_delay``; ``jitter`` adds a seeded-rng fraction of the
    delay (deterministic under a fixed ladder seed).  ``retries`` is the
    number of *re*-attempts per rung (0 = one attempt, no retry)."""

    retries: int = 1
    base_delay: float = 0.001
    multiplier: float = 2.0
    max_delay: float = 0.25
    jitter: float = 0.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * rng.random()
        return min(d, self.max_delay)


class FaultInjector:
    """Seeded, scheduled fault injection at named call sites.

    Rules are registered with ``add(site, ...)`` and match a fired site
    by exact name or prefix (``"launch.filter"`` matches
    ``"launch.filter:device"``).  Sites follow the convention
    ``stage.<family>`` / ``get.<family>`` / ``evict`` /
    ``launch.<technique>:<rung>``.

    Kinds:
      * ``error``   — ``fire(site)`` raises ``exc`` (default
        ``InjectedFault``);
      * ``delay``   — ``fire(site)`` calls the injector's ``sleep``
        (injectable; pair with a fake clock so suites never really
        sleep);
      * ``corrupt`` — ``corrupt(site, arrays)`` flips one element per
        array (a torn plane), leaving the stamped checksum stale so the
        integrity verifier must catch it.

    Scheduling per rule: skip the first ``after`` matching firings, then
    fire for ``times`` firings (None = forever), each gated by ``prob``
    under the injector's seeded rng — a fixed seed replays the same
    schedule.  ``log`` records every firing as ``(site, kind)``.
    """

    def __init__(self, seed: int = 0, sleep: Callable[[float], None] = None):
        self._rules: list = []
        self._rng = random.Random(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self.log: list = []

    def add(self, site: str, kind: str = "error", prob: float = 1.0,
            times: Optional[int] = None, after: int = 0,
            delay: float = 0.0, exc: Optional[BaseException] = None
            ) -> "FaultInjector":
        if kind not in ("error", "delay", "corrupt"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self._rules.append(dict(site=site, kind=kind, prob=prob, times=times,
                                after=after, delay=delay, exc=exc, seen=0,
                                fired=0))
        return self

    def _match(self, site: str, kinds: Tuple[str, ...]):
        for r in self._rules:
            if r["kind"] not in kinds:
                continue
            if not (site == r["site"] or site.startswith(r["site"])):
                continue
            r["seen"] += 1
            if r["seen"] <= r["after"]:
                continue
            if r["times"] is not None and r["fired"] >= r["times"]:
                continue
            if r["prob"] < 1.0 and self._rng.random() >= r["prob"]:
                continue
            r["fired"] += 1
            return r
        return None

    def fire(self, site: str) -> None:
        """Raise / delay if a rule matches this site (error+delay kinds)."""
        r = self._match(site, ("error", "delay"))
        if r is None:
            return
        self.log.append((site, r["kind"]))
        if r["kind"] == "delay":
            self._sleep(r["delay"])
            return
        exc = r["exc"]
        raise exc if exc is not None else InjectedFault(site)

    def corrupt(self, site: str, arrays: Sequence) -> Tuple:
        """Return ``arrays`` with one element flipped per array when a
        corrupt rule matches; the unmodified tuple otherwise.  Works on
        host numpy arrays or torch tensors (round-trips through numpy)."""
        r = self._match(site, ("corrupt",))
        if r is None:
            return tuple(arrays)
        self.log.append((site, "corrupt"))
        out = []
        for a in arrays:
            h = np.array(to_host(a), copy=True)
            if h.size:
                flat = h.reshape(-1)
                idx = self._rng.randrange(flat.shape[0])
                v = flat[idx]
                # flip to a value that changes the bytes for any dtype
                flat[idx] = (v + 1) if np.isfinite(v) else 0
            out.append(_like(a, h))
        return tuple(out)


def _like(orig, host: np.ndarray):
    """Rebuild ``host`` in the array flavor of ``orig``: a torch tensor on
    the original's device, or a numpy array."""
    if isinstance(orig, torch.Tensor):
        return torch.from_numpy(host).to(orig.device)
    return host


class InjectedFault(RuntimeError):
    """The FaultInjector's default raised fault."""


class DegradationLadder:
    """Execute a launch through the ordered rung chain with bounded
    retry, deterministic backoff, and a per-stage deadline.

    ``execute(rungs)`` takes ``[(rung_name, thunk), ...]`` ordered
    highest first and returns ``(result, rung_name)`` from the first
    thunk that succeeds.  A thunk that raises is retried on the same
    rung up to ``policy.retries`` times (sleeping ``policy.delay``
    between attempts) unless the rung's deadline has expired; then the
    ladder demotes to the next rung, recording the demotion.  The caller
    makes the final rung infallible (host passthrough); if every rung
    raises anyway the last exception propagates — that is a bug in the
    rung list, not a degradation.  A ``KernelError`` propagates at once,
    from any rung, without retry or demotion.
    """

    def __init__(self, policy: Optional[BackoffPolicy] = None,
                 deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = None,
                 sleep: Callable[[float], None] = None,
                 seed: int = 0, counters: Optional[dict] = None):
        self.policy = policy if policy is not None else BackoffPolicy()
        self.deadline_s = deadline_s
        self.clock = clock if clock is not None else time.monotonic
        self.sleep = sleep if sleep is not None else time.sleep
        self._rng = random.Random(seed)
        self.counters = (counters if counters is not None
                         else new_resilience_counters())

    def _expired(self, start: float) -> bool:
        return (self.deadline_s is not None
                and self.clock() - start >= self.deadline_s)

    def execute(self, rungs: Sequence[Tuple[str, Callable]]):
        c = self.counters
        last_exc: Optional[BaseException] = None
        for ri, (name, thunk) in enumerate(rungs):
            start = self.clock()
            attempt = 0
            while True:
                try:
                    result = thunk()
                except KernelError:
                    raise                     # a broken kernel, not a fault
                except Exception as exc:      # noqa: BLE001 — the whole point
                    last_exc = exc
                    if attempt >= self.policy.retries or self._expired(start):
                        if self._expired(start):
                            c["deadline_hits"] += 1
                        break                 # demote to the next rung
                    delay = self.policy.delay(attempt, self._rng)
                    if self.deadline_s is not None and \
                            self.clock() - start + delay >= self.deadline_s:
                        # sleeping would blow the stage deadline: demote
                        # now instead of sleeping into it
                        c["deadline_hits"] += 1
                        break
                    c["retries"] += 1
                    self.sleep(delay)
                    attempt += 1
                else:
                    if name == "passthrough":
                        c["passthroughs"] += 1
                    return result, name
            if ri + 1 < len(rungs):
                c["demotions"][rungs[ri + 1][0]] = \
                    c["demotions"].get(rungs[ri + 1][0], 0) + 1
        raise last_exc  # every rung failed: rung list had no safe bottom
