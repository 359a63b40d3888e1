"""Device-resident metadata plane: stage partition stats once, prune forever.

``DeviceStatsCache.get`` stages a table's full ``[C, P]`` mins / maxs /
demote planes to the GPU **once per table version** as float32 torch
tensors; after that a batch of queries prunes against the resident planes
with no host work per query.  Eviction is always safe (a miss simply
re-stages).  This module carries the stat-plane family only: a table
version change restages the plane in full.

Precision contract (the single place stats are downcast to f32)
---------------------------------------------------------------
Host metadata is float64; the kernel evaluates in float32.  Values outside
f32's 24-bit mantissa (e.g. int64 keys > 2**24) cannot be represented
exactly, so the cast is *widening* and *demoting*:

  * partition mins are rounded toward -inf, maxs toward +inf, and query
    lows/highs likewise (lo down, hi up).  Every interval only grows, so
    the kernel can never declare a false NO_MATCH — a pruned partition is
    always truly empty of matches (the correctness-critical direction);
  * wherever a min/max cast was inexact the partition's ``demote`` plane is
    set (same mechanism as nullability), suppressing FULL_MATCH for that
    partition.  Constraints whose lo/hi cast inexactly report
    ``bounds_exact=False`` and the wrapper demotes FULL host-side.

Net effect: int64 keys > 2**24 can only *false-negative* FULL (degrade to
PARTIAL, costing a scan) and can never *false-positive* NO_MATCH or FULL.

Every host array handed to torch here carries an explicit dtype: unlike a
32-bit JAX configuration, ``torch.from_numpy`` keeps float64 and int64, so
an implicit conversion would change the planes' bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .metadata import PartitionStats
from .predicate_cache import TableVersion


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks
    for the CPU.  ``None`` means ``cuda``; without a card that raises —
    nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class PlaneIntegrityError(RuntimeError):
    """A restaged plane failed checksum verification again.

    Raised only after the quarantine protocol exhausted its one restage:
    a resident plane's checksum mismatched, the plane was dropped and
    restaged from host truth, and the fresh plane mismatched too (i.e.
    the corruption source is persistent).  The serving layer's
    degradation ladder treats this like any launch failure and demotes —
    a wrong verdict is never served from a plane that failed its stamp.
    """


def to_host(a) -> np.ndarray:
    """A numpy view of a host array or a copy of a (device) tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plane_checksum(arrays) -> int:
    """Cheap integrity stamp over a plane chunk's bytes (crc32).

    Works identically on host numpy arrays and torch tensors (device
    tensors are copied back to the host — callers stamp from the *host*
    arrays at stage time for free and only pay the D2H on the sampled
    verify schedule).  f32 values round-trip the H2D copy bit-exactly, so
    a clean plane always verifies.
    """
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(to_host(a)).tobytes(), c)
    return c


_F32_NEG = np.float32(-np.inf)
_F32_POS = np.float32(np.inf)
_F32_MAX = np.float32(np.finfo(np.float32).max)


def round_down_f32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounding toward -inf (result <= x always)."""
    x = np.asarray(x, dtype=np.float64)
    f = x.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(f.astype(np.float64) > x, np.nextafter(f, _F32_NEG), f)


def round_up_f32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounding toward +inf (result >= x always)."""
    x = np.asarray(x, dtype=np.float64)
    f = x.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(f.astype(np.float64) < x, np.nextafter(f, _F32_POS), f)


def cast_stats_f32(
    mins: np.ndarray, maxs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Widening downcast of stat planes; returns (mins32, maxs32, inexact).

    ``inexact`` is True wherever either bound moved — those partitions must
    never be declared FULL (fed into the demote plane alongside nulls).

    The planes are additionally clamped to the finite f32 extremes, so the
    capacity tail and dropped partitions share one finite empty-interval
    sentinel with all-null partitions.  Clamping ±inf narrows the
    interval, so clamped entries are marked inexact (FULL-demoted);
    NO_MATCH stays safe because ``cast_bounds_f32`` clamps query bounds
    with the same monotone map, keeping every comparison's two sides
    consistent.  All-null partitions' empty intervals survive as
    (+f32max, -f32max) — still empty.
    """
    mins32 = round_down_f32(mins).astype(np.float32)
    maxs32 = round_up_f32(maxs).astype(np.float32)
    inexact = (mins32.astype(np.float64) != mins) | (
        maxs32.astype(np.float64) != maxs)
    mins_c = np.clip(mins32, -_F32_MAX, _F32_MAX)
    maxs_c = np.clip(maxs32, -_F32_MAX, _F32_MAX)
    inexact |= (mins_c != mins32) | (maxs_c != maxs32)
    return mins_c, maxs_c, inexact


def cast_bounds_f32(
    los: np.ndarray, his: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Widening downcast of query range bounds (lo down, hi up).

    Returns (lo32, hi32, exact) where ``exact`` is per-constraint; a False
    entry means FULL must be demoted to PARTIAL for the whole query (the
    widened range may admit rows the true range excludes).

    Bounds are clamped to the finite f32 extremes to match the stat
    planes (see cast_stats_f32).  One-sided infinite bounds lose nothing:
    every clamped stat satisfies ``>= -f32max`` exactly as it satisfied
    ``>= -inf``.  Degenerate lo=+inf / hi=-inf bounds can no longer
    *prove* FULL in the clamped domain, so they are flagged not exact.
    """
    los = np.asarray(los, dtype=np.float64)
    his = np.asarray(his, dtype=np.float64)
    lo32 = round_down_f32(los).astype(np.float32)
    hi32 = round_up_f32(his).astype(np.float32)
    exact = (lo32.astype(np.float64) == los) & (hi32.astype(np.float64) == his)
    exact &= ~np.isposinf(los) & ~np.isneginf(his)
    lo32 = np.clip(lo32, -_F32_MAX, _F32_MAX).astype(np.float32)
    hi32 = np.clip(hi32, -_F32_MAX, _F32_MAX).astype(np.float32)
    return lo32, hi32, exact


def snap_bounds_integral(
    los: np.ndarray, his: np.ndarray, integral: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Tighten range bounds on integral-domain columns: lo -> ceil, hi -> floor.

    Int columns and dictionary codes only take integer (or, for unseen
    string literals, never-attained half-integer) values, so ``x > 5``
    lowered to ``lo = nextafter(5)`` is exactly ``lo = 6`` — an integer
    that (below 2**24) casts to f32 exactly, keeping the device path
    identical to the f64 host oracle on the paper's workloads instead of
    conservatively demoting FULL.  No-op on float columns and on the
    infinite padding sentinels.
    """
    los = np.asarray(los, dtype=np.float64)
    his = np.asarray(his, dtype=np.float64)
    integral = np.asarray(integral, dtype=bool)
    los = np.where(integral & np.isfinite(los), np.ceil(los), los)
    his = np.where(integral & np.isfinite(his), np.floor(his), his)
    return los, his


def plane_capacity(p: int) -> int:
    """Padded partition capacity for staged planes.

    Next power of two with at least 25% append headroom over ``p``.
    Capacity slots beyond the logical partition count hold drop
    sentinels, which the batched kernel treats as never-matching.
    """
    want = max(8, p + max(p // 4, 1))
    cap = 8
    while cap < want:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class PlaneEpoch:
    """What a resident plane reflects: (table version, live count, capacity).

    The service carries this alongside batched launches so a launch is
    checkable against a fresh host restage of the same table version.
    """

    version: int
    live: int
    capacity: int


@dataclasses.dataclass
class DeviceStats:
    """A table's resident metadata plane: [C, cap] f32 tensors.

    ``capacity >= logical_p``; columns ``logical_p..capacity`` (and
    dropped partitions inside ``logical_p``) hold the drop sentinel
    ``(+f32max, -f32max, demote=1)`` — an empty interval that the batched
    kernel evaluates as NO_MATCH.

    The three tensors live in ONE ``planes_state`` tuple with the logical
    partition count, swapped as a single attribute store, so a launch
    that unpacked it once never mixes two stagings.
    """

    table_name: str
    version: int           # table DML version the planes reflect
    # ((mins, maxs, demote), logical_p): the three [C, cap] f32 tensors —
    # mins widened toward -inf, maxs toward +inf, demote 1.0 where
    # nulls/inexact cast (no FULL) — with the logical partition count
    # they reflect.  Launch code reads THIS field once.
    planes_state: Tuple
    integral: np.ndarray   # [C] bool, host-side: int/dictionary-code column
    live_count: int = -1
    tv_version: Optional[int] = None   # service TableVersion seen at staging
    # integrity stamp over the planes' bytes, computed host-side at stage
    # time; the cache verifies it on a sampled read schedule and always
    # after an eviction-restage
    checksum: Optional[int] = None

    def __post_init__(self):
        planes, p = self.planes_state
        if p < 0:          # dense staging: infer logical P from the tensors
            self.planes_state = (planes, int(planes[0].shape[1]))
        if self.live_count < 0:
            self.live_count = self.logical_p

    @property
    def planes(self) -> Tuple:
        return self.planes_state[0]

    @property
    def logical_p(self) -> int:
        return self.planes_state[1]

    @property
    def mins(self) -> torch.Tensor:
        return self.planes[0]

    @property
    def maxs(self) -> torch.Tensor:
        return self.planes[1]

    @property
    def demote(self) -> torch.Tensor:
        return self.planes[2]

    @property
    def num_columns(self) -> int:
        return int(self.mins.shape[0])

    @property
    def num_partitions(self) -> int:
        return self.logical_p

    @property
    def capacity(self) -> int:
        return int(self.mins.shape[1])

    @property
    def epoch(self) -> PlaneEpoch:
        return PlaneEpoch(self.version, self.live_count, self.capacity)

    @property
    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self.planes))

    @staticmethod
    def stage(stats: PartitionStats, table_name: str = "",
              version: int = 0, capacity: Optional[int] = None,
              live: Optional[np.ndarray] = None,
              device=None) -> "DeviceStats":
        """Host [P, C] f64 stats -> device [C, cap] f32 planes (one H2D copy).

        ``capacity=None`` stages dense (exact [C, P]); the cache passes
        ``plane_capacity(P)``.  ``device=None`` means the GPU.
        """
        dev = resolve_device(device)
        P = stats.num_partitions
        cap = P if capacity is None else max(int(capacity), P)
        mins32, maxs32, inexact = cast_stats_f32(stats.mins.T, stats.maxs.T)
        demote = ((stats.null_counts.T > 0) | inexact).astype(np.float32)
        if cap > P:
            C = len(stats.columns)
            pad = cap - P
            mins32 = np.concatenate(
                [mins32, np.full((C, pad), _F32_MAX, np.float32)], axis=1)
            maxs32 = np.concatenate(
                [maxs32, np.full((C, pad), -_F32_MAX, np.float32)], axis=1)
            demote = np.concatenate(
                [demote, np.ones((C, pad), np.float32)], axis=1)
        planes = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
            for a in (mins32, maxs32, demote))
        integral = np.array([c.kind != "float" for c in stats.columns],
                            dtype=bool)
        live_count = P if live is None else int(np.asarray(live, bool).sum())
        return DeviceStats(
            table_name=table_name,
            version=version,
            planes_state=(planes, P),
            integral=integral,
            live_count=live_count,
            # stamped from the host arrays pre-H2D: free at stage time
            checksum=plane_checksum((mins32, maxs32, demote)),
        )


# Registry of plane families under the integrity protocol.  Every family
# in DeviceStatsCache._stores MUST be declared here and vice versa, so a
# new family cannot ship without joining checksum stamping and byte
# accounting.
PLANE_FAMILIES = ("stat",)


@dataclasses.dataclass
class _Resident:
    """A plane the memory manager accounts for: device bytes + pin count."""

    nbytes: int
    pins: int = 0


class PlaneMemoryManager:
    """Device-memory accountant for the resident planes, LRU under a budget.

    Contract:

      * entries with ``pins > 0`` are never selected for eviction;
      * an admit first evicts LRU unpinned entries until the new entry
        fits, so ``bytes_in_use`` exceeds the budget only when the
        *pinned* set alone forces it (counted: ``over_budget_events``,
        ``pin_denied``) — with a sane budget both stay 0;
      * re-admitting a key that was previously evicted counts a
        ``restage_storm`` — the thrash signal for budget sizing;
      * eviction is always *safe*: the owning cache drops the entry (a
        later miss re-stages from host truth), and in-flight launches
        keep their tensors alive via ordinary references.

    ``budget_bytes=None`` disables eviction but keeps the accounting.
    """

    MONOTONIC = ("hits", "misses", "evictions", "evicted_bytes",
                 "restage_storms", "over_budget_events", "pin_denied")
    GAUGES = ("bytes_in_use", "peak_bytes", "pinned_bytes", "budget_bytes",
              "resident_planes")

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = budget_bytes
        # (family, key) -> _Resident, LRU order (oldest first)
        self._resident: "OrderedDict[Tuple, _Resident]" = OrderedDict()
        self._evict_cb: Optional[Callable[[str, Tuple], None]] = None
        self._ever_evicted: set = set()
        # pins owed by scopes whose entry was released (invalidate) and
        # possibly re-admitted under the same key: their unpins consume
        # this debt instead of stripping a NEW scope's pin on the fresh
        # record (which would let it be evicted mid-launch)
        self._orphan_pins: dict = {}
        self.bytes_in_use = 0
        self.peak_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.restage_storms = 0
        self.over_budget_events = 0   # admits that left use > budget (pins)
        self.pin_denied = 0           # evictions blocked: all-pinned tail

    def bind(self, evict_cb: Callable[[str, Tuple], None]) -> None:
        """Register the owning cache's store-removal callback."""
        self._evict_cb = evict_cb

    # -- accounting ------------------------------------------------------

    def touch(self, family: str, key: Tuple) -> None:
        """A getter served this resident plane: LRU refresh + hit."""
        fk = (family, key)
        if fk in self._resident:
            self.hits += 1
            self._resident.move_to_end(fk)

    def admit(self, family: str, key: Tuple, nbytes: int) -> None:
        """Account a freshly staged plane, evicting LRU unpinned entries
        first so the budget holds wherever pins allow it to."""
        fk = (family, key)
        old = self._resident.pop(fk, None)
        if old is not None:
            self.bytes_in_use -= old.nbytes
        self.misses += 1
        if fk in self._ever_evicted:
            self.restage_storms += 1
        self._make_room(int(nbytes))
        self._resident[fk] = _Resident(int(nbytes),
                                       pins=old.pins if old else 0)
        self.bytes_in_use += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self.bytes_in_use)
        if self.budget_bytes is not None \
                and self.bytes_in_use > self.budget_bytes:
            self.over_budget_events += 1

    def _make_room(self, incoming: int) -> None:
        if self.budget_bytes is None:
            return
        if incoming > self.budget_bytes:
            # a plane that can never fit: admit over budget (counted by
            # the caller) and leave everyone else resident
            return
        while self.bytes_in_use + incoming > self.budget_bytes:
            victim = next((fk for fk, r in self._resident.items()
                           if r.pins == 0), None)
            if victim is None:
                if self._resident:
                    self.pin_denied += 1
                return
            self._evict_one(victim)

    def _evict_one(self, fk: Tuple) -> None:
        r = self._resident.pop(fk)
        assert r.pins == 0, f"evicting pinned plane {fk}"
        self.bytes_in_use -= r.nbytes
        self.evictions += 1
        self.evicted_bytes += r.nbytes
        self._ever_evicted.add(fk)
        if self._evict_cb is not None:
            self._evict_cb(*fk)

    def was_evicted(self, family: str, key: Tuple) -> bool:
        """Whether this key has ever been budget-evicted — the cache
        force-verifies the checksum on every restage of such a key."""
        return (family, key) in self._ever_evicted

    def release(self, family: str, key: Tuple) -> None:
        """The cache dropped this entry itself (invalidate / restage)."""
        fk = (family, key)
        r = self._resident.pop(fk, None)
        if r is not None:
            self.bytes_in_use -= r.nbytes
            if r.pins:
                self._orphan_pins[fk] = self._orphan_pins.get(fk, 0) + r.pins

    def reclaim(self) -> None:
        """Evict back under budget once pins release (pin-scope exit)."""
        if self.budget_bytes is None \
                or self.bytes_in_use <= self.budget_bytes:
            return
        for fk, r in list(self._resident.items()):
            if r.pins == 0 and r.nbytes > self.budget_bytes:
                self._evict_one(fk)
        while self.bytes_in_use > self.budget_bytes:
            victim = next((fk for fk, r in self._resident.items()
                           if r.pins == 0), None)
            if victim is None:
                return
            self._evict_one(victim)

    # -- pinning ---------------------------------------------------------

    def pin(self, family: str, key: Tuple) -> bool:
        r = self._resident.get((family, key))
        if r is None:
            return False
        r.pins += 1
        return True

    def unpin(self, family: str, key: Tuple) -> None:
        fk = (family, key)
        debt = self._orphan_pins.get(fk)
        if debt:                        # our pinned record was released
            if debt == 1:
                del self._orphan_pins[fk]
            else:
                self._orphan_pins[fk] = debt - 1
            return
        r = self._resident.get(fk)
        if r is not None and r.pins > 0:
            r.pins -= 1

    @property
    def pinned_bytes(self) -> int:
        return sum(r.nbytes for r in self._resident.values() if r.pins)

    @property
    def resident_planes(self) -> int:
        return len(self._resident)

    def snapshot(self) -> dict:
        out = {k: getattr(self, k) for k in self.MONOTONIC}
        out.update({k: getattr(self, k) for k in self.GAUGES})
        return out

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Monotonic counters differenced, gauges taken from ``after``."""
        out = {k: after[k] - before[k] for k in PlaneMemoryManager.MONOTONIC}
        out.update({k: after[k] for k in PlaneMemoryManager.GAUGES})
        return out


class DeviceStatsCache:
    """Once-per-table-version staging of the stat planes, LRU-bounded.

    Keys are ``(table_name, stats.uid)``: the stats uid distinguishes a
    *rebuilt* table — same name, same shape, new data — from the object
    that was staged, so a stale plane can never serve it.  Entries record
    the table DML ``version`` they reflect and the service
    ``TableVersion`` seen at staging; when either moves on, ``get``
    restages the whole plane (counted in ``full_restages``).

    ``budget_bytes`` hands residency to a ``PlaneMemoryManager``: one
    byte budget, per-table LRU eviction, and in-flight pinning via
    ``pin_scope`` so a batched launch can never lose a plane it is
    consuming.  Without a budget the ``max_entries`` count cap applies
    and the manager only accounts.  Every getter is atomic under one
    reentrant lock.
    """

    def __init__(self, max_entries: int = 16,
                 budget_bytes: Optional[int] = None,
                 fault_injector=None, integrity_sample: int = 64,
                 device=None):
        self.device = resolve_device(device)
        # (name, uid) -> DeviceStats ([C, cap] planes + epoch)
        self.entries: "OrderedDict[Tuple, DeviceStats]" = OrderedDict()  # guarded-by: _lock
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        # staging-work counters (H2D bytes; full restages of planes that
        # were resident at an older version)
        self.staged_bytes = 0
        self.full_restages = 0
        self.memory = PlaneMemoryManager(budget_bytes)
        self._stores = {"stat": self.entries}
        self.memory.bind(self._evict_family)
        # Epoch check + plane read must be atomic per getter; one
        # reentrant lock serializes getters, DML hooks and manager
        # mutation; pin scopes are tracked per thread.
        self._lock = threading.RLock()
        self._pin_local = threading.local()
        # Plane integrity: every staged plane carries a crc32 stamp;
        # reads verify it every ``integrity_sample``-th getter hit (1 =
        # every read; 0 = never sample) and ALWAYS right after a
        # quarantine- or eviction-restage.  A mismatch quarantines the
        # plane (drop + one restage from host truth); a second mismatch
        # raises PlaneIntegrityError, which the serving ladder demotes
        # past.  ``fault_injector`` is the chaos seam
        # (serve.resilience.FaultInjector).
        self.fault_injector = fault_injector
        self.integrity_sample = int(integrity_sample)
        self._integrity_tick = 0        # guarded-by: _lock
        self._quarantined: set = set()  # guarded-by: _lock
        self.integrity = dict(verifications=0, checksum_failures=0,  # guarded-by: _lock
                              quarantines=0)

    # ---- memory-manager plumbing ---------------------------------------

    def _evict_family(self, family: str, key: Tuple) -> None:
        """Manager-initiated eviction: drop the entry from its store
        (the manager already removed its own record)."""
        self._stores[family].pop(key, None)
        if self.fault_injector is not None:
            self.fault_injector.fire("evict")

    # ---- integrity plumbing --------------------------------------------

    def _fire(self, site: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector.fire(site)

    def _corrupt(self, site: str, arrays: Tuple) -> Tuple:
        if self.fault_injector is not None:
            return self.fault_injector.corrupt(site, arrays)
        return arrays

    def _verify_due(self) -> bool:
        s = self.integrity_sample
        if s <= 0:
            return False
        self._integrity_tick += 1
        return self._integrity_tick % s == 0

    def _verify(self, arrays, stamp: Optional[int]) -> bool:
        self.integrity["verifications"] += 1
        return stamp is None or plane_checksum(arrays) == stamp

    def _quarantine(self, family: str, key: Tuple) -> None:
        """A resident plane's bytes no longer match its stamp: count it,
        drop the plane, and mark the key so the restage is verified."""
        self.integrity["checksum_failures"] += 1
        self.integrity["quarantines"] += 1
        self._stores[family].pop(key, None)
        self.memory.release(family, key)
        self._quarantined.add((family, key))

    def integrity_snapshot(self) -> dict:
        with self._lock:
            return dict(self.integrity)

    def _pin_frames(self):
        frames = getattr(self._pin_local, "frames", None)
        if frames is None:
            frames = self._pin_local.frames = []
        return frames

    @contextlib.contextmanager
    def pin_scope(self):
        """Pin every plane a getter returns inside this scope.

        Batched launches wrap their getter + kernel call in a scope so
        the planes they are about to consume cannot be evicted
        mid-launch.  Scopes nest; pins are reference counts per entry.
        """
        frame: list = []
        with self._lock:
            self._pin_frames().append(frame)
        try:
            yield
        finally:
            # a raise anywhere in the scope body must still release every
            # pin this frame took, or the leaked refcounts permanently
            # shrink the evictable set under the budget
            with self._lock:
                frames = self._pin_frames()
                for i in range(len(frames) - 1, -1, -1):
                    if frames[i] is frame:
                        del frames[i]
                        break
                cleanup_exc = None
                for fk in frame:
                    try:
                        self.memory.unpin(*fk)
                    except Exception as exc:  # pragma: no cover - defensive
                        cleanup_exc = exc
                try:
                    self.memory.reclaim()
                except Exception as exc:
                    cleanup_exc = exc
                if cleanup_exc is not None:
                    raise cleanup_exc

    def _scope_pin(self, family: str, key: Tuple) -> None:
        frames = self._pin_frames()
        if frames and self.memory.pin(family, key):
            frames[-1].append((family, key))

    def _touch(self, family: str, key: Tuple) -> None:
        self.memory.touch(family, key)
        self._scope_pin(family, key)

    def _admit(self, family: str, key: Tuple, nbytes: int) -> None:
        self.memory.admit(family, key, nbytes)
        self._scope_pin(family, key)

    # ---- version plumbing ----------------------------------------------

    @staticmethod
    def _table_version(table) -> int:
        return int(getattr(table, "version", 0))

    def staging_snapshot(self) -> dict:
        return dict(staged_bytes=self.staged_bytes,
                    full_restages=self.full_restages)

    def plane_epoch(self, table) -> Optional[PlaneEpoch]:
        """The resident [C, cap] plane's epoch for this table, if staged."""
        with self._lock:
            e = self.entries.get((table.name, table.stats.uid))
            return e.epoch if e is not None else None

    # ---- [C, cap] stat planes ------------------------------------------

    def get(self, table, tv: Optional[TableVersion] = None) -> DeviceStats:
        """The table's resident DeviceStats: staged on first touch and
        restaged in full whenever the table's version (or the service's
        ``TableVersion``) moved on since.

        stats.uid guards against a rebuilt table (same name, same shape,
        new data) silently hitting the stale staged plane — stale stats
        would break NO_MATCH safety, the one direction that loses rows.
        """
        with self._lock:
            self._fire("get.stat")
            key = (table.name, table.stats.uid)
            tvv = tv.version if tv is not None else None
            tver = self._table_version(table)
            e = self.entries.get(key)
            if e is not None:
                if e.version == tver and (tvv is None or e.tv_version in
                                          (None, tvv)):
                    self.hits += 1
                    if tvv is not None:
                        e.tv_version = tvv
                    self.entries.move_to_end(key)
                    self._touch("stat", key)
                    if not self._verify_due() or self._verify(e.planes,
                                                              e.checksum):
                        return e
                    # sampled verify caught a torn resident plane:
                    # quarantine it and restage fresh below (verified)
                    self._quarantine("stat", key)
                else:
                    # stale: rebuild below
                    self.full_restages += 1
                    del self.entries[key]
                    self.memory.release("stat", key)
            self.misses += 1
            retried = False
            while True:
                self._fire("stage.stat")
                e = DeviceStats.stage(
                    table.stats, table.name, tver,
                    capacity=plane_capacity(table.stats.num_partitions),
                    live=getattr(table, "live", None), device=self.device)
                e.tv_version = tvv
                planes, logical_p = e.planes_state
                e.planes_state = (self._corrupt("stage.stat", planes),
                                  logical_p)
                self.staged_bytes += e.nbytes
                self._admit("stat", key, e.nbytes)
                self.entries[key] = e
                self.entries.move_to_end(key)
                if self.memory.budget_bytes is None:
                    while len(self.entries) > self.max_entries:
                        k, _ = self.entries.popitem(last=False)
                        self.memory.release("stat", k)
                # a restage of a quarantined or previously-evicted key is
                # ALWAYS verified, whatever the sampling schedule says;
                # other fresh stages join the sampled schedule
                force = ("stat", key) in self._quarantined \
                    or self.memory.was_evicted("stat", key) \
                    or self._verify_due()
                if not force or self._verify(e.planes, e.checksum):
                    self._quarantined.discard(("stat", key))
                    return e
                if retried:
                    self._quarantined.discard(("stat", key))
                    self.entries.pop(key, None)
                    self.memory.release("stat", key)
                    raise PlaneIntegrityError(
                        f"stat plane {key} failed checksum verification "
                        f"after quarantine restage")
                self._quarantine("stat", key)
                retried = True

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self.entries.values())
