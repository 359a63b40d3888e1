"""Device-resident metadata plane: stage partition stats once, prune forever.

``DeviceStatsCache.get`` stages a table's full ``[C, P]`` mins / maxs /
demote planes to the GPU **once per table version** as float32 torch
tensors; after that a batch of queries prunes against the resident planes
with no host work per query.  Beside them it stages the runtime
techniques' per-column planes (join-key, enumeration and block-top-k
rows) and the hierarchical tree planes aggregated from the stat planes
(see ``DeviceStatsCache``).  Eviction is always safe (a miss simply
re-stages), and a table's DML replays into the resident planes from its
delta log instead of restaging them.

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

from .metadata import NO_MATCH, PartitionStats
from .predicate_cache import TableVersion
from .prune_filter import eval_tv


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

    def gather(self, cids) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """On-device row gather -> per-constraint [K, cap] planes.

        ``index_select`` on the planes' device: the resident [C, cap]
        tensors never leave it."""
        idx = torch.from_numpy(np.asarray(cids, dtype=np.int64)).to(
            self.mins.device)
        return tuple(p.index_select(0, idx) for p in self.planes)

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


KPLANE = 64   # block-top-k plane width: values kept per partition
# Per-column planes kept per family when the cache has no byte budget.
MAX_PLANES = 64

# Hierarchical (tree) plane geometry.  The flat [C, cap] planes aggregate
# into [C, G] *group* planes (G = cap / fanout; both powers of two, so the
# division is exact): group g's interval is the min/max hull of its
# members, so a query range that misses the hull misses every member and
# the batched path can prune whole groups before touching leaves.  A
# second, tiny *coarse* level (at most TREE_COARSE_MAX root groups) lives
# on the host in the same plane entry: it restricts the group pre-pass
# and prices it before any launch (the dense fallback).  Below
# fanout * TREE_MIN_GROUPS partitions the flat launch is used.
TREE_FANOUT = 256
TREE_MIN_GROUPS = 4
TREE_COARSE_MAX = 64

# Registry of plane families under the integrity protocol.  Every family
# in DeviceStatsCache._stores MUST be declared here and vice versa, so a
# new family cannot ship without joining checksum stamping and byte
# accounting.  ``verdict`` is the Sec. 8.2 predicate / verdict cache: one
# int8 [cap] three-valued verdict row per (table, canonical predicate).
PLANE_FAMILIES = ("stat", "join_key", "enum", "block_topk", "tree_stat",
                  "verdict")


def _has_column(stats: PartitionStats, name: str) -> bool:
    return any(c.name == name for c in stats.columns)


def coarse_from_groups(gmins: torch.Tensor, gmaxs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host [C, G2] root hull of the [C, G] group planes (G2 <= 64),
    as CPU tensors (one small copy back from the device)."""
    C, G = gmins.shape
    g2 = min(int(G), TREE_COARSE_MAX)
    f2 = int(G) // g2
    cmins = gmins.reshape(C, g2, f2).amin(dim=2).cpu()
    cmaxs = gmaxs.reshape(C, g2, f2).amax(dim=2).cpu()
    return cmins, cmaxs


def aggregate_tree_planes(mins: torch.Tensor, maxs: torch.Tensor,
                          demote: torch.Tensor, fanout: int) -> Tuple:
    """Aggregate flat [C, cap] planes into the tree plane arrays.

    Returns ``(gmins, gmaxs, gdem, cmins, cmaxs)``: [C, G] group hulls on
    the planes' device (min of member mins / max of member maxs / max of
    member demotes) plus the host coarse root level.  Min and max of
    already-widened f32 values are exact.  Sentinel slots (+f32max,
    -f32max) aggregate to an empty hull only when the whole group is
    sentinels: a live member's interval always widens the hull, so group
    NO_MATCH implies member NO_MATCH with no special-casing.
    """
    C, cap = mins.shape
    if fanout <= 0 or cap % fanout:
        raise ValueError(f"fanout {fanout} must divide plane capacity {cap}")
    G = cap // fanout
    gmins = mins.reshape(C, G, fanout).amin(dim=2)
    gmaxs = maxs.reshape(C, G, fanout).amax(dim=2)
    gdem = demote.reshape(C, G, fanout).amax(dim=2)
    cmins, cmaxs = coarse_from_groups(gmins, gmaxs)
    return gmins, gmaxs, gdem, cmins, cmaxs


@dataclasses.dataclass
class _PlaneEntry:
    """A resident per-column plane: device tensors + the version staged.

    ``arrays`` are capacity-padded along the partition axis (axis 0);
    slots beyond ``logical_p`` and dropped partitions hold the family's
    sentinel.  ``meta`` carries host-side extras (the column, enum
    wmax/domain_ok, the tree geometry, the checksum stamp).
    """

    version: int
    logical_p: int
    arrays: Tuple
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.arrays[0].shape[0])

    @property
    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self.arrays))


def tree_entry_for(dstats: "DeviceStats", fanout: int = TREE_FANOUT,
                   version: int = 0,
                   logical_p: Optional[int] = None) -> _PlaneEntry:
    """A standalone hierarchical plane entry aggregated from a flat one.

    Tests that stage ``DeviceStats`` directly (no table, no cache) get the
    entry shape ``DeviceStatsCache.tree_plane`` serves: the group arrays
    on the device and the coarse level on the host in ``arrays``, the
    geometry in ``meta``.  The cache builds through here too.
    """
    arrays = aggregate_tree_planes(*dstats.planes, fanout=fanout)
    return _PlaneEntry(
        version,
        dstats.num_partitions if logical_p is None else int(logical_p),
        arrays,
        meta=dict(fanout=fanout, cap=dstats.capacity,
                  groups=int(arrays[0].shape[1])))


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

    @contextlib.contextmanager
    def transient(self, family: str, key: Tuple, nbytes: int):
        """Count a replay's second copy of a resident plane while it
        exists: the replay writes a clone and swaps it in, so for its
        duration the plane is resident twice.  The plane itself is pinned
        (room is made by evicting others, never it), the copy's bytes
        count toward ``bytes_in_use`` and ``peak_bytes``, and leave it
        when the old copy is dropped at the swap."""
        pinned = self.pin(family, key)
        self._make_room(int(nbytes))
        self.bytes_in_use += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self.bytes_in_use)
        if self.budget_bytes is not None \
                and self.bytes_in_use > self.budget_bytes:
            self.over_budget_events += 1
        try:
            yield
        finally:
            self.bytes_in_use -= int(nbytes)
            if pinned:
                self.unpin(family, key)

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
    """Once-per-table staging of metadata planes, delta-synced, LRU-bounded.

    Keys are ``(table_name, stats.uid)``: the stats uid distinguishes a
    *rebuilt* table — same name, same shape, new data — from the object
    that was staged, so a stale plane can never serve it.

    Delta staging (incremental ingest)
    ----------------------------------
    Resident entries record the table DML ``version`` they reflect (and
    the service ``TableVersion`` seen at staging).  When a table's version
    advances through its own DML methods (``append_partitions`` /
    ``drop_partitions`` / ``update_column``), ``get`` and the plane getters
    *replay* the table's ``TableDelta`` log into the resident tensors in
    place, with one H2D copy of the changed columns:

      * **append**: planes were allocated with ``plane_capacity`` slack,
        so only the new ``[C, ΔP]`` columns are staged;
      * **drop**: dropped partitions are scattered with the family's
        sentinel (``(+f32max, -f32max, demote=1)`` for the stat planes),
        which every batched kernel evaluates as NO_MATCH or keep;
      * **update(column)**: the [C, P] planes restage only that column's
        three rows; per-column planes of *other* columns advance their
        version with no staging work;
      * **rewrite**, an update of a per-column plane's own column, a log
        gap or a capacity overflow: full restage — the only cases that
        pay O(table) again.

    ``staged_bytes`` / ``delta_stages`` / ``full_restages`` count the
    work.  A service ``TableVersion`` bump without a covering delta log
    (the legacy ``notify_*`` flow) always restages in full.

    A replay never writes a tensor a launch may be reading: it writes a
    clone of the resident tensors and publishes it under the lock in one
    store, with the stamp computed from the new tensors (the JAX
    package's immutable arrays give the same guarantee).  A launch that
    got the old tensors (``get``'s entry's ``planes_state``, read once,
    or another getter's tensor tuple) reads them whole and unchanged;
    ``tree_plane`` follows the flat entry it is given, so a caller that
    froze that entry (``dataclasses.replace``) gets group hulls of the
    same planes.  Tensors derived from a plane (a mesh shard's copy on
    another device, a verdict row's host copy) follow the swap.  While a
    replay runs the clone counts under the memory budget
    (``PlaneMemoryManager.transient``).  On the card every getter records the tensors it hands
    out on the caller's current stream (``Tensor.record_stream``), so the
    caching allocator never gives a swapped-out tensor's memory to a new
    one while a kernel enqueued on another stream may still read it, and
    every staging or replay finishes on the device before it is
    published.

    Runtime-technique planes
    ------------------------
    Beside the [C, cap] min/max/demote planes the cache stages three
    *per-column* plane families for the runtime techniques, keyed by
    (table identity, column):

      * **join-key planes** (``join_key_plane``): the key column's widened
        f32 [cap] min/max rows, consumed by ``join_overlap_batched``;
      * **enumeration planes** (``enum_plane``): the key column's
        integer-snapped [cap] int32 pmin/width rows (width 0 = never
        enumerate), consumed by ``bloom_probe_batched``;
      * **block-top-k planes** (``block_topk_plane``): [cap, KPLANE] rows
        of the column's per-partition top-K *signed* values (sign = +1
        DESC / -1 ASC, nulls excluded, f64 -> f32 rounded toward -inf so
        every stored value is <= the true row value — a boundary derived
        from them is always witnessed), consumed by ``topk_init_batched``;

    one *tree* family (``tree_plane``): the [C, G] group hulls of the
    stat planes (``tree_fanout`` partitions a group) with their host
    coarse level, aggregated on the device from the current stat planes
    and re-aggregated only for the groups a delta dirtied; and one
    *verdict* family (``verdict_plane`` / ``verdict_record``): int8 [cap]
    rows of a filter predicate's three-valued verdicts, keyed by (table
    identity, canonical predicate), repaired on append and drop by the
    same clone-and-swap.

    ``budget_bytes`` hands residency to a ``PlaneMemoryManager``: one
    byte budget across all six families, per-plane LRU eviction, and
    in-flight pinning via ``pin_scope`` so a batched launch can never lose
    a plane it is consuming.  Without a budget the ``max_entries`` /
    ``MAX_PLANES`` count caps apply and the manager only accounts.  Every
    getter is atomic under one reentrant lock.
    """

    def __init__(self, max_entries: int = 16,
                 budget_bytes: Optional[int] = None,
                 fault_injector=None, integrity_sample: int = 64,
                 tree_fanout: int = TREE_FANOUT, device=None):
        if tree_fanout < 2 or tree_fanout & (tree_fanout - 1):
            raise ValueError(
                f"tree_fanout must be a power of two >= 2, got {tree_fanout}")
        self.device = resolve_device(device)
        # Leaf partitions per tree-plane group; plane capacities are
        # powers of two, so any pow-2 fanout <= cap divides them exactly.
        self.tree_fanout = int(tree_fanout)
        # (name, uid) -> DeviceStats ([C, cap] planes + epoch)
        self.entries: "OrderedDict[Tuple, DeviceStats]" = OrderedDict()  # guarded-by: _lock
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        # (name, uid, col) -> _PlaneEntry((pmin, pmax) [cap] f32 rows)
        self.key_planes: "OrderedDict[Tuple, _PlaneEntry]" = OrderedDict()  # guarded-by: _lock
        # (name, uid, col) -> _PlaneEntry((pmin, width) [cap] int32 rows,
        #                                 meta: wmax, domain_ok)
        self.enum_planes: "OrderedDict[Tuple, _PlaneEntry]" = OrderedDict()  # guarded-by: _lock
        # (name, uid, col, desc) -> _PlaneEntry(([cap, KPLANE] signed rows,))
        self.topk_planes: "OrderedDict[Tuple, _PlaneEntry]" = OrderedDict()  # guarded-by: _lock
        # (name, uid) -> _PlaneEntry((gmins, gmaxs, gdem) [C, G] group
        # hulls on the device + (cmins, cmaxs) host coarse root, all five
        # under one stamp; meta: fanout, cap, groups)
        self.tree_planes: "OrderedDict[Tuple, _PlaneEntry]" = OrderedDict()  # guarded-by: _lock
        # (name, uid, canonical predicate key) -> _PlaneEntry((verdicts,)
        # [cap] int8, meta: the columns the predicate reads)
        self.verdict_planes: "OrderedDict[Tuple, _PlaneEntry]" = OrderedDict()  # guarded-by: _lock
        self.plane_hits = 0
        self.plane_misses = 0
        # staging-work counters (H2D bytes; delta vs full attribution)
        self.staged_bytes = 0
        self.delta_stages = 0      # successful delta replays (any family)
        self.full_restages = 0     # full restagings of previously-resident
                                   # planes (rewrite / log gap / overflow)
        self.prefetch_stages = 0   # prefetch() calls that staged bytes
        self.memory = PlaneMemoryManager(budget_bytes)
        self._stores = {"stat": self.entries, "join_key": self.key_planes,
                        "enum": self.enum_planes,
                        "block_topk": self.topk_planes,
                        "tree_stat": self.tree_planes,
                        "verdict": self.verdict_planes}
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
                              quarantines=0, verdict_repairs=0)

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

    # ---- version / delta-log plumbing ----------------------------------

    @staticmethod
    def _table_version(table) -> int:
        return int(getattr(table, "version", 0))

    @staticmethod
    def _deltas_since(table, version: int):
        """Ordered TableDeltas in (version, table.version], or None when
        the log has been compacted past ``version`` (full restage)."""
        deltas = getattr(table, "deltas", None)
        if deltas is None:
            return None
        if version < int(getattr(table, "delta_floor", 0)):
            return None
        return [d for d in deltas if d.version > version]

    @staticmethod
    def _live_count(table) -> int:
        return int(getattr(table, "num_live_partitions",
                           table.stats.num_partitions))

    def _ids(self, part_ids) -> torch.Tensor:
        """Dropped partition ids as an index tensor on the device (one
        small H2D copy)."""
        return torch.from_numpy(
            np.asarray(part_ids, dtype=np.int64)).to(self.device)

    def _h2d(self, *host) -> torch.Tensor:
        """Stack same-shaped host rows and copy them to the device in one
        H2D transfer."""
        return torch.from_numpy(np.ascontiguousarray(np.stack(host))).to(
            self.device)

    def _hold(self, tensors) -> None:
        """Tie the tensors a getter hands out to the caller's current
        CUDA stream (``record_stream``): when a later swap drops the
        cache's reference, their memory is not reused before the work
        that stream has enqueued by then is done.  A no-op on the CPU."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)

    def _settle(self) -> None:
        """Finish the staging or replay this thread enqueued before it is
        published, so a launch on any stream reads complete planes."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _clone(arrays) -> Tuple:
        return tuple(a.clone() for a in arrays)

    def staging_snapshot(self) -> dict:
        return dict(staged_bytes=self.staged_bytes,
                    delta_stages=self.delta_stages,
                    full_restages=self.full_restages,
                    prefetch_stages=self.prefetch_stages)

    def prefetch(self, table, tv: Optional[TableVersion] = None) -> bool:
        """Stage (or replay) the table's [C, cap] stat plane ahead of its
        launch.  Runs the ordinary ``get`` path under the same lock, so a
        concurrent getter finds the plane resident.  Never raises: a
        staging failure surfaces on the real launch, where the ladder
        handles it.  True when bytes were staged (``prefetch_stages``)."""
        with self._lock:
            before = self.staged_bytes
            try:
                self.get(table, tv)
            except Exception:
                return False
            staged = self.staged_bytes > before
            if staged:
                self.prefetch_stages += 1
            return staged

    def plane_epoch(self, table) -> Optional[PlaneEpoch]:
        """The resident [C, cap] plane's epoch for this table, if staged."""
        with self._lock:
            e = self.entries.get((table.name, table.stats.uid))
            return e.epoch if e is not None else None

    # ---- [C, cap] stat planes ------------------------------------------

    @staticmethod
    def _stat_cols(stats: PartitionStats, lo: int, hi: int):
        """Host f32 plane columns for partitions [lo, hi) (delta slice)."""
        m32, x32, inexact = cast_stats_f32(stats.mins[lo:hi].T,
                                           stats.maxs[lo:hi].T)
        dm = ((stats.null_counts[lo:hi].T > 0) | inexact).astype(np.float32)
        return m32, x32, dm

    def _replay_stats(self, key: Tuple, e: DeviceStats, table,
                      deltas) -> bool:
        """Bring a resident [C, cap] entry current by replaying deltas into
        a clone of its tensors and swapping the clone in.

        Returns False, having written nothing, when a full restage is
        required (a rewrite, an unknown column or kind, capacity
        overflow); on success only the changed partition columns were
        staged."""
        stats = table.stats
        if stats.num_partitions > e.capacity:
            return False
        for d in deltas:
            if d.kind not in ("append", "drop", "update") or (
                    d.kind == "update" and not _has_column(stats, d.column)):
                return False
        with self.memory.transient("stat", key, e.nbytes):
            planes, nbytes = self._stat_deltas(self._clone(e.planes), stats,
                                               deltas)
            checksum = plane_checksum(planes)
        self._settle()
        # publish: the stamp from the clean replayed tensors, then the
        # chaos seam may tear bytes *after* the stamp (the corruption the
        # verifier must catch); one tuple store of (planes, P), so a later
        # read never pairs the new planes with the old partition count
        e.checksum = checksum
        e.planes_state = (self._corrupt("stage.stat", planes),
                          stats.num_partitions)
        e.live_count = self._live_count(table)
        self.staged_bytes += nbytes
        self.delta_stages += 1
        return True

    def _stat_deltas(self, planes: Tuple, stats: PartitionStats,
                     deltas) -> Tuple[Tuple, int]:
        """Write ``deltas`` into ``planes`` (a clone nothing reads yet);
        returns the planes and the bytes staged."""
        mins, maxs, dem = planes
        nbytes = 0
        for d in deltas:
            if d.kind == "append":
                cols = self._h2d(*self._stat_cols(stats, d.part_lo,
                                                  d.part_hi))
                for plane, col in zip((mins, maxs, dem), cols):
                    plane[:, d.part_lo:d.part_hi] = col
                nbytes += cols.numel() * cols.element_size()
            elif d.kind == "drop":
                ids = self._ids(d.part_ids)
                mins.index_fill_(1, ids, float(_F32_MAX))
                maxs.index_fill_(1, ids, -float(_F32_MAX))
                dem.index_fill_(1, ids, 1.0)
                nbytes += 3 * int(mins.shape[0]) * len(d.part_ids) * 4
            else:                       # update: that column's three rows
                ci = stats.col_id(d.column)
                P = stats.num_partitions
                m32, x32, inexact = cast_stats_f32(
                    stats.mins[:, ci][None, :], stats.maxs[:, ci][None, :])
                dm = ((stats.null_counts[:, ci][None, :] > 0)
                      | inexact).astype(np.float32)
                rows = self._h2d(m32[0], x32[0], dm[0])
                for plane, row in zip((mins, maxs, dem), rows):
                    plane[ci, :P] = row
                nbytes += 3 * P * 4
        return (mins, maxs, dem), nbytes

    def get(self, table, tv: Optional[TableVersion] = None) -> DeviceStats:
        """The table's resident DeviceStats: staged on first touch,
        delta-synced on table DML, fully restaged only when it must be.

        stats.uid guards against a rebuilt table (same name, same shape,
        new data) silently hitting the stale staged plane — stale stats
        would break NO_MATCH safety, the one direction that loses rows.
        A service ``TableVersion`` bump without a covering table delta
        log (the legacy invalidation flow) also forces a restage.

        A replay publishes new tensors into the entry with one store of
        ``planes_state``: a caller that read it keeps whole planes.
        """
        with self._lock:
            self._fire("get.stat")
            key = (table.name, table.stats.uid)
            tvv = tv.version if tv is not None else None
            tver = self._table_version(table)
            e = self.entries.get(key)
            if e is not None:
                served = False
                if e.version == tver and (tvv is None or e.tv_version in
                                          (None, tvv)):
                    self.hits += 1
                    if tvv is not None:
                        e.tv_version = tvv
                    served = True
                elif e.version < tver:
                    deltas = self._deltas_since(table, e.version)
                    if deltas is not None and self._replay_stats(
                            key, e, table, deltas):
                        e.version = tver
                        e.tv_version = tvv
                        self.hits += 1
                        served = True
                if served:
                    self.entries.move_to_end(key)
                    self._touch("stat", key)
                    if not self._verify_due() or self._verify(e.planes,
                                                              e.checksum):
                        self._hold(e.planes)
                        return e
                    # sampled verify caught a torn resident plane:
                    # quarantine it and restage fresh below (verified)
                    self._quarantine("stat", key)
                else:
                    # stale and not replayable: rebuild below
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
                self._settle()
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
                    self._hold(e.planes)
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

    # ---- runtime-technique planes --------------------------------------

    def _plane_current(self, family: str, store: "OrderedDict", key: Tuple,
                       table, columns: Tuple[str, ...], append_fn, drop_fn
                       ) -> Optional[_PlaneEntry]:
        """The resident plane entry brought current, or None.

        Replays the table's delta log into a clone of the entry's tensors
        and swaps it in: appends stage only the new partitions
        (``append_fn``), drops scatter the family's sentinel (``drop_fn``),
        each writing the working entry it is handed; updates of columns
        the plane does not read are free version advances.  An update of
        one of ``columns``, a rewrite, a log gap or capacity overflow
        drops the entry (the caller stages fresh, counted as a plane miss
        and a full restage).
        """
        e = store.get(key)
        if e is None:
            return None
        tver = self._table_version(table)
        served = e.version == tver
        if e.version < tver:
            deltas = self._deltas_since(table, e.version)
            if deltas is not None \
                    and table.stats.num_partitions <= e.capacity \
                    and all(d.kind in ("append", "drop")
                            or (d.kind == "update"
                                and d.column not in columns)
                            for d in deltas):
                staging = [d for d in deltas if d.kind in ("append", "drop")]
                if staging:
                    with self.memory.transient(family, key, e.nbytes):
                        work = dataclasses.replace(
                            e, arrays=self._clone(e.arrays),
                            meta=dict(e.meta))
                        nbytes = 0
                        for d in staging:
                            if d.kind == "append":
                                nbytes += append_fn(work, table, d.part_lo,
                                                    d.part_hi)
                            else:
                                nbytes += drop_fn(work, table, d.part_ids)
                        # the stamp from the clean replayed tensors; the
                        # chaos seam may tear bytes after it
                        work.meta["checksum"] = plane_checksum(work.arrays)
                    self._settle()
                    e.meta = work.meta
                    e.arrays = self._corrupt(f"stage.{family}", work.arrays)
                    self.staged_bytes += nbytes
                    self.delta_stages += 1
                e.version = tver
                e.logical_p = table.stats.num_partitions
                served = True
        if served:
            self.plane_hits += 1
            store.move_to_end(key)
            self._touch(family, key)
            if not self._verify_due() or self._verify(e.arrays,
                                                      e.meta.get("checksum")):
                self._hold(e.arrays)
                return e
            # torn resident plane: quarantine; the caller stages fresh
            # (and _plane_fresh force-verifies that restage)
            self._quarantine(family, key)
            return None
        del store[key]
        self.memory.release(family, key)
        self.full_restages += 1
        return None

    def _plane_fresh(self, family: str, store: "OrderedDict", key: Tuple,
                     build_fn) -> _PlaneEntry:
        """Stage a fresh plane with the integrity protocol: stamp from the
        built arrays, move the host (numpy) ones to the device, admit, and
        force-verify whenever the key was just quarantined or was ever
        budget-evicted; a verify failure quarantines and rebuilds once, a
        second failure raises ``PlaneIntegrityError`` (the serving ladder
        demotes past it).  Tensors a build returns stay where they are:
        the tree family's coarse level is a host tensor."""
        retried = False
        while True:
            self._fire(f"stage.{family}")
            e = build_fn()
            # stamped from the built arrays (the host arrays pre-H2D: free
            # at stage time)
            e.meta["checksum"] = plane_checksum(e.arrays)
            e.arrays = self._corrupt(f"stage.{family}", tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                if isinstance(a, np.ndarray) else a for a in e.arrays))
            self._settle()
            e = self._plane_put(family, store, key, e)
            fk = (family, key)
            force = fk in self._quarantined \
                or self.memory.was_evicted(family, key) \
                or self._verify_due()
            if not force or self._verify(e.arrays, e.meta["checksum"]):
                self._quarantined.discard(fk)
                self._hold(e.arrays)
                return e
            if retried:
                self._quarantined.discard(fk)
                store.pop(key, None)
                self.memory.release(family, key)
                raise PlaneIntegrityError(
                    f"{family} plane {key} failed checksum verification "
                    f"after quarantine restage")
            self._quarantine(family, key)
            retried = True

    def _plane_put(self, family: str, store: "OrderedDict", key: Tuple,
                   entry: _PlaneEntry) -> _PlaneEntry:
        self.plane_misses += 1
        self.staged_bytes += entry.nbytes
        self._admit(family, key, entry.nbytes)
        store[key] = entry
        if self.memory.budget_bytes is None:
            while len(store) > MAX_PLANES:
                k, _ = store.popitem(last=False)
                self.memory.release(family, k)
        return entry

    # -- join-key planes --

    @staticmethod
    def _key_rows(table, key_col: str, lo: int, hi: int):
        """Widened f32 (pmin, pmax) host rows for partitions [lo, hi),
        clamped to finite f32."""
        pmin = np.clip(round_down_f32(table.stats.col_min(key_col)[lo:hi]),
                       -_F32_MAX, _F32_MAX)
        pmax = np.clip(round_up_f32(table.stats.col_max(key_col)[lo:hi]),
                       -_F32_MAX, _F32_MAX)
        return pmin, pmax

    def _key_append(self, e: _PlaneEntry, table, lo: int, hi: int) -> int:
        rows = self._h2d(*self._key_rows(table, e.meta["col"], lo, hi))
        for a, row in zip(e.arrays, rows):
            a[lo:hi] = row
        return rows.numel() * rows.element_size()

    def _key_drop(self, e: _PlaneEntry, table, part_ids) -> int:
        ids = self._ids(part_ids)
        pmin, pmax = e.arrays
        pmin.index_fill_(0, ids, float(_F32_MAX))
        pmax.index_fill_(0, ids, -float(_F32_MAX))
        return 2 * len(part_ids) * 4

    def join_key_plane(self, table, key_col: str) -> Tuple:
        """The key column's resident (pmin, pmax) [cap] f32 rows (widened).

        Staged once per (table identity, column) and delta-synced on table
        DML; consumed by the batched join-overlap kernel.  Clamped to
        finite f32 like the [C, cap] planes, so +inf distinct-key padding
        can never produce a hit; dropped partitions and capacity slots
        hold the sentinel (+f32max, -f32max) — never a hit either.
        """
        with self._lock:
            self._fire("get.join_key")
            key = (table.name, table.stats.uid, key_col)
            e = self._plane_current("join_key", self.key_planes, key, table,
                                    (key_col,), self._key_append,
                                    self._key_drop)
            if e is not None:
                return e.arrays

            def build():
                P = table.stats.num_partitions
                cap = plane_capacity(P)
                pmin = np.full(cap, _F32_MAX, dtype=np.float32)
                pmax = np.full(cap, -_F32_MAX, dtype=np.float32)
                pmin[:P], pmax[:P] = self._key_rows(table, key_col, 0, P)
                return _PlaneEntry(self._table_version(table), P,
                                   (pmin, pmax), meta=dict(col=key_col))

            return self._plane_fresh("join_key", self.key_planes, key,
                                     build).arrays

    # -- enumeration planes --

    def enum_plane(self, table, key_col: str) -> Tuple:
        """The key column's resident enumeration rows:
        (pmin, width, wmax, domain_ok).

        pmin/width are [cap] int32 device rows feeding the Bloom probe
        kernel's narrow-range enumeration: integer-snapped partition
        minima (``ceil(col_min)``) and candidate counts
        (``floor(col_max) - ceil(col_min) + 1``, compared in float64
        before any integer cast so extreme ranges can't overflow).
        width 0 marks partitions that must never be enumerated — empty
        interval, non-finite bounds, or outside int32 (the kernel hashes
        int32 candidates) — and means *keep*: skipping enumeration can
        only miss prunable partitions, never prune joinable ones.  wmax
        (host int) is the plane's max width.  domain_ok (host bool)
        records whether every non-empty partition's bounds sit inside
        int32 — the device-vs-host parity gate
        (``PruningService.join_device_eligible``), computed once here so
        eligibility never rescans [P] stats per query.  Width 0 is also
        the drop/capacity sentinel.  Delta-synced like the join-key plane.
        """
        with self._lock:
            self._fire("get.enum")
            key = (table.name, table.stats.uid, key_col)
            e = self._plane_current("enum", self.enum_planes, key, table,
                                    (key_col,), self._enum_append,
                                    self._enum_drop)
            if e is not None:
                return e.arrays + (e.meta["wmax"], e.meta["domain_ok"])

            def build():
                P = table.stats.num_partitions
                cap = plane_capacity(P)
                pmin_h, width_h, wmax, domain_ok = self._enum_rows(table,
                                                                   key_col)
                pmin = np.zeros(cap, dtype=np.int32)
                width = np.zeros(cap, dtype=np.int32)
                pmin[:P], width[:P] = pmin_h, width_h
                return _PlaneEntry(self._table_version(table), P,
                                   (pmin, width),
                                   meta=dict(col=key_col, wmax=wmax,
                                             domain_ok=domain_ok))

            e = self._plane_fresh("enum", self.enum_planes, key, build)
            return e.arrays + (e.meta["wmax"], e.meta["domain_ok"])

    @staticmethod
    def _enum_rows(table, key_col: str):
        """Host enumeration rows over all partitions:
        (pmin i32 [P], width i32 [P], wmax, domain_ok) — an exact
        recompute shared by fresh staging and delta replay (the replay
        stages only the changed slices but refreshes wmax / domain_ok
        exactly, so it picks the same route as a fresh stage).  A dropped
        partition's stats are the empty interval, so its width is 0."""
        lo = np.ceil(np.asarray(table.stats.col_min(key_col), np.float64))
        hi = np.floor(np.asarray(table.stats.col_max(key_col), np.float64))
        with np.errstate(invalid="ignore", over="ignore"):
            wf = hi - lo + 1.0
            in32 = (lo >= -2.0 ** 31) & (hi < 2.0 ** 31)
            live = np.isfinite(lo) & np.isfinite(hi) & (lo <= hi)
            ok = live & in32 & (wf > 0) & (wf < 2.0 ** 31)
        domain_ok = not bool(np.any(live & ~in32))
        pmin = np.where(ok, lo, 0.0).astype(np.int32)
        width = np.where(ok, wf, 0.0).astype(np.int32)
        wmax = int(width.max()) if width.size else 0
        return pmin, width, wmax, domain_ok

    def _enum_append(self, e: _PlaneEntry, table, lo: int, hi: int) -> int:
        pmin_h, width_h, wmax, domain_ok = self._enum_rows(table,
                                                           e.meta["col"])
        rows = self._h2d(pmin_h[lo:hi], width_h[lo:hi])
        for a, row in zip(e.arrays, rows):
            a[lo:hi] = row
        e.meta.update(wmax=wmax, domain_ok=domain_ok)
        return 2 * (hi - lo) * 4

    def _enum_drop(self, e: _PlaneEntry, table, part_ids) -> int:
        ids = self._ids(part_ids)
        for a in e.arrays:
            a.index_fill_(0, ids, 0)
        _pmin, _width, wmax, domain_ok = self._enum_rows(table,
                                                         e.meta["col"])
        e.meta.update(wmax=wmax, domain_ok=domain_ok)
        return 2 * len(part_ids) * 4

    # -- block-top-k planes --

    def block_topk_plane(self, table, order_col: str,
                         desc: bool) -> torch.Tensor:
        """The column's resident [cap, KPLANE] signed block-top-k rows.

        Row p holds partition p's KPLANE largest ``sign * value`` entries
        (desc per row, -inf padded, nulls excluded).  Values are rounded
        toward -inf in the signed domain, so every stored entry is <= the
        true value of an actual non-null row — any boundary taken from
        these rows is a *witnessed* Sec. 5.4 boundary.  Delta-synced; an
        update of ``order_col`` itself restages it in full.
        """
        with self._lock:
            self._fire("get.block_topk")
            key = (table.name, table.stats.uid, order_col, bool(desc))
            e = self._plane_current("block_topk", self.topk_planes, key,
                                    table, (order_col,), self._topk_append,
                                    self._topk_drop)
            if e is not None:
                return e.arrays[0]

            def build():
                P = table.stats.num_partitions
                cap = plane_capacity(P)
                rows = np.full((cap, KPLANE), -np.inf, dtype=np.float32)
                rows[:P] = self._topk_rows(table, order_col, bool(desc),
                                           0, P)
                return _PlaneEntry(self._table_version(table), P, (rows,),
                                   meta=dict(col=order_col,
                                             desc=bool(desc)))

            return self._plane_fresh("block_topk", self.topk_planes, key,
                                     build).arrays[0]

    @staticmethod
    def _topk_rows(table, order_col: str, desc: bool, lo: int,
                   hi: int) -> np.ndarray:
        """Signed block-top-k host rows for partitions [lo, hi), from
        those partitions' rows only.

        Rows of dropped partitions are all -inf (the no-contribution
        sentinel): their tombstoned data rows must never witness a
        boundary, and a fresh stage gives the same rows as the delta
        path's sentinel scatter.
        """
        from ..kernels.ops import build_block_topk  # lazy: ops imports us
        bounds = np.asarray(table.part_bounds[lo:hi + 1], dtype=np.int64)
        r0, r1 = int(bounds[0]), int(bounds[-1])
        sign = 1.0 if desc else -1.0
        sv = round_down_f32(sign * np.asarray(table.data[order_col][r0:r1],
                                              dtype=np.float64))
        nm = table.nulls.get(order_col)
        mask = None if nm is None else ~np.asarray(nm[r0:r1], dtype=bool)
        live = getattr(table, "live", None)
        if live is not None:
            live_rows = np.repeat(np.asarray(live[lo:hi], dtype=bool),
                                  np.diff(bounds))
            mask = live_rows if mask is None else (mask & live_rows)
        return build_block_topk(sv, bounds - r0, KPLANE, mask=mask)

    def _topk_append(self, e: _PlaneEntry, table, lo: int, hi: int) -> int:
        new = self._topk_rows(table, e.meta["col"], e.meta["desc"], lo, hi)
        (rows,) = e.arrays
        rows[lo:hi] = torch.from_numpy(new).to(self.device)
        return int(new.nbytes)

    def _topk_drop(self, e: _PlaneEntry, table, part_ids) -> int:
        (rows,) = e.arrays
        rows.index_fill_(0, self._ids(part_ids), float("-inf"))
        return len(part_ids) * int(rows.shape[1]) * 4

    # -- hierarchical (tree) planes --

    def _tree_replay(self, e: _PlaneEntry, table, dstats: DeviceStats,
                     deltas) -> Optional[int]:
        """Re-aggregate only the dirtied groups from the flat planes of
        ``dstats`` into a clone of the group arrays; returns the new
        arrays and the staged bytes, or None (having written nothing)
        when a full rebuild is required (a rewrite, an unknown kind or
        column).

        ``dstats`` reflects every delta in ``deltas``, so the group hulls
        re-derive on the device with no H2D of plane data:
        appends dirty only the touched tail groups, drops only the dropped
        ids' groups, and a column update re-aggregates that column's group
        row.  The host coarse level re-derives from the group arrays
        afterwards (one small copy back).
        """
        fanout = e.meta["fanout"]
        C, G = (int(n) for n in e.arrays[0].shape)
        mins, maxs, dem = dstats.planes
        dirty: set = set()
        rows: set = set()
        for d in deltas:
            if d.kind == "append":
                dirty.update(range(d.part_lo // fanout,
                                   (max(d.part_hi, d.part_lo + 1) - 1)
                                   // fanout + 1))
            elif d.kind == "drop":
                dirty.update(int(p) // fanout
                             for p in np.asarray(d.part_ids).tolist())
            elif d.kind == "update" and _has_column(table.stats, d.column):
                rows.add(table.stats.col_id(d.column))
            else:                  # rewrite (or unknown): full rebuild
                return None
        gm, gx, gd = self._clone(e.arrays[:3])
        nbytes = 0
        if dirty:
            gids = np.fromiter(sorted(dirty), dtype=np.int64)
            idx = (gids[:, None] * fanout
                   + np.arange(fanout)[None, :]).reshape(-1)
            jg = self._ids(gids)
            idx_d = self._ids(idx)
            n = len(gids)
            gm.index_copy_(1, jg, mins.index_select(1, idx_d)
                           .reshape(C, n, fanout).amin(dim=2))
            gx.index_copy_(1, jg, maxs.index_select(1, idx_d)
                           .reshape(C, n, fanout).amax(dim=2))
            gd.index_copy_(1, jg, dem.index_select(1, idx_d)
                           .reshape(C, n, fanout).amax(dim=2))
            nbytes += 3 * C * n * 4
        for ci in sorted(rows):
            span = slice(0, G * fanout)
            gm[ci] = mins[ci, span].reshape(G, fanout).amin(dim=1)
            gx[ci] = maxs[ci, span].reshape(G, fanout).amax(dim=1)
            gd[ci] = dem[ci, span].reshape(G, fanout).amax(dim=1)
            nbytes += 3 * G * 4
        cmins, cmaxs = coarse_from_groups(gm, gx)
        return (gm, gx, gd, cmins, cmaxs), nbytes

    def tree_plane(self, table, dstats: DeviceStats) -> _PlaneEntry:
        """The table's hierarchical plane entry at ``dstats``'s version.

        ``dstats`` is the stat entry from ``get``, frozen by the caller
        (``dataclasses.replace``): the tree arrays are pure
        aggregations of it, so delta maintenance re-aggregates dirtied
        groups from its flat planes instead of restaging from host truth,
        and the entry handed back (a snapshot too) always matches the
        flat planes the caller launches on — even when another thread
        replayed the resident planes since its ``get``.  A resident tree
        ahead of the snapshot (another thread's later ``get``) is left as
        it is, and an entry aggregated from the snapshot is handed back
        unstored.  A full member of the integrity protocol: stamped at
        build and after every replay (the stamp covers the host coarse
        level too: it takes part in pruning decisions), sampled-verified
        on read, force-verified after a quarantine or eviction restage,
        ``PlaneIntegrityError`` on a second failure (the serving ladder
        demotes to the flat rungs).  A geometry change (capacity growth,
        another fanout) rebuilds.
        """
        with self._lock:
            self._fire("get.tree_stat")
            key = (table.name, table.stats.uid)
            fanout = self.tree_fanout
            tver = dstats.version
            e = self.tree_planes.get(key)
            if e is not None:
                served = False
                geometry_ok = (e.meta["fanout"] == fanout
                               and e.meta["cap"] == dstats.capacity)
                if geometry_ok and e.version == tver:
                    served = True
                elif geometry_ok and e.version > tver:
                    return tree_entry_for(dstats, fanout=fanout,
                                          version=tver)
                elif geometry_ok:
                    deltas = self._deltas_since(table, e.version)
                    done = None
                    if deltas is not None:
                        with self.memory.transient("tree_stat", key,
                                                   e.nbytes):
                            done = self._tree_replay(
                                e, table, dstats,
                                [d for d in deltas if d.version <= tver])
                    if done is not None:
                        arrays, nbytes = done
                        self._settle()
                        e.meta["checksum"] = plane_checksum(arrays)
                        e.arrays = self._corrupt("stage.tree_stat", arrays)
                        e.version = tver
                        e.logical_p = dstats.logical_p
                        self.staged_bytes += nbytes
                        self.delta_stages += 1
                        served = True
                if served:
                    self.plane_hits += 1
                    self.tree_planes.move_to_end(key)
                    self._touch("tree_stat", key)
                    if not self._verify_due() or self._verify(
                            e.arrays, e.meta.get("checksum")):
                        self._hold(e.arrays)
                        return dataclasses.replace(e, meta=dict(e.meta))
                    self._quarantine("tree_stat", key)
                else:
                    self.tree_planes.pop(key, None)
                    self.memory.release("tree_stat", key)
                    self.full_restages += 1

            def build():
                return tree_entry_for(dstats, fanout=fanout, version=tver)

            e = self._plane_fresh("tree_stat", self.tree_planes, key, build)
            return dataclasses.replace(e, meta=dict(e.meta))

    # ---- verdict planes (Sec. 8.2 predicate cache, device-resident) -----

    def verdict_plane(self, table, pred, ckey: str) -> Optional[np.ndarray]:
        """The cached int8 ``[P]`` verdict row for ``(table, predicate)``,
        brought current, as a host copy — or None on a miss (the caller
        launches the ordinary kernel chain and ``verdict_record``s the
        result).

        ``ckey`` is the canonical predicate key (``expr.canonical_key``),
        so syntactic variants of one predicate share a row.  A full
        member of the integrity protocol: stamped at record and after
        every delta repair, sampled-verified on read (a torn row is
        quarantined and misses — it is never served), force-verified on
        the restage, ``PlaneIntegrityError`` on a second failure (the
        serving ladder demotes to the kernel chain).

        Delta repair from the table's ``TableDelta`` log, written into a
        clone of the resident row that is then swapped in (a hit copying
        the old row reads it whole): an append's partitions are the only
        unknown slots — their verdicts are evaluated on the host (f64 ``eval_tv``
        over just the ``[part_lo, part_hi)`` stats slice) and written by
        index assignment, counted in ``integrity["verdict_repairs"]``; a
        drop scatters the NO_MATCH sentinel; an update of a column the
        predicate does not read costs nothing; an update of one it reads,
        a rewrite, a log gap or a capacity overflow drops the entry (a
        miss).
        """
        with self._lock:
            def repair(e, table, lo, hi):
                patch = eval_tv(pred, table.stats.select(np.arange(lo, hi)))
                e.arrays[0][lo:hi] = torch.from_numpy(
                    np.asarray(patch, dtype=np.int8)).to(self.device)
                self.integrity["verdict_repairs"] += 1
                return hi - lo

            def tombstone(e, table, part_ids):
                e.arrays[0].index_fill_(0, self._ids(part_ids), NO_MATCH)
                return len(part_ids)

            self._fire("get.verdict")
            e = self._plane_current(
                "verdict", self.verdict_planes,
                (table.name, table.stats.uid, ckey), table,
                tuple(pred.columns()), repair, tombstone)
            if e is None:
                return None
            # a copy, never a view: on the CPU ``to_host`` would alias the
            # resident row
            return np.array(to_host(e.arrays[0][:e.logical_p]),
                            dtype=np.int8)

    def verdict_record(self, table, pred, ckey: str,
                       tv_row: np.ndarray) -> None:
        """Stage a freshly computed verdict row as a resident plane.

        ``tv_row`` is the int8 ``[P]`` three-valued result of a ladder
        rung above passthrough (passthrough verdicts are uncertified and
        never recorded).  Capacity-padded with the NO_MATCH sentinel like
        every delta-synced family, so appended partitions are repaired
        into the row's next copy.
        """
        with self._lock:
            key = (table.name, table.stats.uid, ckey)
            P = table.stats.num_partitions
            row = np.full(plane_capacity(P), NO_MATCH, dtype=np.int8)
            row[:P] = np.asarray(tv_row, dtype=np.int8)
            cols = tuple(pred.columns()) if pred is not None else ()

            def build():
                return _PlaneEntry(self._table_version(table), P, (row,),
                                   meta=dict(cols=cols))

            self._plane_fresh("verdict", self.verdict_planes, key, build)

    # ---- invalidation and the DML hooks ----------------------------------

    def invalidate(self, table_name: str, column: Optional[str] = None
                   ) -> None:
        """Drop staged planes for a table.

        ``column=None`` drops everything (insert/delete semantics); a
        column drops the [C, P] planes and the tree planes (they carry
        every column) plus only that column's join-key / enumeration /
        block-top-k planes and the verdict rows of the predicates that
        read it (a verdict key names a predicate, not a column).
        """
        with self._lock:
            for family, store in (("stat", self.entries),
                                  ("tree_stat", self.tree_planes)):
                for k in [k for k in store if k[0] == table_name]:
                    del store[k]
                    self.memory.release(family, k)
            for family, store in (("join_key", self.key_planes),
                                  ("enum", self.enum_planes),
                                  ("block_topk", self.topk_planes)):
                stale = [k for k in store
                         if k[0] == table_name
                         and (column is None or k[2] == column)]
                for k in stale:
                    del store[k]
                    self.memory.release(family, k)
            stale = [k for k, e in self.verdict_planes.items()
                     if k[0] == table_name
                     and (column is None or column in e.meta["cols"])]
            for k in stale:
                del self.verdict_planes[k]
                self.memory.release("verdict", k)

    # Legacy DML hooks (a mutation made without the table's own DML
    # methods, so without a delta log): every mutation invalidates.
    def on_insert(self, table_name: str) -> None:
        self.invalidate(table_name)

    def on_delete(self, table_name: str) -> None:
        self.invalidate(table_name)

    def on_update(self, table_name: str, column: str) -> None:
        # Updates are column-scoped: the [C, P] stat planes restage (they
        # include the updated column), while the other columns' join-key /
        # enumeration / block-top-k planes stay resident.
        self.invalidate(table_name, column=column)

    @property
    def hit_rate(self) -> float:
        """The ``[C, cap]`` stat planes' getter hit rate (``get``: hits
        over hits + misses), the reference's meaning; the other families'
        rate is ``plane_hits`` over ``plane_hits + plane_misses``, and the
        budget's is ``memory.hits`` over its hits + misses."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for store in self._stores.values()
                       for e in store.values())
