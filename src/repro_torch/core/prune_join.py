"""JOIN pruning: coarse-grained sideways information passing (paper Sec. 6).

Four steps, exactly the paper's:
  (1) summarize the build side's join-key values during the build phase,
  (2) ship the summary to the probe side (size-bounded — it crosses the
      network in a distributed setting),
  (3) match the summary against probe-side partitions' min/max metadata,
  (4) prune partitions that provably contain no joinable tuples.

Summary structure ("balance between accuracy and storage cost"):
  * global min/max of the build keys — free, prunes by range overlap;
  * if the build NDV is small, the exact sorted distinct-value set;
  * otherwise a *blocked Bloom filter* (512-bit blocks = 16 x int32 words,
    4 probe bits), which additionally prunes narrow-range partitions by
    enumerating their possible integer/dictionary-code values against the
    filter.  Enumeration is only sound on integer-domain columns (int /
    dictionary codes): fractional keys are invisible to the integer
    enumeration, so float key columns skip it (skip = keep, never prune).
    Blocked layout + 32-bit mixing keeps every probe plain uint32
    arithmetic — ``kernels/bloom_probe.py`` runs the same enumeration
    batched (Q filters x P partitions) on the GPU against the resident
    enumeration plane, and ``prune_probe`` accepts its result via
    ``bloom_hit`` exactly like ``distinct_hit``.

The technique is probabilistic in the paper's sense: it may *miss* a
prunable partition (Bloom false positives) but never prunes a partition
containing joinable rows — hypothesis tests assert exactly this.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .metadata import PartitionStats, ScanSet

BLOCK_WORDS = 16          # 16 x 32-bit words = 512-bit blocks
K_PROBES = 4
DEFAULT_ENUM_LIMIT = 1024  # max values enumerated per narrow partition


def _mix32(x: np.ndarray) -> np.ndarray:
    """Murmur3 finalizer — the shared 32-bit mixer (numpy, torch, CUDA)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _fold_key(keys: np.ndarray) -> np.ndarray:
    """int64-domain keys -> uint32 hash seed."""
    k = keys.astype(np.int64)
    lo = (k & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = ((k >> np.int64(32)) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    return _mix32(lo ^ _mix32(hi))


def _probe_coords(keys: np.ndarray, n_blocks: int):
    """(block, word[4], bit[4]) coordinates for each key."""
    h0 = _fold_key(keys)
    block = h0 & np.uint32(n_blocks - 1)
    h1 = _mix32(h0 ^ np.uint32(0x9E3779B9))
    h2 = _mix32(h1 ^ np.uint32(0x7F4A7C15))
    words = np.stack([(h1 >> np.uint32(8 * i)) & np.uint32(BLOCK_WORDS - 1)
                      for i in range(K_PROBES)], axis=-1)
    bits = np.stack([(h2 >> np.uint32(8 * i)) & np.uint32(31)
                     for i in range(K_PROBES)], axis=-1)
    return block, words, bits


def bloom_blocks(n_keys: int, bits_per_key: int = 16) -> int:
    """The filter's block count for ``n_keys`` distinct keys: the least
    power of two whose blocks hold ``bits_per_key`` bits a key."""
    want_bits = max(n_keys, 1) * bits_per_key
    n_blocks = 1
    while n_blocks * BLOCK_WORDS * 32 < want_bits:
        n_blocks *= 2
    return n_blocks


class BlockedBloom:
    """Register-blocked Bloom filter over int-domain keys."""

    def __init__(self, n_keys: int, bits_per_key: int = 16):
        self.n_blocks = bloom_blocks(n_keys, bits_per_key)
        self.words = np.zeros(self.n_blocks * BLOCK_WORDS, dtype=np.uint32)

    @classmethod
    def from_words(cls, words: np.ndarray) -> "BlockedBloom":
        """A filter around words built elsewhere (the card's summary)."""
        bloom = cls.__new__(cls)
        bloom.words = np.asarray(words, dtype=np.uint32)
        bloom.n_blocks = bloom.words.size // BLOCK_WORDS
        return bloom

    @property
    def size_bytes(self) -> int:
        return self.words.nbytes

    def add(self, keys: np.ndarray) -> None:
        block, words, bits = _probe_coords(keys, self.n_blocks)
        for i in range(K_PROBES):
            idx = block * np.uint32(BLOCK_WORDS) + words[:, i]
            np.bitwise_or.at(self.words, idx.astype(np.int64),
                             np.uint32(1) << bits[:, i])

    def contains(self, keys: np.ndarray) -> np.ndarray:
        block, words, bits = _probe_coords(keys, self.n_blocks)
        ok = np.ones(len(keys), dtype=bool)
        for i in range(K_PROBES):
            idx = (block * np.uint32(BLOCK_WORDS) + words[:, i]).astype(np.int64)
            ok &= (self.words[idx] >> bits[:, i]) & np.uint32(1) == 1
        return ok


@dataclasses.dataclass
class BuildSummary:
    """What ships from build to probe side (step 2)."""

    min: float
    max: float
    count: int
    distinct: Optional[np.ndarray]      # sorted distinct keys, if NDV small
    bloom: Optional[BlockedBloom]
    size_bytes: int

    @property
    def empty(self) -> bool:
        return self.count == 0


def summarize_build(
    keys: np.ndarray,
    null_mask: Optional[np.ndarray] = None,
    ndv_limit: int = 4096,
    bits_per_key: int = 16,
) -> BuildSummary:
    """Step 1: summarize build-side join-key values (nulls never join)."""
    if null_mask is not None:
        keys = keys[~null_mask]
    if keys.size == 0:
        # The empty distinct set keeps the key column's dtype: callers
        # (device eligibility, np.isin masks) see the real key domain, not
        # an accidental float64.
        return BuildSummary(np.inf, -np.inf, 0,
                            np.zeros(0, dtype=keys.dtype), None, 16)
    uniq = np.unique(keys)
    if uniq.size <= ndv_limit:
        return BuildSummary(
            float(uniq[0]), float(uniq[-1]), int(keys.size),
            uniq, None, int(uniq.nbytes) + 16,
        )
    bloom = BlockedBloom(uniq.size, bits_per_key)
    bloom.add(uniq)
    return BuildSummary(
        float(uniq[0]), float(uniq[-1]), int(keys.size),
        None, bloom, bloom.size_bytes + 16,
    )


@dataclasses.dataclass
class JoinPruneResult:
    scan: ScanSet
    pruned_by_range: int
    pruned_by_distinct: int
    pruned_by_bloom: int
    partitions_before: int
    partitions_after: int


def prune_probe(
    scan: ScanSet,
    stats: PartitionStats,
    key_col: str,
    summary: BuildSummary,
    enum_limit: int = DEFAULT_ENUM_LIMIT,
    distinct_hit: Optional[np.ndarray] = None,
    bloom_hit: Optional[np.ndarray] = None,
) -> JoinPruneResult:
    """Steps 3+4: overlap the summary with probe partitions' min/max.

    ``distinct_hit`` injects a precomputed distinct-key overlap result
    (bool per scan entry) in place of the host searchsorted — the device
    engine computes it with the batched ``join_overlap_batched`` kernel
    over the resident join-key plane.  ``bloom_hit`` is its Bloom-summary
    analogue: the narrow-range enumeration result (bool per scan entry)
    from ``bloom_probe_batched`` over the resident enumeration plane,
    True for every non-enumerable partition.  Either injection must be
    superset-safe (never False for a partition that may hold a build key).
    """
    before = len(scan)
    pmin = stats.col_min(key_col)[scan.part_ids]
    pmax = stats.col_max(key_col)[scan.part_ids]
    empty_part = pmin > pmax  # all-null key column: no row can join

    if summary.empty:
        # Empty build side: the probe scan is eliminated entirely (the
        # paper's "13% of queries see a pruning ratio of 100%").
        return JoinPruneResult(scan.keep(np.zeros(before, dtype=bool)),
                               before, 0, 0, before, 0)

    keep = (pmax >= summary.min) & (pmin <= summary.max) & ~empty_part
    n_range = int(before - keep.sum())
    n_distinct = n_bloom = 0

    if summary.distinct is not None:
        if distinct_hit is not None:
            hit = np.asarray(distinct_hit, dtype=bool)
        else:
            d = summary.distinct
            lo = np.searchsorted(d, pmin, side="left")
            hi = np.searchsorted(d, pmax, side="right")
            hit = hi > lo
        n_distinct = int((keep & ~hit).sum())
        keep &= hit
    elif summary.bloom is not None:
        if bloom_hit is not None:
            hit = np.asarray(bloom_hit, dtype=bool)
            n_bloom = int((keep & ~hit).sum())
            keep &= hit
        elif stats.column(key_col).kind != "float":
            # Integer/dictionary domains only: fractional build keys are
            # invisible to the integer enumeration, so float columns skip
            # it entirely (skip = keep — the technique may only miss
            # prunable partitions, never prune joinable ones).  Width is
            # compared in float64 before any integer cast: int64-extreme
            # or huge-float ranges would overflow the cast (and can raise)
            # but simply aren't narrow.
            widthf = pmax - pmin + 1.0
            narrow = keep & (widthf > 0) & (widthf <= enum_limit)
            idx = np.where(narrow)[0]
            if idx.size:
                width = widthf[idx].astype(np.int64)
                cand = (pmin[idx, None].astype(np.int64)
                        + np.arange(enum_limit)[None, :])
                valid = np.arange(enum_limit)[None, :] < width[:, None]
                hits = summary.bloom.contains(
                    cand.reshape(-1)).reshape(cand.shape)
                any_hit = (hits & valid).any(axis=1)
                n_bloom = int((~any_hit).sum())
                keep[idx[~any_hit]] = False

    pruned = scan.keep(keep)
    return JoinPruneResult(pruned, n_range, n_distinct, n_bloom, before, len(pruned))
