"""The JOIN's Bloom summary, rebuilt from the build keys by its published
layout (the configuration's ``guarantees.join_bloom``).

A blocked Bloom filter: 512-bit blocks of sixteen 32-bit words, a power of
two of them, at least ``bits_per_key`` bits a distinct key; four probe bits
a key, all in the key's block.  A key is folded to 32 bits (low word XOR
the mixed high word, mixed again: the Murmur3 finaliser); the block is the
low bits of that hash, the words and bits come from two further mixes, one
byte a probe.  A probe partition whose integer key range holds at most
``enum_limit`` values is kept only if one of them hits the filter; a wider
one is kept whenever it overlaps the keys' range.
"""

from __future__ import annotations

import numpy as np

BLOCK_WORDS = 16
PROBES = 4


def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _coords(keys: np.ndarray, n_blocks: int):
    k = keys.astype(np.int64)
    lo = (k & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = ((k >> np.int64(32)) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    h0 = _mix32(lo ^ _mix32(hi))
    h1 = _mix32(h0 ^ np.uint32(0x9E3779B9))
    h2 = _mix32(h1 ^ np.uint32(0x7F4A7C15))
    base = (h0 & np.uint32(n_blocks - 1)).astype(np.int64) * BLOCK_WORDS
    word = [base + ((h1 >> np.uint32(8 * i)) & np.uint32(BLOCK_WORDS - 1))
            .astype(np.int64) for i in range(PROBES)]
    bit = [(h2 >> np.uint32(8 * i)) & np.uint32(31) for i in range(PROBES)]
    return word, bit


class Bloom:
    """The summary of a sorted array of distinct integer keys."""

    def __init__(self, keys: np.ndarray, bits_per_key: int):
        n_blocks = 1
        while n_blocks * BLOCK_WORDS * 32 < max(len(keys), 1) * bits_per_key:
            n_blocks *= 2
        self.n_blocks = n_blocks
        self.words = np.zeros(n_blocks * BLOCK_WORDS, dtype=np.uint32)
        word, bit = _coords(keys, n_blocks)
        for w, b in zip(word, bit):
            np.bitwise_or.at(self.words, w, np.uint32(1) << b)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        word, bit = _coords(keys, self.n_blocks)
        ok = np.ones(len(keys), dtype=bool)
        for w, b in zip(word, bit):
            ok &= ((self.words[w] >> b) & np.uint32(1)) == 1
        return ok


def bloom_keep(keys: np.ndarray, pmin: np.ndarray, pmax: np.ndarray,
               in_range: np.ndarray, integer: bool, bits_per_key: int,
               enum_limit: int) -> np.ndarray:
    """bool [P]: the probe partitions the Bloom summary of ``keys`` keeps
    (a float key column is never enumerated)."""
    if not integer:
        return in_range.copy()
    bloom = Bloom(keys, bits_per_key)
    width = pmax - pmin + 1.0
    narrow = np.flatnonzero(in_range & (width > 0) & (width <= enum_limit))
    keep = in_range.copy()
    for lo in range(0, len(narrow), 4096):
        idx = narrow[lo:lo + 4096]
        w = width[idx].astype(np.int64)
        cand = pmin[idx, None].astype(np.int64) + np.arange(enum_limit)
        valid = np.arange(enum_limit)[None, :] < w[:, None]
        hit = bloom.contains(cand.reshape(-1)).reshape(cand.shape)
        keep[idx[~(hit & valid).any(axis=1)]] = False
    return keep
