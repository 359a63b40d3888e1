"""Plain PyTorch versions of the port's kernels (no custom kernels).

Each function computes the same contract as its hand-written kernel with
ordinary tensor ops, on any device.  The CPU path of the port runs them,
the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.prune_join import BLOCK_WORDS, K_PROBES


def minmax_prune_batched_ref(cids, lo, hi, mins, maxs, demote,
                             num_partitions: Optional[int] = None
                             ) -> torch.Tensor:
    """tv [Q, P] int8 for Q queries of Kb ranges over resident [C, Pc] stats.

    Per-constraint stat rows are gathered from the planes by column id;
    ``(-inf, +inf)`` constraints are padding no-ops (tv=2, the AND
    identity).  ``num_partitions`` (default: every plane column) keeps the
    first P columns of the capacity.  The K loop keeps peak memory
    O(Q*P), never O(Q*K*P).
    """
    Q, Kb = lo.shape
    P = int(mins.shape[1]) if num_partitions is None else int(num_partitions)
    mins, maxs, demote = mins[:, :P], maxs[:, :P], demote[:, :P]
    tv = torch.full((Q, P), 2, dtype=torch.int8, device=mins.device)
    cids = cids.long()
    for k in range(Kb):
        pmin = mins.index_select(0, cids[:, k])          # [Q, P]
        pmax = maxs.index_select(0, cids[:, k])
        pdem = demote.index_select(0, cids[:, k])
        lo_k = lo[:, k, None]
        hi_k = hi[:, k, None]
        empty = pmin > pmax
        no = (pmax < lo_k) | (pmin > hi_k) | empty
        full = (pmin >= lo_k) & (pmax <= hi_k) & (pdem == 0.0) & ~empty
        tv_k = torch.where(no, 0, torch.where(full, 2, 1)).to(torch.int8)
        noop = (lo_k == float("-inf")) & (hi_k == float("inf"))
        tv_k = torch.where(noop, torch.full_like(tv_k, 2), tv_k)
        tv = torch.minimum(tv, tv_k)
    return tv


# ---------------------------------------------------------------------------
# JOIN: distinct-key overlap and blocked-Bloom enumeration
# ---------------------------------------------------------------------------

# Slab sizes of the plain versions over P: elements of a [Q, slab] search
# state, and candidates enumerated at once.
JOIN_SLAB_ELEMS = 1 << 24
BLOOM_SLAB_CANDIDATES = 1 << 21

def join_overlap_batched_ref(dist, pmin, pmax,
                             num_partitions: Optional[int] = None
                             ) -> torch.Tensor:
    """hit [Q, P] int8: 1 iff some key of query q lies in [pmin, pmax].

    ``dist`` is [Q, Db] f32, each row sorted non-decreasing and +inf
    padded; ``pmin``/``pmax`` are the [Pc] join-key plane rows (finite),
    of which the first ``num_partitions`` (default: all) are evaluated.
    The kernel's arithmetic in plain tensor ops: a binary search (binary
    lifting over all partitions at once) for the number of keys below
    ``pmin``, then that next key against ``pmax``.
    """
    Q, Db = dist.shape
    P = int(pmin.shape[0]) if num_partitions is None else int(num_partitions)
    hit = torch.zeros((Q, P), dtype=torch.int8, device=pmin.device)
    if Q == 0 or P == 0:
        return hit
    top = 1 << (Db.bit_length() - 1)
    slab = max(1, JOIN_SLAB_ELEMS // Q)
    for s in range(0, P, slab):
        e = min(s + slab, P)
        lo = pmin[s:e].unsqueeze(0).expand(Q, e - s)
        first = torch.zeros((Q, e - s), dtype=torch.int64, device=pmin.device)
        step = top
        while step:
            nxt = first + step
            below = torch.gather(dist, 1, (nxt - 1).clamp(max=Db - 1)) < lo
            first = torch.where((nxt <= Db) & below, nxt, first)
            step >>= 1
        key = torch.gather(dist, 1, first.clamp(max=Db - 1))
        hit[:, s:e] = ((first < Db) & (key <= pmax[s:e])).to(torch.int8)
    return hit


MIX_C1 = 0x85EBCA6B
MIX_C2 = 0xC2B2AE35
H1_SALT = 0x9E3779B9
H2_SALT = 0x7F4A7C15
U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 words held in int64, in two 16-bit
    halves of ``c`` so no product leaves int64's range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & U32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on uint32 words held in int64 tensors:
    bit-identical to ``core.prune_join._mix32`` and the CUDA kernel's."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, MIX_C2)
    return x ^ (x >> 16)


def bloom_slabs(words, pmin, width, num_partitions: Optional[int] = None):
    """The Bloom plain version's candidate enumeration, slab by slab.

    ``words`` is [Q, Bb * 16] int32 holding each filter's uint32 words
    (tiled to the common power-of-two block count Bb); ``pmin``/``width``
    are the [Pc] int32 enumeration rows, of which the first
    ``num_partitions`` (default: all) are enumerated.  Candidates are
    enumerated ragged, each partition's own width, over partition slabs
    that keep a slab's candidates near ``BLOOM_SLAB_CANDIDATES``, and
    hashed once per slab for every query.  Yields, for each slab [s, e)
    holding candidates, ``(s, e, w, seg, j, passes)``: the slab's widths
    ``w`` (int64), each candidate's partition ``seg`` within the slab and
    offset ``j`` from its ``pmin``, and ``passes(q)``, the bool mask of the
    candidates that pass all four probes of query q's filter.
    """
    Q, W = words.shape
    n_blocks = W // BLOCK_WORDS
    P = int(pmin.shape[0]) if num_partitions is None else int(num_partitions)
    dev = pmin.device
    if Q == 0 or P == 0:
        return
    w64 = words.to(torch.int64) & U32
    wmax = int(width[:P].max().item())
    if wmax <= 0:
        return
    slab = max(1, BLOOM_SLAB_CANDIDATES // wmax)
    for s in range(0, P, slab):
        e = min(s + slab, P)
        w = width[s:e].to(torch.int64).clamp(min=0)
        total = int(w.sum().item())
        if total == 0:
            continue
        starts = torch.cumsum(w, 0) - w
        seg = torch.repeat_interleave(torch.arange(e - s, device=dev), w)
        j = torch.arange(total, device=dev) - starts[seg]
        c = pmin[s:e].to(torch.int64)[seg] + j           # int32-range values
        hi_word = torch.where(c < 0, U32, 0)
        h0 = mix32((c & U32) ^ mix32(hi_word))
        h1 = mix32(h0 ^ H1_SALT)
        h2 = mix32(h1 ^ H2_SALT)
        base = (h0 & (n_blocks - 1)) * BLOCK_WORDS
        idx = [base + ((h1 >> (8 * i)) & (BLOCK_WORDS - 1))
               for i in range(K_PROBES)]
        bit = [(h2 >> (8 * i)) & 31 for i in range(K_PROBES)]

        def passes(q, idx=idx, bit=bit, total=total):
            ok = torch.ones(total, dtype=torch.bool, device=dev)
            for i in range(K_PROBES):
                ok &= ((w64[q][idx[i]] >> bit[i]) & 1) == 1
            return ok

        yield s, e, w, seg, j, passes


def bloom_probe_batched_ref(words, pmin, width,
                            num_partitions: Optional[int] = None
                            ) -> torch.Tensor:
    """hit [Q, P] int8 for Q blocked-Bloom filters vs the enumeration plane
    (inputs as in ``bloom_slabs``): 1 where width is 0, else iff some
    candidate ``pmin + j`` (j < width) passes all four probes of the
    query's filter."""
    Q = int(words.shape[0])
    P = int(pmin.shape[0]) if num_partitions is None else int(num_partitions)
    dev = pmin.device
    hit = torch.ones((Q, P), dtype=torch.int8, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    for s, e, w, _seg, _j, passes in bloom_slabs(words, pmin, width, P):
        ends = torch.cumsum(w, 0)
        starts = ends - w
        enum = w > 0
        for q in range(Q):
            cs = torch.cat([zero, torch.cumsum(passes(q).to(torch.int64), 0)])
            any_hit = (cs[ends] - cs[starts]) > 0
            hit[q, s:e] = torch.where(enum, any_hit, True).to(torch.int8)
    return hit


# ---------------------------------------------------------------------------
# top-k: boundary initialisation over the block-top-k plane
# ---------------------------------------------------------------------------

def topk_init_batched_ref(plane, offsets, ids, k: int) -> torch.Tensor:
    """heap [Q, k] f32: per query the k largest values among the rows of
    its candidate partitions ``ids[offsets[q]:offsets[q + 1]]`` of the
    [Pc, K] block-top-k plane (rows sorted descending, -inf padded, no
    NaN); descending, -inf padded.

    Rows are sorted, so with at least k candidate rows the k-th largest
    row head ``t`` is a lower bound of the answer's k-th value: only the
    values >= t of rows whose head is >= t are gathered and sorted.
    """
    Q = int(offsets.shape[0]) - 1
    dev = plane.device
    heap = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=dev)
    off = offsets.tolist()
    for q in range(Q):
        rid = ids[off[q]:off[q + 1]].to(torch.int64)
        if rid.numel() == 0:
            continue
        head = plane[rid, 0]
        t = float("-inf")
        if rid.numel() >= k:
            t = float(torch.sort(head, descending=True).values[k - 1])
        keep = head >= t if t > float("-inf") else head > t
        vals = plane[rid[keep]].reshape(-1)
        vals = vals[vals >= t] if t > float("-inf") else vals[vals > t]
        top = torch.sort(vals, descending=True).values[:k]
        heap[q, :top.numel()] = top
    return heap
