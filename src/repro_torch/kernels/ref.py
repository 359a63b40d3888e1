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


def minmax_prune_gathered_ref(cids, lo, hi, mins, maxs, demote, pos
                              ) -> torch.Tensor:
    """tv [Q, W] int8 over per-query *gathered* plane positions.

    The tree path's survivor-restricted evaluator (it has no kernel of its
    own, on the card or the TPU): column w of row q is plane position
    ``pos[q, w]`` (an index into the partition axis of the [C, Pc]
    planes — the group planes or the leaf planes), so entry (q, w) equals
    ``minmax_prune_batched_ref(...)[q, pos[q, w]]`` bit for bit: the
    gather commutes with every elementwise step of the three-valued
    conjunction.  Duplicate or padding positions recompute the same
    verdict.
    """
    Q, Kb = lo.shape
    stride = int(mins.shape[1])
    fm, fx, fd = mins.reshape(-1), maxs.reshape(-1), demote.reshape(-1)
    pos = pos.long()
    cids = cids.long()
    tv = torch.full(pos.shape, 2, dtype=torch.int8, device=mins.device)
    for k in range(Kb):
        idx = cids[:, k, None] * stride + pos          # [Q, W] flat index
        pmin, pmax, pdem = fm[idx], fx[idx], fd[idx]
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


# Peak elements of a [K_chunk, P] intermediate of the single-query plain
# version; long conjunctions go through in chunks of constraints.
MINMAX_SLAB_ELEMS = 1 << 24


def minmax_prune_ref(lo, hi, mins, maxs, nullable) -> torch.Tensor:
    """tv [P] int32 for one conjunction of K closed ranges over [K, P]
    pre-gathered stats: NO (0) when a range misses the partition interval
    or the interval is empty, FULL (2) when every range holds it and its
    nullable flag is 0, else PARTIAL (1); constraints AND by min.  No slot
    is padding here: every row is a real constraint.  K = 0 is the empty
    conjunction, FULL everywhere."""
    K, P = mins.shape
    tv = torch.full((P,), 2, dtype=torch.int32, device=mins.device)
    step = max(1, MINMAX_SLAB_ELEMS // max(P, 1))
    for s in range(0, K, step):
        e = min(s + step, K)
        lo_k, hi_k = lo[s:e, None], hi[s:e, None]
        pmin, pmax = mins[s:e], maxs[s:e]
        empty = pmin > pmax
        no = (pmax < lo_k) | (pmin > hi_k) | empty
        full = ((pmin >= lo_k) & (pmax <= hi_k) & (nullable[s:e] == 0.0)
                & ~empty)
        tv_k = torch.where(no, 0, torch.where(full, 2, 1)).to(torch.int32)
        tv = torch.minimum(tv, tv_k.amin(dim=0))
    return tv


# ---------------------------------------------------------------------------
# JOIN: distinct-key overlap and blocked-Bloom enumeration
# ---------------------------------------------------------------------------

def join_overlap_ref(pmin, pmax, distinct) -> torch.Tensor:
    """hit [P] int32: 1 iff some key of the sorted, NaN-free ``distinct``
    [D] lies in [pmin, pmax] -- the CPU engine's searchsorted formulation:
    the keys below ``pmin`` against the keys at or below ``pmax``.  The
    empty interval (+inf, -inf) never hits."""
    lo = torch.searchsorted(distinct, pmin, side="left")
    hi = torch.searchsorted(distinct, pmax, side="right")
    return (hi > lo).to(torch.int32)


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
    The searchsorted formulation in plain tensor ops: a binary search
    (binary lifting over all partitions at once) for the number of keys
    below ``pmin``, then that next key against ``pmax``.  The CUDA
    kernel's windowed form of it is ``join_overlap_windowed_ref``.
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


# Partitions a tile of the CUDA join kernels (``csrc/join_overlap*.cu``:
# kThreads * kV), and the keys of a window they stage in shared memory:
# at least kStageMin, at most kStageKeys.
JOIN_TILE_BATCHED = 2048
JOIN_TILE_SINGLE = 1024
JOIN_STAGE_MIN = 1024
JOIN_STAGE_KEYS = 4096


def _group_bounds(pmin, pmax, group: int):
    """Each group of ``group`` consecutive partitions' [min pmin, max
    pmax], the last group padded with the empty interval (+inf, -inf); a
    NaN bound widens its group to (-inf, +inf)."""
    P = int(pmin.shape[0])
    pad = -P % group
    nan = torch.isnan(pmin) | torch.isnan(pmax)
    lo = torch.where(nan, float("-inf"), pmin)
    hi = torch.where(nan, float("inf"), pmax)
    lo = torch.nn.functional.pad(lo, (0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, pad), value=float("-inf"))
    return lo.view(-1, group).amin(1), hi.view(-1, group).amax(1)


def join_windows(keys, pmin, pmax, tile: int,
                 num_partitions: Optional[int] = None):
    """(a, b) [Q, tiles] int64: the key window of each (query, tile) --
    a = #keys < the tile's min pmin, b = #keys <= its max pmax -- for
    sorted key rows ``keys`` [Q, D] against the first ``num_partitions``
    of the interval rows.  Only keys[a:b] can hit a partition of the
    tile; b <= a is an empty window."""
    P = int(pmin.shape[0]) if num_partitions is None else int(num_partitions)
    tlo, thi = _group_bounds(pmin[:P], pmax[:P], tile)
    Q = keys.shape[0]
    a = torch.searchsorted(keys, tlo.unsqueeze(0).expand(Q, -1).contiguous())
    b = torch.searchsorted(keys, thi.unsqueeze(0).expand(Q, -1).contiguous(),
                           right=True)
    return a, b


def window_paths(a, b) -> dict:
    """How many (query, tile) windows each path of the CUDA join kernels
    takes: empty (zeros stored, no search), at most 32 keys (held in a
    warp's lanes), staged in shared memory (``JOIN_STAGE_MIN`` to
    ``JOIN_STAGE_KEYS`` keys), searched in place (the rest)."""
    m = b - a
    staged = (m >= JOIN_STAGE_MIN) & (m <= JOIN_STAGE_KEYS)
    return dict(empty=int((m <= 0).sum()),
                lanes=int(((m > 0) & (m <= 32)).sum()),
                staged=int(staged.sum()),
                in_place=int(((m > 32) & ~staged).sum()))


def join_overlap_windowed_ref(keys, pmin, pmax, tile: int,
                              warp: Optional[int] = None,
                              num_partitions: Optional[int] = None
                              ) -> torch.Tensor:
    """The CUDA join kernels' arithmetic in plain tensor ops: for sorted
    key rows ``keys`` [Q, D] (the batched kernel; hit [Q, P] int8) or one
    sorted list [D] (the single-query kernel; hit [P] int32), each tile of
    ``tile`` partitions searches only its key window (``join_windows``),
    narrowed where ``warp`` is given and the window holds fewer than
    ``JOIN_STAGE_MIN`` keys to each run of ``warp`` partitions' own
    window, by binary lifting from the window's start (the kernels' other
    searches find the same count); the first key at or above pmin is then
    tested against pmax.  Equal to
    ``join_overlap_batched_ref`` / ``join_overlap_ref`` on sorted keys
    (a key outside a group's [min pmin, max pmax] lies in no interval of
    the group); the tests hold it to both."""
    single = keys.dim() == 1
    rows = keys.unsqueeze(0) if single else keys
    Q, D = rows.shape
    P = int(pmin.shape[0]) if num_partitions is None else int(num_partitions)
    out_dtype = torch.int32 if single else torch.int8
    if Q == 0 or P == 0 or D == 0:
        return torch.zeros((P,) if single else (Q, P), dtype=out_dtype,
                           device=pmin.device)
    lo_p, hi_p = pmin[:P], pmax[:P]
    a, b = join_windows(rows, lo_p, hi_p, tile)
    # each partition's window: its tile's, narrowed to its warp's
    at = torch.arange(P, device=pmin.device)
    aw, bw = a[:, at // tile], b[:, at // tile]
    if warp is not None:
        wa, wb = join_windows(rows, lo_p, hi_p, warp)
        narrow = bw - aw < JOIN_STAGE_MIN
        aw, bw = (torch.where(narrow, wa[:, at // warp].clamp(aw, bw), aw),
                  torch.where(narrow, wb[:, at // warp].clamp(aw, bw), bw))
    cnt = (bw - aw).clamp(min=0)
    first = torch.zeros_like(cnt)
    lo = lo_p.unsqueeze(0).expand(Q, P)
    step = 1 << max(int(cnt.max()).bit_length() - 1, 0)
    while step:
        nxt = first + step
        key = torch.gather(rows, 1, (aw + nxt - 1).clamp(0, D - 1))
        first = torch.where((nxt <= cnt) & (key < lo), nxt, first)
        step >>= 1
    key = torch.gather(rows, 1, (aw + first).clamp(0, D - 1))
    hit = ((first < cnt) & (key <= hi_p.unsqueeze(0))).to(out_dtype)
    return hit[0] if single else hit


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


def bloom_bitslice_ref(words, bits: int) -> torch.Tensor:
    """The bit-sliced table of ``csrc/bloom_probe_batched.cu``'s transpose:
    [ceil(Q / bits), Bb * 16 * 32] int64, entry ``[chunk, pos * 32 + bit]``
    the mask of the chunk's queries (bit qi for query chunk * bits + qi)
    whose filter word ``pos`` (``block * 16 + w``) has ``bit`` set."""
    Q, W = words.shape
    table = torch.zeros((-(-Q // bits), W * 32), dtype=torch.int64,
                        device=words.device)
    shifts = torch.arange(32, device=words.device)
    w64 = words.to(torch.int64) & U32
    for q in range(Q):
        table[q // bits] |= (((w64[q, :, None] >> shifts) & 1).reshape(-1)
                             << (q % bits))
    return table


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


# ---------------------------------------------------------------------------
# top-k: the boundary scan over ordered block-top-k rows
# ---------------------------------------------------------------------------

# Row heads tested at once by the sequential plain version: a first chunk
# after every merge, doubled while no row merges.
TOPK_FIRST_CHUNK = 256
TOPK_MAX_CHUNK = 1 << 20


def topk_boundary_ref(rows, b_init: float) -> tuple:
    """(skip [P] int32, heap [k] f32): the sequential boundary scan.

    ``rows`` [P, k] f32 are the block-top-k rows in processing order, each
    descending and -inf padded; ``b_init`` is the upfront boundary, an f32
    value (-inf for none).  Row j, with H the heap's k-th value and the
    heap full iff H > -inf, is skipped iff
    ``row[0] < max(b_init, H if full else -inf)`` or ``full and
    row[0] <= H``; a row that is not skipped merges into the heap.

    Between two merges the heap does not change, so the skip test is one
    fixed threshold over the row heads: the scan jumps, vectorised over a
    chunk of heads, to the next row that merges.  Exact, with one step a
    merge instead of one a row.
    """
    P, k = rows.shape
    dev = rows.device
    neg = float("-inf")
    heap = torch.full((k,), neg, dtype=torch.float32, device=dev)
    skip = torch.ones(P, dtype=torch.int32, device=dev)
    heads = rows[:, 0]
    b = float(b_init)
    h_kth = neg
    pos, chunk = 0, TOPK_FIRST_CHUNK
    none = torch.ones(1, dtype=torch.bool, device=dev)   # "no merge" marker
    while pos < P:
        full = h_kth > neg
        eff = max(b, h_kth if full else neg)
        end = min(pos + chunk, P)
        seg = heads[pos:end]
        skipped = seg < eff
        if full:
            skipped |= seg <= h_kth
        # index of the first row that merges; end - pos when none does
        first = int(torch.argmax(torch.cat([~skipped, none]).to(torch.int32)))
        if first == end - pos:
            pos, chunk = end, min(2 * chunk, TOPK_MAX_CHUNK)
            continue
        j = pos + first
        skip[j] = 0
        heap = torch.sort(torch.cat([heap, rows[j]]),
                          descending=True).values[:k]
        h_kth = float(heap[k - 1])
        pos, chunk = j + 1, TOPK_FIRST_CHUNK
    return skip, heap


def topk_boundary_prefix_ref(rows, b_init: float) -> tuple:
    """(skip [P] int32, heap [k] f32): the associative prefix-merge
    formulation of the boundary scan.

    The heap before row j is taken as the top-k of every earlier row (an
    exclusive prefix top-k merge, here an inclusive Hillis-Steele scan in
    ceil(log2 P) steps, then shifted by one row), merging rows the
    sequential scan skips.  Top-k selection is associative and its values
    are one multiset whatever the merge order, so the final heap equals
    the sequential one and, with a witnessed ``b_init``, the skip mask is
    a superset of the sequential one.
    """
    P, k = rows.shape
    dev = rows.device
    neg = torch.full((1, k), float("-inf"), dtype=torch.float32, device=dev)
    if P == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), neg[0]
    inc = rows
    d = 1
    while d < P:
        merged = torch.topk(torch.cat([inc[:-d], inc[d:]], dim=1), k,
                            dim=1).values
        inc = torch.cat([inc[:d], merged])
        del merged
        d *= 2
    h_kth = torch.cat([neg, inc[:-1]])[:, k - 1]
    heap_full = h_kth > float("-inf")
    bm = rows[:, 0]
    eff = torch.maximum(torch.full_like(h_kth, float(b_init)),
                        torch.where(heap_full, h_kth, float("-inf")))
    skip = (bm < eff) | (heap_full & (bm <= h_kth))
    return skip.to(torch.int32), inc[-1].clone()


def merge_topk_stable(a, b):
    """Top-k of lists ``a`` [..., k] and ``b`` [..., k], each descending,
    by a stable sort of ``a`` then ``b``: equal values keep their order
    and ``a``'s come first (-0.0 and +0.0 are equal values), as every
    merge of ``csrc/topk_boundary.cu`` does."""
    k = a.shape[-1]
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1, descending=True,
                      stable=True).values[..., :k]


def _topk_walk(rows, b: float, heap):
    """(skip, heap): the sequential boundary scan of ``topk_boundary_ref``
    started from ``heap``, with stable merges (``merge_topk_stable``)."""
    P, k = rows.shape
    skip = torch.ones(P, dtype=torch.int32, device=rows.device)
    heads = rows[:, 0]
    neg = float("-inf")
    pos = 0
    while pos < P:
        h_kth = float(heap[k - 1])
        full = h_kth > neg
        seg = heads[pos:]
        skipped = seg < max(b, h_kth if full else neg)
        if full:
            skipped |= seg <= h_kth
        merging = torch.nonzero(~skipped)
        if not merging.numel():
            break
        j = pos + int(merging[0, 0])
        skip[j] = 0
        heap = merge_topk_stable(heap, rows[j])
        pos = j + 1
    return skip, heap


def scan_group(m: int) -> int:
    """Heaps a group of the tiled scan's pass B for m heaps: about
    sqrt(m) (``csrc/topk_boundary.cu``)."""
    g = 1
    while g * g < m:
        g += 1
    return -(-m // g)


def _inclusive_scan(lists):
    """Inclusive Hillis-Steele scan of [m, k] heaps, the earlier list
    first in every merge."""
    d = 1
    while d < len(lists):
        lists = torch.cat([lists[:d], merge_topk_stable(lists[:-d],
                                                        lists[d:])])
        d *= 2
    return lists


def topk_boundary_tiled_ref(rows, b_init: float, tile: int) -> tuple:
    """(skip [P] int32, heap [k] f32): the boundary scan as
    ``csrc/topk_boundary.cu`` runs it on tiles of ``tile`` rows, in plain
    torch; equal to ``topk_boundary_ref``.

    A row the scan skips while the heap is full holds only values <= the
    heap's k-th, so merging it would change no value of the heap, and a
    row whose head is below ``b_init`` is always skipped.  Hence the heap
    before row j is the top-k of the rows i < j with ``rows[i, 0] >=
    b_init``, equal values in row order.  Pass A scans each tile from an
    empty heap (its final heap is that top-k over the tile); pass B scans
    the first n - 1 tile heaps in groups of ``scan_group(n - 1)``, then
    the groups' totals (inclusive Hillis-Steele scans, each pair merged
    with the earlier list first); pass C scans each tile again from the
    heap before it (its group's scanned heap behind the scanned totals of
    the groups before), where the skips are the sequential scan's.  The
    final heap is the last tile's.  Every merge is stable, so the heap's
    -0.0 and +0.0 stand where the sequential scan's stable merge puts them
    (``topk_boundary_ref``'s sort is stable up to 16 values, k <= 8, on
    the CPU)."""
    P, k = rows.shape
    dev = rows.device
    b = float(b_init)
    empty = torch.full((k,), float("-inf"), dtype=torch.float32, device=dev)
    if P == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), empty
    tiles = [rows[s:s + tile] for s in range(0, P, tile)]
    heaps = torch.stack([_topk_walk(t, b, empty)[1] for t in tiles[:-1]]
                        + [empty])
    m = len(tiles) - 1
    group = scan_group(m) if m > 1 else 1
    local = torch.cat([_inclusive_scan(heaps[s:min(s + group, m)])
                       for s in range(0, m, group)] + [heaps[m:]])
    totals = _inclusive_scan(local[group - 1:m:group] if m % group == 0
                             else torch.cat([local[group - 1:m:group],
                                             local[m - 1:m]]))
    skips, heap = [], empty
    for t, rows_t in enumerate(tiles):
        start = empty
        if t:
            g = (t - 1) // group
            start = local[t - 1] if g == 0 else \
                merge_topk_stable(totals[g - 1], local[t - 1])
        s, heap = _topk_walk(rows_t, b, start)
        skips.append(s)
    return torch.cat(skips), heap


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """Softmax attention over q [BH, Sq, D] and k, v [BH, Sk, D] in f32,
    as the JAX package's ``ref.flash_attention_ref``: scale ``D ** -0.5``,
    under ``causal`` key j is kept for query i iff ``j <= i`` (no offset),
    masked scores are -1e30; the output has q's dtype.  It holds the whole
    [BH, Sq, Sk] score tensor: a caller at long S runs it in blocks."""
    D = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


# elements of a block's f32 scores in the plain attention backward
BWD_BLOCK = 1 << 28


def flash_attention_bwd_ref(q, k, v, do, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_ref`` for the output gradient
    ``do`` [BH, Sq, D], each in its input's dtype.

    P = softmax(q k^T * D ** -0.5), with the forward's causal mask and
    -1e30, and O = P v are recomputed in f32; then dV = P^T dO, dP = dO
    V^T, dS = P * (dP - rowsum(dO * O)), dQ = dS K * D ** -0.5 and dK = dS^T
    Q * D ** -0.5.  It runs over blocks of the BH axis whose f32 scores
    hold at most ``BWD_BLOCK`` elements: at S = 4,096 a whole [48, S, S]
    f32 tensor is 3.2 GB, and several are alive at once."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    n = max(1, BWD_BLOCK // max(Sq * Sk, 1))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if causal:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
    for i in range(0, BH, n):
        blk = slice(i, i + n)
        qf, kf, vf, dof = (t[blk].float() for t in (q, k, v, do))
        s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
        if causal:
            s = torch.where(keep[None], s,
                            torch.tensor(-1e30, device=q.device))
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("bqk,bkd->bqd", p, vf)
        dv[blk] = torch.einsum("bqk,bqd->bkd", p, dof)
        ds = torch.einsum("bqd,bkd->bqk", dof, vf)            # dP
        ds.sub_((dof * o).sum(-1, keepdim=True)).mul_(p)
        del p, o
        dq[blk] = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
        dk[blk] = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq, dk, dv
