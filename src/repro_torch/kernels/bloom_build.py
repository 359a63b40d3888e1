"""Build-side JOIN summaries of G build sides at once, one launch each of
a dedupe and a Bloom-set kernel.

Computes what ``core.prune_join.summarize_build`` computes from a build
side's keys, for G int64 key segments in one buffer: the distinct count
(NDV), min and max and, per segment, the distinct keys where NDV <=
``ndv_limit``, else the blocked Bloom words of ``bloom_blocks(NDV)``
blocks (the host's hash, bit for bit).  ``plan_builds`` lays the segments
out; the buffer holds the plan, then the keys, so one H2D stages both.

On a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/bloom_build.cu`` (built at first use, see ``build.py``); on a CPU
tensor it runs the plain PyTorch versions below (``dedupe_ref``,
``bloom_set_ref``).  There is no fallback between the two: a CUDA input
either launches the kernels or raises ``KernelError``, as does any input
the kernels do not take.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.prune_join import BLOCK_WORDS, K_PROBES, bloom_blocks
from . import build
from .build import KernelError, check_tensor
from .ref import H1_SALT, H2_SALT, U32, mix32

KERNEL = "bloom_build"
# plan row: key0, n, slot0, cap, word0, n_words (two spare columns keep a
# row 64 bytes); header row: ndv, min, max, n_blocks, the key -1's flag
COLS = 8
INT64_MIN, INT64_MAX = -2 ** 63, 2 ** 63 - 1


def plan_builds(sizes: Sequence[int], ndv_limit: int,
                bits_per_key: int) -> np.ndarray:
    """The plan [G, 8] int64 of G segments of ``sizes`` keys: each one's
    first key, count, hash-set slots (a power of two >= 2n) and Bloom
    words (as many as n distinct keys need; none where n <= ndv_limit,
    which no NDV can pass)."""
    plan = np.zeros((len(sizes), COLS), dtype=np.int64)
    key0 = slot0 = word0 = 0
    for g, n in enumerate(sizes):
        n = int(n)
        cap = 1 << (2 * max(n, 1) - 1).bit_length()     # pow2 >= 2n
        words = bloom_blocks(n, bits_per_key) * BLOCK_WORDS \
            if n > ndv_limit else 0
        plan[g, :6] = (key0, n, slot0, cap, word0, words)
        key0, slot0, word0 = key0 + n, slot0 + cap, word0 + words
    return plan


def dedupe_ref(keys: torch.Tensor, plan: np.ndarray,
               ndv_limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dedupe kernel's plain version: (header [G, 8], distinct [G,
    ndv_limit]), int64.  ``distinct[g, :ndv]`` holds the sorted distinct
    keys where ndv <= ndv_limit (the kernel's come in no order); n_blocks
    is left 0 for ``bloom_set_ref``."""
    G = plan.shape[0]
    header = torch.zeros((G, COLS), dtype=torch.int64)
    header[:, 1], header[:, 2] = INT64_MAX, INT64_MIN
    distinct = torch.zeros((G, ndv_limit), dtype=torch.int64)
    for g in range(G):
        k0, n = int(plan[g, 0]), int(plan[g, 1])
        if n == 0:
            continue
        seg = keys[k0:k0 + n]
        uniq = torch.unique(seg)
        header[g, 0] = uniq.numel()
        header[g, 1], header[g, 2] = seg.min(), seg.max()
        header[g, 4] = int(bool((seg == -1).any()))
        m = min(uniq.numel(), ndv_limit)
        distinct[g, :m] = uniq[:m]
    return header, distinct


def bloom_set_ref(keys: torch.Tensor, plan: np.ndarray, header: torch.Tensor,
                  ndv_limit: int, bits_per_key: int) -> torch.Tensor:
    """The Bloom-set kernel's plain version: the words int32 (uint32 bits)
    of every segment whose NDV passes ``ndv_limit``, at its plan offset;
    writes each one's n_blocks into ``header``."""
    n_words = int(plan[:, 5].sum())
    bits = torch.zeros(n_words * 32, dtype=torch.bool)
    for g in range(plan.shape[0]):
        ndv = int(header[g, 0])
        if ndv <= ndv_limit:
            continue
        nb = bloom_blocks(ndv, bits_per_key)
        header[g, 3] = nb
        k0, n, w0 = int(plan[g, 0]), int(plan[g, 1]), int(plan[g, 4])
        k = keys[k0:k0 + n]
        h0 = mix32((k & U32) ^ mix32((k >> 32) & U32))
        h1 = mix32(h0 ^ H1_SALT)
        h2 = mix32(h1 ^ H2_SALT)
        base = w0 + (h0 & (nb - 1)) * BLOCK_WORDS
        for i in range(K_PROBES):
            word = base + ((h1 >> (8 * i)) & (BLOCK_WORDS - 1))
            bits[word * 32 + ((h2 >> (8 * i)) & 31)] = True
    w = (bits.view(n_words, 32).to(torch.int64)
         << torch.arange(32, dtype=torch.int64)).sum(1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def bloom_build(
    staged: torch.Tensor,     # [G * 8 + N] int64: the plan, then the keys
    plan: np.ndarray,         # the same plan [G, 8] on the host
    ndv_limit: int,
    bits_per_key: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (header [G, 8] int64, distinct [G, ndv_limit] int64, words
    [n_words] int32) on the buffer's device: header row g is (ndv, min,
    max, n_blocks, ...), n_blocks 0 where the distinct keys stand instead
    of a filter; segment g's words start at ``plan[g, 4]``."""
    if plan.ndim != 2 or plan.shape[1] != COLS or plan.dtype != np.int64:
        raise KernelError(f"the plan must be [G, {COLS}] int64")
    if not 0 < int(ndv_limit) < 2 ** 31 or int(bits_per_key) <= 0:
        raise KernelError(f"ndv_limit {ndv_limit} / bits_per_key "
                          f"{bits_per_key} out of range")
    G = plan.shape[0]
    N = int(plan[:, 1].sum())
    dev = staged.device
    check_tensor("staged", staged, torch.int64, (G * COLS + N,), dev)
    keys = staged[G * COLS:]
    if not build.runs_kernel(dev):
        header, distinct = dedupe_ref(keys, plan, ndv_limit)
        return header, distinct, bloom_set_ref(keys, plan, header, ndv_limit,
                                               bits_per_key)
    n_words = int(plan[:, 5].sum())
    header = torch.empty((G, COLS), dtype=torch.int64, device=dev)
    distinct = torch.empty((G, ndv_limit), dtype=torch.int64, device=dev)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    if G == 0:
        return header, distinct, words
    table = torch.empty(int(plan[:, 3].sum()), dtype=torch.int64, device=dev)
    build.launch(KERNEL, dev, staged, table, header, distinct, words, G,
                 int(plan[:, 1].max()), int(table.numel()), n_words,
                 int(ndv_limit), int(bits_per_key))
    bloom_build.launches += 1
    return header, distinct, words


# launches of the CUDA kernels (CPU calls of the plain versions not counted)
bloom_build.launches = 0
