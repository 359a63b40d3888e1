"""Batched blocked-Bloom JOIN pruning, one launch per (table, key column).

Evaluates **Q Bloom filters x P probe partitions** against the resident
enumeration plane (core/device_stats.py ``enum_plane``: integer-snapped
int32 ``pmin`` and candidate count ``width``, 0 = keep): hit[q, p] is 1
where width is 0, else iff some candidate ``pmin + j`` (j < width) is in
query q's filter.  Filters are [Q, Bb * 16] int32 rows holding their
uint32 words, tiled to a common power-of-two block count Bb
(``ops.pack_blooms``); the hash is ``core.prune_join``'s bit for bit.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/bloom_probe_batched.cu`` (built at first use, see ``build.py``):
the filters are first transposed on the card into a bit-sliced table
(``ref.bloom_bitslice_ref`` is its plain version; ``table_plan`` picks
its entry width), then probed;
on a CPU tensor it runs the plain PyTorch version
(``ref.bloom_probe_batched_ref``).  There is no fallback between the two:
a CUDA input either launches the kernel or raises ``KernelError``, as
does any input the kernel does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.prune_join import BLOCK_WORDS
from . import build
from .build import KernelError, check_tensor
from .ref import bloom_probe_batched_ref

KERNEL = "bloom_probe_batched"


def table_plan(Q: int, n_blocks: int) -> tuple:
    """(bits, nbytes): the bit-sliced table's entry width, 8, 16 or 32
    queries a chunk (the narrowest that covers min(Q, 32) queries: a
    second chunk hashes every candidate again), and the table's bytes,
    ``ceil(Q / bits)`` chunks of ``n_blocks * 512`` entries."""
    bits = 8 if Q <= 8 else 16 if Q <= 16 else 32
    return bits, -(-Q // bits) * n_blocks * 512 * bits // 8


def bloom_probe_batched(
    words: torch.Tensor,     # [Q, Bb * 16] int32 filter words (uint32 bits)
    pmin: torch.Tensor,      # [Pc] int32 integer-snapped partition minima
    width: torch.Tensor,     # [Pc] int32 candidate counts; 0 = keep
    num_partitions: Optional[int] = None,   # logical P <= Pc (default Pc)
) -> torch.Tensor:
    """Returns hit [Q, P] int8 in {0, 1} on the plane's device."""
    if words.dim() != 2 or pmin.dim() != 1:
        raise KernelError("filters must be [Q, Bb * 16] and the plane "
                          "rows [Pc]")
    Q, W = words.shape
    n_blocks = W // BLOCK_WORDS
    if W % BLOCK_WORDS or n_blocks < 1 or n_blocks & (n_blocks - 1):
        raise KernelError(f"filter rows of {W} words are not a power-of-two "
                          f"number of {BLOCK_WORDS}-word blocks")
    Pc = int(pmin.shape[0])
    P = Pc if num_partitions is None else int(num_partitions)
    if not 0 <= P <= Pc:
        raise KernelError(f"num_partitions {P} outside [0, {Pc}]")
    dev = pmin.device
    for name, t, shape in (("words", words, (Q, W)), ("pmin", pmin, (Pc,)),
                           ("width", width, (Pc,))):
        check_tensor(name, t, torch.int32, shape, dev)
    if not build.runs_kernel(dev):
        return bloom_probe_batched_ref(words, pmin, width, num_partitions=P)
    hit = torch.empty((Q, P), dtype=torch.int8, device=dev)
    if Q == 0 or P == 0:
        return hit
    bits, nbytes = table_plan(Q, n_blocks)
    table = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    build.launch(KERNEL, dev, words, pmin, width, hit, table, Q, n_blocks, P,
                 bits)
    bloom_probe_batched.launches += 1
    return hit


# launches of the CUDA kernel (CPU calls of the plain version not counted)
bloom_probe_batched.launches = 0
