"""Top-k boundaries: the batched upfront initialisation, one launch per
(table, order column, direction) group, and the sequential boundary scan
of one query.

For each of Q queries, the k largest values among the rows of its
candidate partitions (its fully-matching partitions) in the resident
block-top-k plane (core/device_stats.py ``block_topk_plane``: [Pc, K]
signed f32 rows, descending, -inf padded): heap [Q, k], descending,
-inf padded — query q's Sec. 5.4 upfront boundary for any kq <= k is
``heap[q, kq - 1]``.  Candidates are CSR: query q's partition ids are
``ids[offsets[q]:offsets[q + 1]]`` (``ops.pack_candidates``).

``topk_boundary`` is the paper's Sec. 5 scan for one query: the ordered
block-top-k rows [P, k] (``ops.build_block_topk``, in processing order)
walked one after another with the global heap carried along; it returns
each row's skip flag and the final heap (``ref.topk_boundary_ref`` states
the rule).  The kernel runs it on tiles of rows, on every SM, with the
same result (``ref.topk_boundary_tiled_ref``).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/topk_init_batched.cu``, ``csrc/topk_boundary.cu``, built at first
use, see ``build.py``); on a CPU tensor it runs the plain PyTorch version
(``ref.topk_init_batched_ref``, ``ref.topk_boundary_ref``).  There is no
fallback between the two: a CUDA input either launches the kernel or
raises ``KernelError``, as does any input the kernel does not take.
"""

from __future__ import annotations

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import topk_boundary_ref, topk_init_batched_ref

KERNEL = "topk_init_batched"
KERNEL_SCAN = "topk_boundary"
# Largest heap the kernel keeps: its last launch sorts the values above
# the threshold of at most k - 1 rows, (k - 1) * min(K, k) floats in
# shared memory (64 KB at 128).
MAX_K = 128
# Candidate rows per block of the scan passes the launch aims for; a
# query's list is cut into at most MAX_SLABS slabs, one block each.
SLAB_ROWS = 4096
MAX_SLABS = 4096
# int32 words of a query's workspace besides its k gathered rows: a
# 256-bin histogram and 8 words of select state (csrc/topk_init_batched.cu)
WORK_HEADER = 264


def slabs(Q: int, nnz: int) -> int:
    """Blocks per query: the average list cut into SLAB_ROWS-row slabs."""
    per_query = -(-nnz // max(Q, 1))
    return max(1, min(MAX_SLABS, -(-per_query // SLAB_ROWS)))


def topk_init_batched(
    plane: torch.Tensor,     # [Pc, K] f32 resident block-top-k rows
    offsets: torch.Tensor,   # [Q + 1] int64 CSR row offsets into ids
    ids: torch.Tensor,       # [nnz] int32 candidate partition ids
    k: int,
) -> torch.Tensor:
    """Returns heap [Q, k] f32 on the plane's device."""
    if plane.dim() != 2 or offsets.dim() != 1 or ids.dim() != 1:
        raise KernelError("plane must be [Pc, K], offsets [Q + 1] and "
                          "ids [nnz]")
    if not 1 <= int(k) <= MAX_K:
        raise KernelError(f"k {k} outside [1, {MAX_K}]")
    k = int(k)
    Pc, K = plane.shape
    Q = int(offsets.shape[0]) - 1
    nnz = int(ids.shape[0])
    if Q < 0 or K < 1:
        raise KernelError("offsets need Q + 1 >= 1 entries and rows K >= 1")
    dev = plane.device
    for name, t, dtype, shape in (
            ("plane", plane, torch.float32, (Pc, K)),
            ("offsets", offsets, torch.int64, (Q + 1,)),
            ("ids", ids, torch.int32, (nnz,))):
        check_tensor(name, t, dtype, shape, dev)
    check_candidates(offsets, ids, Pc)
    if not build.runs_kernel(dev):
        return topk_init_batched_ref(plane, offsets, ids, k)
    return launch_checked(plane, offsets, ids, k)


def check_candidates(offsets: torch.Tensor, ids: torch.Tensor,
                     Pc: int) -> None:
    """Raise ``KernelError`` unless ``offsets``/``ids`` are CSR lists of
    partition ids in [0, Pc): the kernel indexes the plane by them.  Three
    reductions over the lists and, on the card, one wait for their
    result."""
    nnz = int(ids.shape[0])
    bad = (offsets[0] != 0) | (offsets[-1] != nnz) \
        | (offsets[1:] < offsets[:-1]).any()
    if nnz:
        bad = bad | (ids.min() < 0) | (ids.max() >= Pc)
    if bool(bad):
        raise KernelError("candidate lists must be CSR offsets from 0 to "
                          f"{nnz} over partition ids in [0, {Pc})")


def launch_checked(plane: torch.Tensor, offsets: torch.Tensor,
                   ids: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's launch alone, on CUDA inputs that
    ``topk_init_batched`` has checked: heap [Q, k].  ``chip_smoke.py``
    times this as the kernel's time."""
    dev = plane.device
    K = int(plane.shape[1])
    Q = int(offsets.shape[0]) - 1
    heap = torch.empty((Q, k), dtype=torch.float32, device=dev)
    if Q == 0:
        return heap
    nnz = int(ids.shape[0])
    keys = torch.empty(nnz, dtype=torch.int32, device=dev)
    work = torch.zeros((Q, WORK_HEADER + k), dtype=torch.int32, device=dev)
    build.launch(KERNEL, dev, plane, offsets, ids, heap, keys, work,
                 Q, K, k, slabs(Q, nnz))
    topk_init_batched.launches += 1
    return heap


# launches of the CUDA kernel (CPU calls of the plain version not counted)
topk_init_batched.launches = 0


# Largest heap of the boundary scan: a block keeps the heap, the merge
# target and at least one staged row in dynamic shared memory, 3 * k * 4
# bytes (192 KB at 16384, under the 227 KB a block can opt in to).
MAX_K_SCAN = 16384
# The scan's tiles (csrc/topk_boundary.cu): a block walks SCAN_SUB rows at
# a time, the launch aims at TILES_PER_SM tiles an SM, and pass B scans the
# first n - 1 of the n tile heaps, at most SCAN_FLOATS floats.
SCAN_SUB = 2048
TILES_PER_SM = 2
SCAN_FLOATS = 24576


def scan_tile(P: int, k: int, sms: int) -> int:
    """Rows a tile of the boundary scan: about TILES_PER_SM * sms tiles,
    fewer where their heaps would pass SCAN_FLOATS, a multiple of
    SCAN_SUB and at least k rows (the tile heaps then take no more room
    than the rows' heads)."""
    tiles = max(1, min(TILES_PER_SM * sms, SCAN_FLOATS // k))
    T = max(-(-P // tiles), k, SCAN_SUB)
    return -(-T // SCAN_SUB) * SCAN_SUB


def topk_boundary(
    rows: torch.Tensor,      # [P, k] f32 rows, each descending, -inf padded
    b_init: float = float("-inf"),   # upfront boundary (-inf: none)
):
    """Returns (skip [P] int32, heap [k] f32) on the rows' device.

    ``b_init`` is taken as the nearest f32 (callers round it down first,
    as ``ops.topk_boundary_device`` does), and the kernel and the plain
    version get the same value.  Rows must hold no NaN."""
    if rows.dim() != 2:
        raise KernelError("rows must be [P, k]")
    P, k = rows.shape
    if not 1 <= k <= MAX_K_SCAN:
        raise KernelError(f"k {k} outside [1, {MAX_K_SCAN}]")
    b32 = float(torch.tensor(float(b_init), dtype=torch.float32))
    if b32 != b32:
        raise KernelError("b_init must not be NaN")
    dev = rows.device
    check_tensor("rows", rows, torch.float32, (P, k), dev)
    if not build.runs_kernel(dev):
        return topk_boundary_ref(rows, b32)
    return scan_launch_checked(rows, b32)


def scan_launch_checked(rows: torch.Tensor, b32: float, tile=None):
    """The boundary scan's launches alone, on CUDA inputs that
    ``topk_boundary`` has checked and an f32 ``b32``: (skip, heap), one
    count however many launches.  ``tile`` rows a tile (default
    ``scan_tile``); ``chip_smoke.py`` times this beside the wrapper."""
    P, k = rows.shape
    dev = rows.device
    skip = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:                          # nothing to scan: an empty heap
        return skip, torch.full((k,), float("-inf"), dtype=torch.float32,
                                device=dev)
    heap = torch.empty(k, dtype=torch.float32, device=dev)  # written whole
    if tile is None:
        tile = scan_tile(P, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    n = -(-P // tile)
    if (n - 1) * k > SCAN_FLOATS:
        raise KernelError(f"{n} tiles of k = {k}: their heaps pass "
                          f"{SCAN_FLOATS} floats")
    # tile heaps and pass B's group totals, then the row heads pass A
    # copies for pass C
    work = torch.empty(2 * n * k + (P if n > 1 else 0), dtype=torch.float32,
                       device=dev)
    build.launch(KERNEL_SCAN, dev, rows, b32, skip, heap, work, P, k, tile)
    topk_boundary.launches += 1
    return skip, heap


# launches of the CUDA kernel (CPU calls of the plain version not counted)
topk_boundary.launches = 0
