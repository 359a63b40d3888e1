"""Plain PyTorch versions of the port's kernels (no custom kernels).

Each function computes the same contract as its hand-written kernel with
ordinary tensor ops, on any device.  The CPU path of the port runs them,
the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


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
