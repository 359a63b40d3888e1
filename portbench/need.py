"""The least time a stage's inputs need on the card, frozen with the benchmark.

A stage's need is counted from the work its inputs demand, never from the
kernel that does it or its launch shape: each input byte read once, each
output written once, over the card's published memory rate.  Every count
is a lower bound on what any implementation must move, so a share of it
cannot pass 100% unless the time leaves out part of the work:

  filter    for every column a table group's new predicates read, 4 bytes
            of each partition some predicate does not rule out (the value
            that shows it is not NO), 4 bytes of each other partition some
            predicate rules out, and 2 bits of verdict a (predicate,
            partition); a predicate already seen this run could be served
            from a stored row: 2 bits read and 2 written
  topk_init 4 bytes (the partition's best value) of each fully-matching
            partition some query's boundary reads, and k values out

Operations are not counted: the bytes bound every stage here.  The
arithmetic of the port's smoke (``minmax_need``, ``bloom_work``, the top-k
plane bytes) counts what one launch's data needs; these forms extend it to
a stage over a batch and drop what depends on the program's own layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

# NVIDIA H100 SXM5 data sheet: 80 GB of HBM3 at 3.35 TB/s (dense rates
# below are not used: no stage here is bound by operations).
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "bf16_flops": 989e12,
         "fp32_flops": 67e12, "memory_bytes": 80e9}


def _out2(P: int) -> int:
    return -(-P // 4)


def filter_bytes(ref, specs, seen: Set) -> int:
    nbytes = 0
    groups: Dict[str, dict] = {}
    for q in specs:
        for table, cons in q.scans.values():
            if not cons:
                continue
            P = ref.stats(table).num_partitions
            key = (table, repr(cons))
            if key in seen:
                nbytes += 2 * _out2(P)
                continue
            seen.add(key)
            nbytes += _out2(P)
            nz = ref.verdicts(table, cons) > 0
            g = groups.setdefault(table, {"cols": {},
                                          "no": np.zeros(P, dtype=bool)})
            for col in {c for c, _, _ in cons}:
                g["cols"][col] = g["cols"].get(col, np.zeros(P, bool)) | nz
            g["no"] |= ~nz
    for g in groups.values():
        seen_any = np.zeros_like(g["no"])
        for m in g["cols"].values():
            nbytes += 4 * int(m.sum())
            seen_any |= m
        nbytes += 4 * int((g["no"] & ~seen_any).sum())
    return nbytes


def topk_init_bytes(ref, specs) -> int:
    union: Optional[np.ndarray] = None
    nbytes = 0
    for q in specs:
        table, cons = q.scans[q.order_by[0]]
        full = ref.verdicts(table, cons) == 2
        union = full if union is None else union | full
        nbytes += 4 * (int(q.limit) + int(q.offset))
    return nbytes + (0 if union is None else 4 * int(union.sum()))
