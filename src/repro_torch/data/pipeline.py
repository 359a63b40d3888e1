"""Pruned pretraining data pipeline ("training is a pruned scan").

Pre-training corpora are stored as token shards with per-shard metadata
(quality score, language, source, dedup bucket, ingestion time) — exactly
the micro-partition + min/max metadata shape of the paper.  Data curation
("quality >= t AND lang IN (...) AND NOT duplicate") is filter pruning:
shards whose metadata cannot match are never fetched from storage, and
LIMIT pruning implements token budgets ("take the first 50B curated
tokens") IO-optimally via fully-matching shards.

Distribution: the pruned scan set is split over data-parallel workers;
stragglers are handled by *deterministic work stealing* — every worker
can compute who owns what from (scan_set, worker_count, cursor) alone, so
a restart resumes exactly (the checkpoint stores only cursors).

Host NumPy, as in the JAX package: the shard set, the queue and the
token draws are the same numbers; the loader hands out CPU ``torch``
int32 tensors holding them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.metadata import NO_MATCH, ScanSet
from ..core.prune_filter import eval_tv
from .generator import ColumnSpec, gen_table
from .table import Table


def make_corpus_metadata(
    rng: np.random.Generator,
    n_shards: int = 2048,
    docs_per_shard: int = 64,
) -> Table:
    """Shard-level metadata table: one row per document, one partition per
    shard.  Quality/language cluster by source crawl — the correlation
    that makes curation prunable (as in the paper's production data)."""
    n = n_shards * docs_per_shard
    specs = [
        ColumnSpec("ingest_ts", "int", 0, 10_000_000, clustering=0.99),
        ColumnSpec("quality", "float", 0.0, 1.0, clustering=0.85),
        ColumnSpec("lang", "str", n_distinct=16, clustering=0.9,
                   str_groups=("en", "de", "fr", "zh")),
        ColumnSpec("dedup_bucket", "int", 0, 1000, clustering=0.0),
        ColumnSpec("n_tokens", "int", 256, 4096, clustering=0.0),
    ]
    return gen_table("corpus", rng, n, docs_per_shard, specs)


@dataclasses.dataclass
class CurationReport:
    shards_total: int
    shards_selected: int

    @property
    def pruning_ratio(self) -> float:
        return 1.0 - self.shards_selected / max(self.shards_total, 1)


def curate(meta: Table, pred: E.Pred) -> Tuple[ScanSet, CurationReport]:
    """Filter-prune the shard set against a curation predicate."""
    tv = eval_tv(pred, meta.stats)
    keep = tv > NO_MATCH
    scan = ScanSet(np.where(keep)[0], tv[keep])
    return scan, CurationReport(meta.num_partitions, len(scan))


class WorkQueue:
    """Deterministic work stealing over a shard list.

    Shards are round-robin assigned; a worker that drains its own list
    steals the tail of the most-loaded worker's list.  All decisions are
    functions of the shared cursor state, so every worker (and a restore)
    reaches identical conclusions — no coordinator needed beyond the
    cursor array.
    """

    def __init__(self, shard_ids: np.ndarray, n_workers: int):
        self.n_workers = n_workers
        self.lists: List[List[int]] = [
            list(map(int, shard_ids[w::n_workers])) for w in range(n_workers)
        ]
        self.cursor = [0] * n_workers          # next index into own list
        self.stolen: set = set()

    def remaining(self, w: int) -> int:
        return len(self.lists[w]) - self.cursor[w]

    def next_for(self, w: int) -> Optional[int]:
        # own work first
        while self.cursor[w] < len(self.lists[w]):
            sid = self.lists[w][self.cursor[w]]
            self.cursor[w] += 1
            if sid not in self.stolen:
                return sid
        # steal from the most-loaded worker, from the TAIL (the victim
        # works head-first, so collisions are impossible until exhaustion)
        victim = max(range(self.n_workers), key=self.remaining)
        if self.remaining(victim) <= 0:
            return None
        for i in range(len(self.lists[victim]) - 1, self.cursor[victim] - 1, -1):
            sid = self.lists[victim][i]
            if sid not in self.stolen:
                self.stolen.add(sid)
                return sid
        return None

    def state(self) -> dict:
        return {"cursor": list(self.cursor), "stolen": sorted(self.stolen)}

    def restore(self, state: dict) -> None:
        self.cursor = list(state["cursor"])
        self.stolen = set(state["stolen"])


def shard_tokens(shard_id: int, tokens_per_shard: int, vocab: int,
                 seed: int = 0) -> np.ndarray:
    """Deterministic synthetic token stream for a shard (stands in for the
    object-store fetch; keyed by shard id so replays are exact)."""
    rng = np.random.default_rng((seed << 20) ^ shard_id)
    return rng.integers(0, vocab, size=tokens_per_shard, dtype=np.int32)


class PrunedDataLoader:
    """Batches [B, S+1] from the curated shard set for one DP worker."""

    def __init__(
        self,
        scan: ScanSet,
        worker: int,
        n_workers: int,
        batch_size: int,
        seq_len: int,
        vocab: int,
        tokens_per_shard: int = 32_768,
        seed: int = 0,
    ):
        self.queue = WorkQueue(scan.part_ids, n_workers)
        self.worker = worker
        self.batch = batch_size
        self.seq = seq_len
        self.vocab = vocab
        self.tps = tokens_per_shard
        self.seed = seed
        self._buf = np.zeros(0, dtype=np.int32)
        self.shards_consumed: List[int] = []

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        need = self.batch * (self.seq + 1)
        while True:
            while len(self._buf) < need:
                sid = self.queue.next_for(self.worker)
                if sid is None:
                    return
                self.shards_consumed.append(sid)
                self._buf = np.concatenate(
                    [self._buf, shard_tokens(sid, self.tps, self.vocab, self.seed)]
                )
            chunk, self._buf = self._buf[:need], self._buf[need:]
            arr = torch.from_numpy(chunk.reshape(self.batch, self.seq + 1))
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def state(self) -> dict:
        return {"queue": self.queue.state(),
                "buf_len": int(len(self._buf)),
                "consumed": list(self.shards_consumed)}

    def restore(self, state: dict) -> None:
        """Resume from ``state()``: the queue's cursors, the shards
        consumed, and the unconsumed buffer, which is the last
        ``buf_len`` tokens of the consumed shards' streams (each shard's
        draw is keyed by its id, so it is drawn again exactly)."""
        self.queue.restore(state["queue"])
        self.shards_consumed = list(state["consumed"])
        need = int(state["buf_len"])
        tail: List[np.ndarray] = []
        have = 0
        for sid in reversed(self.shards_consumed):
            if have >= need:
                break
            tail.append(shard_tokens(sid, self.tps, self.vocab, self.seed))
            have += self.tps
        buf = (np.concatenate(tail[::-1]) if tail
               else np.zeros(0, dtype=np.int32))
        self._buf = buf[len(buf) - need:]
