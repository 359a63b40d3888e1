"""The paper's primary contribution: partition pruning for analytical scans.

Four techniques (paper sections in parentheses), composed by ``flow``:
  * filter pruning        — prune_filter (Sec. 3), prune_tree (Sec. 3.2)
  * LIMIT pruning         — prune_limit (Sec. 4)
  * top-k pruning         — prune_topk  (Sec. 5)
  * JOIN pruning          — prune_join  (Sec. 6)
The Sec. 8.2 top-k predicate cache is ``predicate_cache``.
"""

from . import expr
from .device_stats import DeviceStats, DeviceStatsCache
from .expr import (and_, col, if_, in_, invert, is_not_null, is_null, like, lit,
                   or_, startswith, true)
from .flow import JoinSpec, PruningPipeline, PruningReport, Query, TableScanSpec
from .metadata import (FULL_MATCH, NO_MATCH, PARTIAL_MATCH, ColumnMeta,
                       PartitionStats, ScanSet, pruning_ratio)
from .prune_filter import eval_tv, extract_ranges, fully_matching_two_pass
from .prune_join import BlockedBloom, BuildSummary, prune_probe, summarize_build
from .prune_limit import limit_prune
from .predicate_cache import PredicateCache, plan_key
from .prune_topk import run_topk, topk_oracle, upfront_boundary
from .prune_tree import AdaptivePruner

__all__ = [
    "expr", "col", "lit", "if_", "like", "startswith", "in_", "is_null",
    "is_not_null", "true", "and_", "or_", "invert",
    "Query", "TableScanSpec", "JoinSpec", "PruningPipeline", "PruningReport",
    "ColumnMeta", "PartitionStats", "ScanSet", "pruning_ratio",
    "DeviceStats", "DeviceStatsCache",
    "NO_MATCH", "PARTIAL_MATCH", "FULL_MATCH",
    "eval_tv", "extract_ranges", "fully_matching_two_pass",
    "BlockedBloom", "BuildSummary", "summarize_build", "prune_probe",
    "limit_prune", "run_topk", "topk_oracle", "upfront_boundary",
    "AdaptivePruner", "PredicateCache", "plan_key",
]
