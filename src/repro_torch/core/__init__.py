"""The paper's primary contribution: partition pruning for analytical scans.

This slice of the port carries two of the four techniques, composed by
``flow`` (paper sections in parentheses):
  * filter pruning        — prune_filter (Sec. 3)
  * LIMIT pruning         — prune_limit (Sec. 4)
"""

from . import expr
from .device_stats import DeviceStats, DeviceStatsCache
from .expr import (and_, col, if_, in_, invert, is_not_null, is_null, like, lit,
                   or_, startswith, true)
from .flow import JoinSpec, PruningPipeline, PruningReport, Query, TableScanSpec
from .metadata import (FULL_MATCH, NO_MATCH, PARTIAL_MATCH, ColumnMeta,
                       PartitionStats, ScanSet, pruning_ratio)
from .prune_filter import eval_tv, extract_ranges, fully_matching_two_pass
from .prune_limit import limit_prune

__all__ = [
    "expr", "col", "lit", "if_", "like", "startswith", "in_", "is_null",
    "is_not_null", "true", "and_", "or_", "invert",
    "Query", "TableScanSpec", "JoinSpec", "PruningPipeline", "PruningReport",
    "ColumnMeta", "PartitionStats", "ScanSet", "pruning_ratio",
    "DeviceStats", "DeviceStatsCache",
    "NO_MATCH", "PARTIAL_MATCH", "FULL_MATCH",
    "eval_tv", "extract_ranges", "fully_matching_two_pass",
    "limit_prune",
]
