"""Columnar tables, micro-partitions and synthetic data generation, the
query executor over pruned scan sets (``scan``), Iceberg-style two-level
metadata (``iceberg``) and the pruned pretraining data pipeline
(``pipeline``)."""

from .iceberg import IcebergTable, TwoLevelResult, two_level_prune
from .pipeline import (CurationReport, PrunedDataLoader, WorkQueue, curate,
                       make_corpus_metadata, shard_tokens)
from .scan import QueryResult, ScanMetrics, execute_query, scan_partitions
from .table import Table

__all__ = [
    "Table", "QueryResult", "ScanMetrics", "execute_query", "scan_partitions",
    "IcebergTable", "TwoLevelResult", "two_level_prune",
    "CurationReport", "PrunedDataLoader", "WorkQueue", "curate",
    "make_corpus_metadata", "shard_tokens",
]
