"""DML bookkeeping shared with the resident metadata planes.

``TableVersion`` is the minimal version record a caller can hand to
``core.device_stats.DeviceStatsCache.get``: a bump forces a restage.  The
paper's Sec. 8.2 top-k predicate cache (the rest of the reference module)
comes with the top-k slice of the port.
"""

from __future__ import annotations


class TableVersion:
    """Minimal DML bookkeeping a table exposes to the cache."""

    def __init__(self, num_partitions: int):
        self.version = 0
        self.num_partitions = num_partitions

    def insert_partitions(self, n: int) -> None:
        self.version += 1
        self.num_partitions += n
