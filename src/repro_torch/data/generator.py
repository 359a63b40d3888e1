"""Synthetic table/workload generation, calibrated to the paper's stats.

The paper's central empirical claim (Sec. 8.3) is that real workloads are
far more selective and better clustered than TPC-H.  We therefore generate
two families:

  * *production-like* tables: strongly clustered timestamp/sequence
    columns, categorical columns with prefix structure, highly selective
    predicates; LIMIT k drawn from the Figure 6 distribution.
  * *TPC-H-like* tables (Fig. 13 setup): LINEITEM/ORDERS shapes clustered
    on l_shipdate/o_orderdate, with the benchmark's characteristically
    low-selectivity predicates.

The ``clustering`` knob (0 = random, 1 = perfectly sorted) displaces each
row of a sorted column by Normal(0, (1-clustering) * n) positions — a
smooth interpolation between a clustered and a shuffled layout that
controls min/max overlap between partitions, the quantity pruning
effectiveness depends on ("regardless of the implemented pruning
techniques, the number of partitions that can be skipped primarily
depends on how data is distributed", Sec. 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .table import Table


@dataclasses.dataclass
class ColumnSpec:
    name: str
    kind: str = "float"              # 'int' | 'float' | 'str'
    low: float = 0.0
    high: float = 1_000_000.0
    clustering: float = 0.0
    null_frac: float = 0.0
    n_distinct: Optional[int] = None  # categorical domain size
    str_groups: Sequence[str] = ("Alpine", "Boreal", "Coastal", "Desert")


def _displace(sorted_vals: np.ndarray, clustering: float, rng: np.random.Generator):
    n = len(sorted_vals)
    if clustering >= 1.0 or n <= 1:
        return sorted_vals
    sigma = (1.0 - clustering) * n
    keys = np.arange(n) + rng.normal(0.0, sigma, size=n)
    return sorted_vals[np.argsort(keys, kind="stable")]


def gen_column(rng: np.random.Generator, n: int, spec: ColumnSpec):
    """Returns (raw_values, null_mask)."""
    if spec.kind == "str":
        nd = spec.n_distinct or 64
        per_group = max(nd // len(spec.str_groups), 1)
        domain = np.array(
            [f"{g}-{i:05d}" for g in spec.str_groups for i in range(per_group)]
        )
        idx = np.sort(rng.integers(0, len(domain), size=n))
        vals = domain[_displace_codes(idx, spec.clustering, rng)]
    elif spec.n_distinct is not None:
        idx = np.sort(rng.integers(int(spec.low), int(spec.low) + spec.n_distinct, size=n))
        vals = _displace(idx.astype(np.int64), spec.clustering, rng)
    elif spec.kind == "int":
        vals = np.sort(rng.integers(int(spec.low), int(spec.high), size=n))
        vals = _displace(vals.astype(np.int64), spec.clustering, rng)
    else:
        vals = np.sort(rng.uniform(spec.low, spec.high, size=n))
        vals = _displace(vals, spec.clustering, rng)
    nulls = rng.random(n) < spec.null_frac if spec.null_frac > 0 else None
    return vals, nulls


def _displace_codes(sorted_codes: np.ndarray, clustering: float, rng):
    return _displace(sorted_codes, clustering, rng)


def gen_table(
    name: str,
    rng: np.random.Generator,
    n_rows: int,
    rows_per_partition: int,
    specs: Sequence[ColumnSpec],
) -> Table:
    raw: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    for spec in specs:
        v, nm = gen_column(rng, n_rows, spec)
        raw[spec.name] = v
        if nm is not None:
            nulls[spec.name] = nm
    return Table.build(name, raw, rows_per_partition, nulls)


# ---------------------------------------------------------------------------
# Figure 6: the LIMIT-k distribution observed across Snowflake.
# 97% of queries have k <= 10,000; 99.9% k <= 2,000,000; the bulk is 0/1.
# ---------------------------------------------------------------------------

def sample_limit_k(rng: np.random.Generator) -> int:
    u = rng.random()
    if u < 0.28:
        return 0            # BI tools fetching schemas with LIMIT 0
    if u < 0.48:
        return 1
    if u < 0.62:
        return int(rng.choice([10, 25, 50, 100]))
    if u < 0.97:
        return int(np.exp(rng.uniform(np.log(2), np.log(10_000))))
    if u < 0.999:
        return int(np.exp(rng.uniform(np.log(10_000), np.log(2_000_000))))
    return int(np.exp(rng.uniform(np.log(2_000_000), np.log(20_000_000))))


# ---------------------------------------------------------------------------
# Production-like tables (events fact table + users dimension)
# ---------------------------------------------------------------------------

def make_events_table(
    rng: np.random.Generator,
    n_rows: int = 200_000,
    rows_per_partition: int = 1000,
    ts_clustering: float = 0.98,
    user_clustering: float = 0.55,
) -> Table:
    """A production-shaped fact table: events clustered by ingestion time.

    Real warehouse tables arrive roughly time-ordered, which is what makes
    min/max pruning on date predicates so effective (the 99%+ filter
    pruning ratios of Fig. 4).
    """
    specs = [
        ColumnSpec("ts", "int", 0, 10_000_000, clustering=ts_clustering),
        ColumnSpec("user_id", "int", 0, 500_000, clustering=user_clustering),
        ColumnSpec("score", "float", 0.0, 1.0, clustering=0.0),
        # counters correlate with ingestion order in production tables
        ColumnSpec("num_sightings", "int", 0, 100_000, clustering=0.55),
        ColumnSpec("status", "str", n_distinct=32, clustering=0.92,
                   str_groups=("ok", "warn", "err", "crit")),
        ColumnSpec("region", "str", n_distinct=16, clustering=0.3,
                   str_groups=("eu", "us", "ap", "sa")),
    ]
    return gen_table("events", rng, n_rows, rows_per_partition, specs)


def make_users_table(
    rng: np.random.Generator,
    n_rows: int = 20_000,
    rows_per_partition: int = 1000,
) -> Table:
    """Dimension table with a *correlated* attribute: user ids are assigned
    chronologically, so age anti-correlates with id.  Column correlation is
    what gives join pruning its bite on real data (Sec. 8.3 / Dreseler et
    al.): a selective predicate on age concentrates the build-side keys in
    a narrow id range, which probe-side min/max metadata can exclude."""
    ids = np.sort(rng.choice(500_000, size=n_rows, replace=False))
    age = np.clip(
        90.0 - ids * (70.0 / 500_000.0) + rng.normal(0, 4.0, n_rows), 10, 90
    ).astype(np.int64)
    country_spec = ColumnSpec("country", "str", n_distinct=32, clustering=0.1,
                              str_groups=("EU", "US", "AP", "SA"))
    country, _ = gen_column(rng, n_rows, country_spec)
    return Table.build(
        "users",
        {"id": ids.astype(np.int64), "age": age, "country": country},
        rows_per_partition,
    )


# ---------------------------------------------------------------------------
# TPC-H-like tables (Fig. 13: clustered by l_shipdate / o_orderdate)
# ---------------------------------------------------------------------------

DATE_LO, DATE_HI = 8766, 11322  # days: 1992-01-01 .. 1998-12-31, TPC-H range


def make_lineitem(
    rng: np.random.Generator,
    n_rows: int = 300_000,
    rows_per_partition: int = 1000,
) -> Table:
    specs = [
        ColumnSpec("l_shipdate", "int", DATE_LO, DATE_HI, clustering=0.995),
        ColumnSpec("l_orderkey", "int", 0, n_rows // 4, clustering=0.97),
        ColumnSpec("l_quantity", "int", 1, 51, clustering=0.0),
        ColumnSpec("l_discount", "float", 0.0, 0.11, clustering=0.0),
        ColumnSpec("l_extendedprice", "float", 900.0, 105_000.0, clustering=0.0),
        ColumnSpec("l_returnflag", "str", n_distinct=3, clustering=0.0,
                   str_groups=("A", "N", "R")),
    ]
    return gen_table("lineitem", rng, n_rows, rows_per_partition, specs)


def make_orders(
    rng: np.random.Generator,
    n_rows: int = 75_000,
    rows_per_partition: int = 1000,
) -> Table:
    specs = [
        ColumnSpec("o_orderdate", "int", DATE_LO, DATE_HI - 151, clustering=0.995),
        ColumnSpec("o_orderkey", "int", 0, n_rows, clustering=0.97),
        ColumnSpec("o_totalprice", "float", 850.0, 560_000.0, clustering=0.0),
        ColumnSpec("o_orderpriority", "str", n_distinct=5, clustering=0.0,
                   str_groups=("1-URGENT", "2-HIGH", "3-MEDIUM", "4-LOW")),
    ]
    return gen_table("orders", rng, n_rows, rows_per_partition, specs)
