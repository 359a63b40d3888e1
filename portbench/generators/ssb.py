"""The Star Schema Benchmark's tables, as its specification relates them.

Source: P. O'Neil, E. O'Neil, X. Chen, S. Revilak, "The Star Schema
Benchmark and Augmented Fact Table Indexing", TPCTC 2009, and the SSB
specification (rev. 3).  Only the columns the 13 queries read are made:

  lineorder  lo_orderdate, lo_custkey, lo_partkey, lo_suppkey,
             lo_quantity (1-50), lo_discount (0-10)
  date       d_datekey (yyyymmdd), d_year, d_yearmonthnum (yyyymm),
             d_yearmonth ('Jan1994'), d_weeknuminyear
  customer   c_custkey, c_region, c_nation, c_city
  supplier   s_suppkey, s_region, s_nation, s_city
  part       p_partkey, p_mfgr, p_category, p_brand1

Attributes: the five TPC-H regions and their 25 nations; a city is its
nation's name cut or padded to 9 characters and a digit 0-9; ``p_mfgr``
'MFGR#1'-'MFGR#5', ``p_category`` the manufacturer and 1-5 (25),
``p_brand1`` the category and 1-40 (1,000).

Scale: the table spec's ``scale_factor`` SF gives the dimensions' full
row counts (customer 30,000 x SF, supplier 2,000 x SF, part 200,000 x
(1 + floor(log2 SF)), or 200,000 x SF below SF 1), with dense keys 1..N
as dbgen numbers them, in key order, ``rows_per_partition`` rows a
partition.  ``date`` is complete: every day of 1992-1998.  ``lineorder``
has ``partitions x rows_per_partition`` rows; its foreign keys are
uniform over the dimensions' keys, so every key hits a row, and
``lo_orderdate`` is uniform over TPC-H's order dates (1992-01-01 to
1998-08-02), the table clustered on it with displacement ``clustering``
(as ``gen.gen_tpch`` clusters ``lineitem``).

Every column a predicate reads is exact in float32.  Join keys are not
all: ``d_datekey`` and ``lo_orderdate`` lie above 2^24 at every scale
(yyyymmdd), and ``c_custkey`` / ``lo_custkey`` from SF 560.  The
reference judges in float64, which is the truth.

The table spec::

  {"name": ..., "generator": "ssb", "scale_factor": SF, "clustering": c,
   "lineorder": {"name", "partitions", "rows_per_partition"},
   "date" | "customer" | "supplier" | "part": {"name",
                                               "rows_per_partition"}}
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .. import gen
from ..gen import RawColumn, RawTable

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# TPC-H's NATION table: (name, region), by n_nationkey.
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
NATION_NAMES = [n for n, _ in NATIONS]
REGION_OF = np.array([r for _, r in NATIONS])
CITIES = [f"{n[:9]:<9}{d}" for n in NATION_NAMES for d in range(10)]
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]
FIRST_DAY, LAST_DAY = gen.epoch_day("1992-01-01"), gen.epoch_day("1998-12-31")
# TPC-H's o_orderdate range, STARTDATE to ENDDATE - 151 days.
ORDER_LAST = gen.TPCH_END - 151


def part_rows(sf: float) -> int:
    if sf >= 1.0:
        return int(200_000 * (1 + math.floor(math.log2(sf))))
    return max(int(200_000 * sf), 1)


def _keys(n: int) -> RawColumn:
    return RawColumn("int", np.arange(1, n + 1, dtype=np.float64))


def _int(values: np.ndarray) -> RawColumn:
    return RawColumn("int", values.astype(np.float64))


def _geo(prefix: str, n: int, rng: np.random.Generator) -> dict:
    """Region, nation and city of n rows: a uniform nation, its region, one
    of its ten cities."""
    nation = rng.integers(0, len(NATIONS), size=n, dtype=np.int16)
    city = nation * 10 + rng.integers(0, 10, size=n, dtype=np.int16)
    return {f"{prefix}_region": gen._dict_col(REGIONS, REGION_OF[nation]),
            f"{prefix}_nation": gen._dict_col(NATION_NAMES, nation),
            f"{prefix}_city": gen._dict_col(CITIES, city)}


def date_table() -> dict:
    """Every day of 1992-1998 in key order."""
    days = np.arange(FIRST_DAY, LAST_DAY + 1).astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month0 = days.astype("datetime64[M]").astype(np.int64) % 12
    mday = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    yday0 = (days - days.astype("datetime64[Y]")).astype(np.int64)
    key = year * 10000 + (month0 + 1) * 100 + mday
    months = [f"{m}{y}" for y in range(1992, 1999) for m in MONTHS]
    return {"d_datekey": _int(key), "d_year": _int(year),
            "d_yearmonthnum": _int(year * 100 + month0 + 1),
            "d_yearmonth": gen._dict_col(months, (year - 1992) * 12 + month0),
            "d_weeknuminyear": _int(yday0 // 7 + 1)}


def generate(tspec: dict, seed: int, salt: int) -> List[RawTable]:
    sf = float(tspec["scale_factor"])
    n_cust, n_supp, n_part = int(30_000 * sf), int(2_000 * sf), part_rows(sf)
    rng = [gen.rng_for(seed, salt, k) for k in range(4)]

    date = date_table()
    cust = {"c_custkey": _keys(n_cust), **_geo("c", n_cust, rng[0])}
    supp = {"s_suppkey": _keys(n_supp), **_geo("s", n_supp, rng[1])}
    r = rng[2]
    cat = r.integers(0, 25, size=n_part, dtype=np.int16)   # mfgr 5 x 1-5
    brand = cat * 40 + r.integers(0, 40, size=n_part, dtype=np.int16)
    cats = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
    part = {"p_partkey": _keys(n_part),
            "p_mfgr": gen._dict_col([f"MFGR#{m}" for m in range(1, 6)],
                                    cat // 5),
            "p_category": gen._dict_col(cats, cat),
            "p_brand1": gen._dict_col([f"{c}{b}" for c in cats
                                       for b in range(1, 41)], brand)}

    lo = tspec["lineorder"]
    r = rng[3]
    n = int(lo["partitions"]) * int(lo["rows_per_partition"])
    day = r.integers(FIRST_DAY, ORDER_LAST + 1, size=n)
    cols = {"lo_orderdate": date["d_datekey"].values[day - FIRST_DAY],
            "lo_custkey": r.integers(1, n_cust + 1, size=n),
            "lo_partkey": r.integers(1, n_part + 1, size=n),
            "lo_suppkey": r.integers(1, n_supp + 1, size=n),
            "lo_quantity": r.integers(1, 51, size=n),
            "lo_discount": r.integers(0, 11, size=n)}
    order = gen._clustered(day, float(tspec["clustering"]), r)
    lineorder = {c: _int(v[order]) for c, v in cols.items()}

    def table(key: str, columns: dict) -> RawTable:
        t = tspec[key]
        return RawTable(t["name"], columns, int(t["rows_per_partition"]))

    return [table("lineorder", lineorder), table("date", date),
            table("customer", cust), table("supplier", supp),
            table("part", part)]
