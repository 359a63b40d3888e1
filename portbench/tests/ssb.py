"""A tiny Star Schema Benchmark deployment for the CPU tests: SSB's
generator (``generators/ssb.py``) at SF 0.01's dimension counts with a
64 x 64-row ``lineorder``, and a mix of the 13 SSB queries (four flights)
in the mix language, each query's numbers drawn from the seed where the
specification's substitution allows it and its constants elsewhere."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.harness import REPO, Cell, load_json

D = ["d", "lo", "d_datekey", "lo_orderdate"]
C = ["c", "lo", "c_custkey", "lo_custkey"]
S = ["s", "lo", "s_suppkey", "lo_suppkey"]
P = ["p", "lo", "p_partkey", "lo_partkey"]


def _eq(col, value):
    return {"col": col, "op": "eq", "value": value}


def _between(col, lo, hi):
    return [{"col": col, "op": "ge", "value": lo},
            {"col": col, "op": "le", "value": hi}]


def _scans(**preds):
    tables = {"lo": "lineorder", "d": "date", "c": "customer",
              "s": "supplier", "p": "part"}
    return {a: {"table": tables[a], "pred": p} for a, p in preds.items()}


YEAR = {"int": [1992, 1999]}
UK = ["UNITED KI1", "UNITED KI5"]


def ssb_mix(kinds: Optional[Iterable[str]] = None) -> dict:
    """The 13 queries as kinds ``q1.1`` .. ``q4.3``, one each a cycle, or
    just ``kinds``."""
    disc = {"var": "disc", "add": -1}, {"var": "disc", "add": 1}
    all_kinds = {
        "q1.1": {"vars": {"disc": {"int": [1, 10]}},
                 "scans": _scans(d=[_eq("d_year", YEAR)],
                                 lo=_between("lo_discount", *disc)
                                 + [{"col": "lo_quantity", "op": "lt",
                                     "value": 25}]),
                 "joins": [D]},
        "q1.2": {"vars": {"disc": {"int": [1, 10]}},
                 "scans": _scans(
                     d=[_eq("d_yearmonthnum",
                            {"choice": [y * 100 + m for y in range(1992, 1999)
                                        for m in range(1, 13)]})],
                     lo=_between("lo_discount", *disc)
                     + _between("lo_quantity", 26, 35)),
                 "joins": [D]},
        "q1.3": {"vars": {"disc": {"int": [1, 10]}},
                 "scans": _scans(
                     d=[_eq("d_weeknuminyear", {"int": [1, 53]}),
                        _eq("d_year", YEAR)],
                     lo=_between("lo_discount", *disc)
                     + _between("lo_quantity", 26, 35)),
                 "joins": [D]},
        "q2.1": {"scans": _scans(lo=[], d=[],
                                 p=[_eq("p_category", "MFGR#12")],
                                 s=[_eq("s_region", "AMERICA")]),
                 "joins": [D, P, S]},
        "q2.2": {"scans": _scans(lo=[], d=[],
                                 p=_between("p_brand1", "MFGR#2221",
                                            "MFGR#2228"),
                                 s=[_eq("s_region", "ASIA")]),
                 "joins": [D, P, S]},
        "q2.3": {"scans": _scans(lo=[], d=[],
                                 p=[_eq("p_brand1", "MFGR#2239")],
                                 s=[_eq("s_region", "EUROPE")]),
                 "joins": [D, P, S]},
        "q3.1": {"scans": _scans(lo=[], c=[_eq("c_region", "ASIA")],
                                 s=[_eq("s_region", "ASIA")],
                                 d=_between("d_year", 1992, 1997)),
                 "joins": [C, S, D]},
        "q3.2": {"scans": _scans(lo=[], c=[_eq("c_nation", "UNITED STATES")],
                                 s=[_eq("s_nation", "UNITED STATES")],
                                 d=_between("d_year", 1992, 1997)),
                 "joins": [C, S, D]},
        "q3.3": {"scans": _scans(
                     lo=[], c=[{"col": "c_city", "op": "in", "value": UK}],
                     s=[{"col": "s_city", "op": "in", "value": UK}],
                     d=_between("d_year", 1992, 1997)),
                 "joins": [C, S, D]},
        "q3.4": {"scans": _scans(
                     lo=[], c=[{"col": "c_city", "op": "in", "value": UK}],
                     s=[{"col": "s_city", "op": "in", "value": UK}],
                     d=[_eq("d_yearmonth", "Dec1997")]),
                 "joins": [C, S, D]},
        "q4.1": {"scans": _scans(
                     lo=[], d=[], c=[_eq("c_region", "AMERICA")],
                     s=[_eq("s_region", "AMERICA")],
                     p=[{"col": "p_mfgr", "op": "in",
                         "value": ["MFGR#1", "MFGR#2"]}]),
                 "joins": [D, C, S, P]},
        "q4.2": {"scans": _scans(
                     lo=[], d=[{"col": "d_year", "op": "in",
                                "value": [1997, 1998]}],
                     c=[_eq("c_region", "AMERICA")],
                     s=[_eq("s_region", "AMERICA")],
                     p=[{"col": "p_mfgr", "op": "in",
                         "value": ["MFGR#1", "MFGR#2"]}]),
                 "joins": [D, C, S, P]},
        "q4.3": {"scans": _scans(
                     lo=[], d=[{"col": "d_year", "op": "in",
                                "value": [1997, 1998]}],
                     c=[_eq("c_region", "AMERICA")],
                     s=[_eq("s_nation", "UNITED STATES")],
                     p=[_eq("p_category", "MFGR#14")]),
                 "joins": [D, C, S, P]},
    }
    names = list(all_kinds) if kinds is None else list(kinds)
    return {"clients": 8, "deadline_s": 0.05, "rate_ceiling": 400,
            "scanned_prefix": 2 * len(names), "verify_prefix": 2 * len(names),
            "warmup_rounds": 1, "verify_rate": {"join": 1.0},
            "preds": {}, "kinds": {k: all_kinds[k] for k in names},
            "cycle": [[k, 1] for k in names]}


def ssb_config(sf: float = 0.01, partitions: int = 64, rows: int = 64,
               exact_ndv: int = 4096) -> dict:
    """SSB at scale factor ``sf`` with a lineorder of ``partitions`` x
    ``rows`` clustered on lo_orderdate, TPC-H's join guarantees."""
    guarantees = {"sound": "no partition holding a row that satisfies the "
                            "query is ever skipped",
                  "join_exact_ndv": exact_ndv,
                  "join_bloom": {"bits_per_key": 16, "enum_limit": 1024}}
    dims = {"date": 64, "customer": 64, "supplier": 8, "part": 64}
    spec = {"name": "ssb", "generator": "ssb", "scale_factor": sf,
            "clustering": 0.995,
            "lineorder": {"name": "lineorder", "partitions": partitions,
                          "rows_per_partition": rows}}
    spec.update({t: {"name": t, "rows_per_partition": r}
                 for t, r in dims.items()})
    return {"name": "ssb-tiny", "tables": [spec], "guarantees": guarantees}


def ssb_cell(kinds: Optional[Iterable[str]] = None, **config) -> Cell:
    """A cell of the tiny deployment, the benchmark's file left as it is."""
    workload = {"name": "ssb-tiny.flights", "config": "ssb-tiny",
                "traffic": "ssb-flights", "chips": 1, "why": "a test's cell"}
    return Cell(load_json(REPO / "BENCHMARK.json"), workload,
                ssb_config(**config), ssb_mix(kinds))
