"""The benchmark's own table generator, vectorised and frozen.

It follows the shapes of the port's ``data/generator.py`` and of the
paper-figure workloads (an events fact table clustered on ingestion time,
a users dimension whose age anti-correlates with its id, TPC-H's
``orders`` and ``lineitem`` clustered on their dates), but it is written
here and never imports them, so a later change to the program cannot move
the yardstick.  Columns are made as encoded float64 arrays (dictionary
codes for strings) in a few bulk NumPy calls, without per-row strings.

Every value is exact in float32 as well as float64: integers stay below
2^24 where a predicate reads them, and float columns are multiples of
2^-24.  The port stages its metadata planes in float32 with outward
rounding, which is exact on such values, so its answers are held to the
float64 reference with no tolerance (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import re
from typing import Callable, Dict, List, Optional

import numpy as np


def seed_key(seed: int) -> int:
    """A seed as a non-negative int NumPy's SeedSequence accepts."""
    return int(seed) % (1 << 64)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed_key(seed), *salt])


@dataclasses.dataclass
class RawColumn:
    kind: str                           # 'int' | 'float' | 'str'
    values: np.ndarray                  # float64 values / dictionary codes
    dictionary: Optional[np.ndarray] = None   # sorted str array ('str')


@dataclasses.dataclass
class RawTable:
    name: str
    columns: Dict[str, RawColumn]
    rows_per_partition: int

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())).values)

    @property
    def bounds(self) -> np.ndarray:
        b = np.arange(0, self.num_rows, self.rows_per_partition,
                      dtype=np.int64)
        return np.append(b, self.num_rows)


def argsort(keys: np.ndarray) -> np.ndarray:
    """A stable argsort; on the card when there is one (a few ms for 2^24
    keys against ~2 s on the host), with the same result."""
    try:
        import torch
        if torch.cuda.is_available():
            t = torch.from_numpy(np.ascontiguousarray(keys)).cuda()
            return torch.argsort(t, stable=True).cpu().numpy()
    except ImportError:
        pass
    return np.argsort(keys, kind="stable")


def sort(vals: np.ndarray) -> np.ndarray:
    return vals[argsort(vals)]


def displace(order: np.ndarray, clustering: float,
             rng: np.random.Generator) -> np.ndarray:
    """Rows in sorted ``order`` moved by Normal(0, (1 - clustering) * n)
    positions: 1 keeps the sort, 0 shuffles (the clustering knob of the
    paper's Sec. 1 argument: pruning depends on how data is laid out)."""
    n = len(order)
    if clustering >= 1.0 or n <= 1:
        return order
    if clustering <= 0.0:
        return order[rng.permutation(n)]
    keys = rng.normal(0.0, (1.0 - clustering) * n, size=n)
    keys += np.arange(n, dtype=np.float64)
    return order[argsort(keys)]


def str_domain(groups: List[str], n_distinct: int) -> List[str]:
    per = max(n_distinct // len(groups), 1)
    return [f"{g}-{i:05d}" for g in groups for i in range(per)]


def gen_column(spec: dict, n: int, rng: np.random.Generator) -> RawColumn:
    """One column from its config entry: ``kind``, ``low``/``high`` (ints:
    [low, high)), ``clustering``, ``quantum`` (floats: multiples of it),
    ``groups``/``n_distinct`` (strings: ``<group>-<5 digits>``)."""
    kind, c = spec["kind"], float(spec.get("clustering", 0.0))
    if kind == "str":
        dom = np.array(str_domain(spec["groups"], spec["n_distinct"]))
        dictionary = np.unique(dom)
        code_of = np.searchsorted(dictionary, dom).astype(np.float64)
        idx = sort(rng.integers(0, len(dom), size=n))
        return RawColumn("str", code_of[displace(idx, c, rng)], dictionary)
    if kind == "float":
        q = float(spec["quantum"])
        lo, hi = int(spec["low"] / q), int(spec["high"] / q)
        vals = rng.integers(lo, hi, size=n).astype(np.float64) * q
        if c > 0.0:
            vals = displace(sort(vals), c, rng)
        return RawColumn("float", vals)
    vals = sort(rng.integers(int(spec["low"]), int(spec["high"]), size=n))
    return RawColumn("int", displace(vals, c, rng).astype(np.float64))


def gen_columns(tspec: dict, seed: int, salt: int) -> List[RawTable]:
    """A fact table of independent clustered columns (``columns``)."""
    rng = rng_for(seed, salt)
    n = int(tspec["partitions"]) * int(tspec["rows_per_partition"])
    cols = {c["name"]: gen_column(c, n, rng) for c in tspec["columns"]}
    return [RawTable(tspec["name"], cols, int(tspec["rows_per_partition"]))]


def gen_users(tspec: dict, seed: int, salt: int) -> List[RawTable]:
    """A dimension whose ids are assigned chronologically, so age falls with
    id: a selective age predicate gives a narrow id range (Sec. 8.3)."""
    rng = rng_for(seed, salt)
    n, dom = int(tspec["rows"]), int(tspec["id_domain"])
    ids = np.sort(rng.choice(dom, size=n, replace=False))
    age = np.clip(90.0 - ids * (70.0 / dom) + rng.normal(0.0, 4.0, n),
                  10, 90).astype(np.int64)
    country = gen_column(dict(kind="str", groups=["EU", "US", "AP", "SA"],
                              n_distinct=32, clustering=0.1), n, rng)
    cols = {"id": RawColumn("int", ids.astype(np.float64)),
            "age": RawColumn("int", age.astype(np.float64)),
            "country": country}
    return [RawTable(tspec["name"], cols, int(tspec["rows_per_partition"]))]


def epoch_day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


# TPC-H v3 (Sec. 4.2.3): STARTDATE 1992-01-01, ENDDATE 1998-12-31,
# CURRENTDATE 1995-06-17; o_orderdate in [STARTDATE, ENDDATE - 151 days].
TPCH_START, TPCH_END = epoch_day("1992-01-01"), epoch_day("1998-12-31")
TPCH_CURRENT = epoch_day("1995-06-17")
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]


def _clustered(order_key: np.ndarray, clustering: float,
               rng: np.random.Generator) -> np.ndarray:
    """Row order of a table clustered on ``order_key`` (then displaced)."""
    return displace(argsort(order_key), clustering, rng)


def _dict_col(strings: List[str], idx: np.ndarray) -> RawColumn:
    dictionary = np.unique(np.array(strings))
    code_of = np.searchsorted(dictionary, np.array(strings))
    return RawColumn("str", code_of[idx].astype(np.float64), dictionary)


def gen_tpch(tspec: dict, seed: int, salt: int) -> List[RawTable]:
    """``orders`` and ``lineitem`` as dbgen relates them, at the scale
    factor's key domain and fewer rows a partition.

    Keys: the scale factor's 1.5e6 * SF orders, numbered sparsely as dbgen
    does (8 of every 32), of which a uniform sample is kept; so keys span
    up to 6e9 and carry no order in time.  Dates: o_orderdate uniform,
    l_shipdate = o_orderdate + U[1, 121], l_receiptdate = l_shipdate +
    U[1, 30]; returnflag R or A once received by CURRENTDATE, else N.
    Prices and discounts are NUMBER(15, 2), kept as scaled integers
    (cents, hundredths) as the warehouse stores them.  Each table is
    clustered on its date with displacement ``clustering``."""
    rng = rng_for(seed, salt)
    o = tspec["orders"]
    li = tspec["lineitem"]
    n_o = int(o["partitions"]) * int(o["rows_per_partition"])
    n_l = int(li["partitions"]) * int(li["rows_per_partition"])
    n_orders_sf = int(1_500_000 * float(tspec["scale_factor"]))
    j = np.sort(rng.choice(n_orders_sf, size=n_o, replace=False))
    okey = (j // 8) * 32 + (j % 8) + 1
    odate = rng.integers(TPCH_START, TPCH_END - 151 + 1, size=n_o)
    oprice = rng.integers(85_000, 56_000_000, size=n_o)
    oprio = rng.integers(0, len(PRIORITIES), size=n_o)

    lines = rng.integers(1, 8, size=n_o)
    parent = np.repeat(np.arange(n_o), lines)[:n_l]
    if parent.size < n_l:
        parent = np.concatenate(
            [parent, np.sort(rng.integers(0, n_o, size=n_l - parent.size))])
    ship = odate[parent] + rng.integers(1, 122, size=n_l)
    receipt = ship + rng.integers(1, 31, size=n_l)
    qty = rng.integers(1, 51, size=n_l)
    disc = rng.integers(0, 11, size=n_l)
    price = qty * rng.integers(90_000, 210_001, size=n_l)
    flag = np.where(receipt <= TPCH_CURRENT,
                    rng.integers(0, 2, size=n_l) * 2, 1)   # A=0, N=1, R=2

    c = float(tspec["clustering"])
    ro = _clustered(odate, c, rng)
    rl = _clustered(ship, c, rng)
    orders = RawTable(o["name"], {
        "o_orderdate": RawColumn("int", odate[ro].astype(np.float64)),
        "o_orderkey": RawColumn("int", okey[ro].astype(np.float64)),
        "o_totalprice": RawColumn("int", oprice[ro].astype(np.float64)),
        "o_orderpriority": _dict_col(PRIORITIES, oprio[ro]),
    }, int(o["rows_per_partition"]))
    lineitem = RawTable(li["name"], {
        "l_shipdate": RawColumn("int", ship[rl].astype(np.float64)),
        "l_receiptdate": RawColumn("int", receipt[rl].astype(np.float64)),
        "l_orderkey": RawColumn("int", okey[parent][rl].astype(np.float64)),
        "l_quantity": RawColumn("int", qty[rl].astype(np.float64)),
        "l_discount": RawColumn("int", disc[rl].astype(np.float64)),
        "l_extendedprice": RawColumn("int", price[rl].astype(np.float64)),
        "l_returnflag": _dict_col(["A", "N", "R"], flag[rl]),
    }, int(li["rows_per_partition"]))
    return [orders, lineitem]


GENERATORS = {"columns": gen_columns, "users": gen_users, "tpch": gen_tpch}


def generator(name: str) -> Callable[[dict, int, int], List[RawTable]]:
    """A table spec's ``generator``: one of ``GENERATORS``, else the
    ``generate(tspec, seed, salt)`` of ``generators/<name>.py``, so a new
    schema comes as a file of its own."""
    if name in GENERATORS:
        return GENERATORS[name]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise KeyError(f"generator {name!r} is not a module name")
    try:
        module = importlib.import_module(f"{__package__}.generators.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.generators.{name}":
            raise
        raise KeyError(f"no generator {name!r}: neither in gen.GENERATORS "
                       f"nor a module portbench/generators/{name}.py"
                       ) from None
    return module.generate


def make_tables(config: dict, seed: int) -> Dict[str, RawTable]:
    """Every table of a configuration, from the seed alone."""
    out: Dict[str, RawTable] = {}
    for salt, tspec in enumerate(config["tables"]):
        for t in generator(tspec["generator"])(tspec, seed, salt + 1):
            out[t.name] = t
    return out


def sample_limit_k(rng: np.random.Generator) -> int:
    """The LIMIT k of Fig. 6: 97% of queries k <= 10,000, 99.9% k <=
    2,000,000, most of the mass at 0 (schema fetches) and 1."""
    u = rng.random()
    if u < 0.28:
        return 0
    if u < 0.48:
        return 1
    if u < 0.62:
        return int(rng.choice([10, 25, 50, 100]))
    if u < 0.97:
        return int(np.exp(rng.uniform(np.log(2), np.log(10_000))))
    if u < 0.999:
        return int(np.exp(rng.uniform(np.log(10_000), np.log(2_000_000))))
    return int(np.exp(rng.uniform(np.log(2_000_000), np.log(20_000_000))))
