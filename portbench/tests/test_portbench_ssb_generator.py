"""The Star Schema Benchmark's generator, found by name in
``portbench/generators/``, and the relations its tables hold."""

from __future__ import annotations

import datetime

import numpy as np
import pytest

from portbench import gen
from portbench.generators import ssb

from .ssb import ssb_config
from .tiny import SEED


def _strings(col: gen.RawColumn) -> np.ndarray:
    return col.dictionary[col.values.astype(np.int64)]


def test_make_tables_finds_a_generator_in_its_own_file():
    assert "ssb" not in gen.GENERATORS
    assert gen.generator("ssb") is ssb.generate
    raw = gen.make_tables(ssb_config(), SEED)
    assert set(raw) == {"lineorder", "date", "customer", "supplier", "part"}
    for name in ("no_such_generator", "../gen"):
        with pytest.raises(KeyError) as e:
            gen.make_tables({"tables": [{"generator": name}]}, SEED)
        if name == "no_such_generator":
            assert "gen.GENERATORS" in str(e.value)
            assert "portbench/generators/no_such_generator.py" in str(e.value)


def test_the_built_in_generators_stay_where_they_are():
    assert set(gen.GENERATORS) == {"columns", "users", "tpch"}
    for name, fn in gen.GENERATORS.items():
        assert gen.generator(name) is fn


@pytest.fixture(scope="module", params=[SEED, 3])
def tables(request):
    return gen.make_tables(ssb_config(), request.param)


def test_row_counts_and_partitions(tables):
    counts = {"lineorder": 64 * 64, "date": 2557, "customer": 300,
              "supplier": 20, "part": 2000}
    rpp = {"lineorder": 64, "date": 64, "customer": 64, "supplier": 8,
           "part": 64}
    for name, t in tables.items():
        assert t.num_rows == counts[name], name
        assert t.rows_per_partition == rpp[name]
        assert len(t.bounds) - 1 == -(-counts[name] // rpp[name])
    assert ssb.part_rows(1000) == 2_000_000 and ssb.part_rows(1) == 200_000
    assert ssb.part_rows(0.01) == 2000


def test_the_date_dimension_is_complete_and_consistent(tables):
    d = tables["date"].columns
    first = datetime.date(1992, 1, 1)
    days = [first + datetime.timedelta(n) for n in range(2557)]
    assert days[-1] == datetime.date(1998, 12, 31)
    key = np.array([x.year * 10000 + x.month * 100 + x.day for x in days])
    assert np.array_equal(d["d_datekey"].values, key)
    assert np.array_equal(d["d_year"].values, key // 10000)
    assert np.array_equal(d["d_yearmonthnum"].values, key // 100)
    assert list(_strings(d["d_yearmonth"])) == [x.strftime("%b%Y")
                                                for x in days]
    week = [(x.timetuple().tm_yday - 1) // 7 + 1 for x in days]
    assert np.array_equal(d["d_weeknuminyear"].values, week)


def test_every_foreign_key_hits_a_row(tables):
    lo = tables["lineorder"].columns
    for fk, (dim, key) in {"lo_orderdate": ("date", "d_datekey"),
                           "lo_custkey": ("customer", "c_custkey"),
                           "lo_suppkey": ("supplier", "s_suppkey"),
                           "lo_partkey": ("part", "p_partkey")}.items():
        keys = tables[dim].columns[key].values
        assert np.array_equal(keys, np.arange(1, len(keys) + 1)) \
            or dim == "date"
        assert np.isin(lo[fk].values, keys).all(), fk
    dates = lo["lo_orderdate"].values
    assert dates.min() >= 19920101 and dates.max() <= 19980802
    assert set(np.unique(lo["lo_quantity"].values)) <= set(range(1, 51))
    assert set(np.unique(lo["lo_discount"].values)) <= set(range(0, 11))


def test_lineorder_is_clustered_on_its_order_date(tables):
    t = tables["lineorder"]
    d = t.columns["lo_orderdate"].values
    mid = np.array([np.median(d[a:b]) for a, b in zip(t.bounds[:-1],
                                                      t.bounds[1:])])
    assert (np.diff(mid) >= 0).mean() > 0.9


@pytest.mark.parametrize("prefix,dim", [("c", "customer"), ("s", "supplier")])
def test_a_city_lies_in_its_nation_and_its_nation_in_its_region(tables,
                                                                prefix, dim):
    cols = tables[dim].columns
    city = _strings(cols[f"{prefix}_city"])
    nation = _strings(cols[f"{prefix}_nation"])
    region = _strings(cols[f"{prefix}_region"])
    region_of = dict(zip(ssb.NATION_NAMES,
                         (ssb.REGIONS[r] for r in ssb.REGION_OF)))
    for c, n, r in zip(city, nation, region):
        assert c[:9] == n[:9].ljust(9) and c[9] in "0123456789"
        assert region_of[n] == r
    assert len(ssb.CITIES) == 250 and "UNITED KI1" in ssb.CITIES
    assert region_of["UNITED STATES"] == "AMERICA"
    assert region_of["CHINA"] == "ASIA"


def test_a_brand_lies_in_its_category_and_its_category_in_its_mfgr(tables):
    cols = tables["part"].columns
    mfgr, cat, brand = (_strings(cols[c]) for c in
                        ("p_mfgr", "p_category", "p_brand1"))
    for m, c, b in zip(mfgr, cat, brand):
        assert m in {f"MFGR#{i}" for i in range(1, 6)}
        assert c[:6] == m and 1 <= int(c[6:]) <= 5
        assert b[:7] == c and 1 <= int(b[7:]) <= 40
    assert len(cols["p_brand1"].dictionary) <= 1000


def test_predicate_columns_are_exact_in_float32(tables):
    keys = {"d_datekey", "lo_orderdate"}
    for t in tables.values():
        for name, col in t.columns.items():
            f32 = col.values.astype(np.float32).astype(np.float64)
            assert np.array_equal(f32, col.values) or name in keys, name
    assert tables["date"].columns["d_datekey"].values.min() > 2 ** 24


def test_the_generator_is_deterministic_by_seed():
    cfg = ssb_config()
    a, b = gen.make_tables(cfg, SEED), gen.make_tables(cfg, SEED)
    c = gen.make_tables(cfg, SEED + 1)
    for t in a:
        for col in a[t].columns:
            assert np.array_equal(a[t].columns[col].values,
                                  b[t].columns[col].values)
    assert not np.array_equal(a["lineorder"].columns["lo_custkey"].values,
                              c["lineorder"].columns["lo_custkey"].values)
