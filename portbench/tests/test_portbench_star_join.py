"""Star joins, ``in`` lists and string ranges in the mix language and the
reference: the multi-join reference against a brute-force row-level
join, its three-valued ``in`` verdicts, the judge on several joins, the
Q1 flight through the port's CPU service, and ``to_port`` on a query of
several joins."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

from portbench import gen
from portbench.reference.engine import (FULL, NO, PARTIAL, Reference,
                                        probe_joins, verdicts, table_stats)
from portbench.reference.judge import judge
from portbench.traffic import Stream, port_pred, to_port

from .ssb import ssb_cell, ssb_config, ssb_mix
from .tiny import SEED, run_tiny

SHAPES = ["q1.1", "q1.2", "q1.3", "q2.1", "q2.2", "q2.3", "q3.1", "q3.2",
          "q3.3", "q3.4", "q4.1", "q4.2", "q4.3"]


def _brute_rows(t: gen.RawTable, cons) -> np.ndarray:
    """Rows satisfying ``cons``, on decoded strings, independent of the
    reference's intervals."""
    m = np.ones(t.num_rows, dtype=bool)
    for col, op, v in cons:
        c = t.columns[col]
        x = (c.dictionary[c.values.astype(np.int64)] if c.kind == "str"
             else c.values)
        if op == "in":
            m &= np.array([xi in set(v) for xi in x.tolist()], dtype=bool)
        else:
            m &= {"eq": x == v, "ge": x >= v, "gt": x > v, "le": x <= v,
                  "lt": x < v}[op]
    return m


def _brute_kept(raw, q, ids):
    """Of the probe partitions ``ids``: those holding a row that joins
    every filtered build side, and those whose key range holds a build key
    of every join (both by loops over the raw rows)."""
    (probe, joins), = probe_joins(q).items()
    ptable, pcons = q.scans[probe]
    t = raw[ptable]
    rows = _brute_rows(t, pcons)
    hold = np.ones(len(t.bounds) - 1, dtype=bool)
    for b, _p, bkey, pkey in joins:
        btable, bcons = q.scans[b]
        keys = set(raw[btable].columns[bkey].values[
            _brute_rows(raw[btable], bcons)].tolist())
        vals = t.columns[pkey].values
        rows &= np.array([v in keys for v in vals.tolist()], dtype=bool)
        for p, (a, z) in enumerate(zip(t.bounds[:-1], t.bounds[1:])):
            lo, hi = vals[a:z].min(), vals[a:z].max()
            hold[p] &= any(lo <= k <= hi for k in keys)
    joined = np.unique(np.flatnonzero(rows) // t.rows_per_partition)
    return joined, ids[hold[ids]]


@pytest.mark.parametrize("seed", [SEED + 100 * k for k in range(20)])
def test_multi_join_reference_matches_a_brute_force_join(seed):
    cell = ssb_cell()
    raw = gen.make_tables(cell.config, seed)
    ref = Reference(raw, cell.config)
    stream = Stream(cell.mix, seed)
    for i in range(len(SHAPES)):
        q = stream.spec(i)
        answer = ref.answer(q)
        ids = answer["scans"]["lo"][0]
        f_ids = np.flatnonzero(ref.verdicts(*q.scans["lo"]) > NO)
        joined, exact = _brute_kept(raw, q, f_ids)
        assert np.isin(joined, ids).all(), q.kind
        assert np.array_equal(ids, exact), q.kind
        assert judge(ref, q, answer) == []
        assert answer["tech"]["lo"]["join"][:2] == (len(f_ids), len(ids))


@pytest.mark.parametrize("seed", [SEED + 7 * k for k in range(4)])
def test_multi_join_with_bloom_summaries_keeps_every_joining_partition(seed):
    cell = ssb_cell(exact_ndv=16)
    raw = gen.make_tables(cell.config, seed)
    ref = Reference(raw, cell.config)
    stream = Stream(cell.mix, seed)
    blooms = 0
    for i in range(len(SHAPES)):
        q = stream.spec(i)
        answer = ref.answer(q)
        ids = answer["scans"]["lo"][0]
        f_ids = np.flatnonzero(ref.verdicts(*q.scans["lo"]) > NO)
        joined, exact = _brute_kept(raw, q, f_ids)
        assert np.isin(joined, ids).all(), q.kind
        assert np.isin(exact, ids).all(), q.kind
        in_range, _holds, kept = ref.probe_sets(q, "lo")
        assert not (kept & ~in_range).any()
        blooms += sum(len(ref.build_keys(q, j)) > 16 for j in q.joins
                      or (q.join,))
        assert judge(ref, q, answer) == []
    assert blooms >= 10                  # most build sides take the Bloom


def test_judge_fails_a_multi_join_answer_that_drops_or_keeps_one():
    cell = ssb_cell(["q4.2"])
    raw = gen.make_tables(cell.config, SEED)
    ref = Reference(raw, cell.config)
    q = Stream(cell.mix, SEED).spec(0)
    assert len(q.joins) == 4 and q.join is None
    good = ref.answer(q)
    ids, match = good["scans"]["lo"]
    assert 0 < len(ids) < 64
    before = good["tech"]["lo"]["join"][0]
    dropped = copy.deepcopy(good)
    dropped["scans"]["lo"] = (ids[1:], match[1:])
    dropped["tech"]["lo"]["join"] = (before, len(ids) - 1, {})
    assert judge(ref, q, dropped) == ["join"]
    f_ids = np.flatnonzero(ref.verdicts(*q.scans["lo"]) > NO)
    extra = np.setdiff1d(f_ids, ids)[:1]
    kept = np.sort(np.concatenate([ids, extra]))
    v = ref.verdicts(*q.scans["lo"])
    more = copy.deepcopy(good)
    more["scans"]["lo"] = (kept, v[kept])
    more["tech"]["lo"]["join"] = (before, len(kept), {})
    assert judge(ref, q, more) == ["join"]
    miscounted = copy.deepcopy(good)
    miscounted["tech"]["lo"]["join"] = (before, len(ids) + 1, {})
    assert judge(ref, q, miscounted) == ["join"]


def test_a_build_side_that_is_also_a_probe_is_refused():
    mix = ssb_mix(["q2.1"])
    mix["kinds"]["q2.1"]["joins"].append(["lo", "p", "lo_partkey",
                                          "p_partkey"])
    q = Stream(mix, SEED).spec(0)
    ref = Reference(gen.make_tables(ssb_config(), SEED), ssb_config())
    with pytest.raises(ValueError, match="star joins"):
        ref.answer(q)


def test_the_q1_flight_through_the_cpu_service_is_correct():
    cell = ssb_cell(["q1.1", "q1.2", "q1.3"])
    res = run_tiny(cell, seconds=0.5)
    assert res["judged"] >= 6 and not any(res["checks"].values())
    reps = [a["tech"]["lo"]["join"] for a in res["run"].answers.values()]
    assert reps and all(after < before for before, after, _d in reps)


def test_to_port_names_the_field_a_query_of_several_joins_needs(
        monkeypatch):
    from repro_torch.core import expr as E
    from repro_torch.core import flow

    cell = ssb_cell(["q1.1", "q2.1"])
    raw = gen.make_tables(cell.config, SEED)
    from portbench.harness import port_tables
    tables = port_tables(raw)
    stream = Stream(cell.mix, SEED)
    one, three = stream.spec(0), stream.spec(1)
    assert one.join == ("d", "lo", "d_datekey", "lo_orderdate")
    assert len(three.joins) == 3
    q = to_port(one, tables)
    assert q.join.probe_key == "lo_orderdate"
    if "joins" not in {f.name for f in dataclasses.fields(flow.Query)}:
        with pytest.raises(TypeError, match=r"Query\.joins"):
            to_port(three, tables)

    @dataclasses.dataclass
    class QueryWithJoins(flow.Query):
        joins: list = dataclasses.field(default_factory=list)

    monkeypatch.setattr(flow, "Query", QueryWithJoins)
    q = to_port(three, tables)
    assert q.join is None
    assert [j.build for j in q.joins] == ["d", "p", "s"]
    assert isinstance(port_pred([("c_city", "in", ("A", "B"))]), E.InSet)


def test_a_kind_with_join_and_joins_is_refused():
    mix = ssb_mix(["q1.1"])
    mix["kinds"]["q1.1"]["join"] = ["d", "lo", "d_datekey", "lo_orderdate"]
    with pytest.raises(ValueError, match="not both"):
        Stream(mix, SEED)


def test_in_values_are_drawn_and_kept_as_a_tuple():
    mix = ssb_mix(["q4.2"])
    mix["kinds"]["q4.2"]["scans"]["d"]["pred"] = [
        {"col": "d_year", "op": "in",
         "value": [1997, {"int": [1992, 1995]}]}]
    s = Stream(mix, SEED)
    seen = set()
    for i in range(20):
        (_col, op, v), = s.spec(i).scans["d"][1]
        assert op == "in" and isinstance(v, tuple) and v[0] == 1997
        seen.add(v[1])
    assert seen <= {1992, 1993, 1994} and len(seen) > 1


def _one_column_table(kind, values, dictionary=None, rows=2):
    return gen.RawTable("t", {"x": gen.RawColumn(
        kind, np.asarray(values, dtype=np.float64), dictionary)}, rows)


def test_in_verdicts_are_three_valued_min_max():
    t = _one_column_table("int", [5, 5, 3, 9, 6, 8, 1, 2])
    st = table_stats(t)
    # partitions [5,5], [3,9], [6,8], [1,2]
    got = verdicts(t, st, [("x", "in", (5, 7))])
    assert got.tolist() == [FULL, PARTIAL, PARTIAL, NO]
    got = verdicts(t, st, [("x", "in", (4,))])
    assert got.tolist() == [NO, PARTIAL, NO, NO]
    ref = Reference({"t": t}, {})
    assert ref.rows("t", [("x", "in", (5, 7, 9))]).tolist() == [
        True, True, False, True, False, False, False, False]


def test_string_ranges_and_in_follow_the_dictionary():
    d = np.array(["MFGR#221", "MFGR#2221", "MFGR#2228", "MFGR#2229",
                  "MFGR#23"])
    t = _one_column_table("str", [0, 1, 2, 3, 4, 4], d)
    st = table_stats(t)
    between = [("x", "ge", "MFGR#2221"), ("x", "le", "MFGR#2228")]
    ref = Reference({"t": t}, {})
    assert ref.rows("t", between).tolist() == [False, True, True, False,
                                               False, False]
    assert verdicts(t, st, between).tolist() == [PARTIAL, PARTIAL, NO]
    assert ref.rows("t", [("x", "gt", "MFGR#2228"), ("x", "lt", "MFGR#24")]
                    ).tolist() == [False, False, False, True, True, True]
    assert ref.rows("t", [("x", "lt", "A")]).tolist() == [False] * 6
    assert ref.rows("t", [("x", "in", ("MFGR#23", "MFGR#22", "MFGR#2210"))]
                    ).tolist() == [False] * 4 + [True, True]
    assert verdicts(t, st, [("x", "in", ("MFGR#23",))]).tolist() == [
        NO, NO, FULL]
