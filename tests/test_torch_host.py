"""Host engine of the PyTorch port against the JAX package's, bit for bit.

The port (``repro_torch``) keeps its own copies of the NumPy host modules
(expr, metadata, intervals, rewrite, rowval, prune_filter, prune_limit,
data.table, data.generator).  The same numpy-seeded inputs go through
both packages and every output must be identical: the three-valued
verdicts, the lowered ranges, the partition stats and the LIMIT cuts.

The predicate and table builders here are shared by the other
``test_torch_*`` modules.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import expr as RE
from repro.core import metadata as RM
from repro.core import prune_filter as RF
from repro.core import prune_limit as RL
from repro.data import generator as RG
from repro.data.table import Table as RTable

from repro_torch.core import expr as TE
from repro_torch.core import metadata as TM
from repro_torch.core import prune_filter as TF
from repro_torch.core import prune_limit as TL
from repro_torch.data import generator as TG
from repro_torch.data.table import Table as TTable

torch.set_num_threads(1)

STR_DOMAIN = [
    "Alpine Chough", "Alpine Ibex", "Alpine Marmot", "Alpine Salamander",
    "Bear", "Duck", "Eagle", "Frog", "Pike", "Wolf",
]
PREFIXES = ["Alpine", "Alpine I", "B", "Z", ""]
PATTERNS = ["Alpine%", "%mot", "Alpine%mot", "Bear", "%", "A%e%t"]
OPS = [">", ">=", "<", "<=", "==", "!="]


# ---------------------------------------------------------------------------
# shared builders: one numpy-drawn spec, built in either package
# ---------------------------------------------------------------------------

def pred_spec(rng, depth=0):
    """A random predicate tree over x (int), y (int), s (str), drawn like
    the reference suite's ``helpers.predicates`` strategy."""
    choice = int(rng.integers(0, 6 if depth >= 2 else 9))
    if choice == 0:
        return ("cmp", ">", "x", int(rng.integers(-60, 61)))
    if choice == 1:
        return ("cmp", "<=", "x", int(rng.integers(-60, 61)))
    if choice == 2:
        return ("cmp", "==", "y", int(rng.integers(0, 1001)))
    if choice == 3:
        return ("cmp", OPS[int(rng.integers(0, 6))], "x",
                int(rng.integers(-60, 61)))
    if choice == 4:
        return ("startswith", "s", PREFIXES[int(rng.integers(0, 5))])
    if choice == 5:
        return ("like", "s", PATTERNS[int(rng.integers(0, 6))])
    if choice == 6:
        return ("not", pred_spec(rng, depth + 1))
    kind = "and" if choice == 7 else "or"
    return (kind, pred_spec(rng, depth + 1), pred_spec(rng, depth + 1))


def build_pred(spec, E):
    """Build a ``pred_spec`` tree with an expression module ``E``."""
    kind = spec[0]
    if kind == "true":
        return E.true()
    if kind == "cmp":
        _, op, col, v = spec
        return E.Cmp(op, E.col(col), E.Lit(v))
    if kind == "startswith":
        return E.startswith(E.col(spec[1]), spec[2])
    if kind == "like":
        return E.like(E.col(spec[1]), spec[2])
    if kind == "not":
        return E.Not(build_pred(spec[1], E))
    if kind == "and":
        return E.And((build_pred(spec[1], E), build_pred(spec[2], E)))
    if kind == "or":
        return E.Or((build_pred(spec[1], E), build_pred(spec[2], E)))
    if kind == "range":                       # lo <= col <= hi
        _, col, lo, hi = spec
        return (E.col(col) >= lo) & (E.col(col) <= hi)
    if kind == "ge":
        return E.col(spec[1]) >= spec[2]
    raise ValueError(kind)


def table_raw(rng, n=None, with_nulls=True):
    """Raw columns for a small x/y/s table, like ``helpers.small_tables``."""
    n = int(rng.integers(4, 121)) if n is None else n
    rows_pp = int(rng.integers(2, max(3, n // 2 + 1)))
    x = rng.integers(-50, 51, n).astype(np.int64)
    if rng.random() < 0.5:
        x = np.sort(x)
    raw = {"x": x, "y": rng.integers(0, 1001, n).astype(np.int64),
           "s": np.array([STR_DOMAIN[i] for i in rng.integers(0, 10, n)])}
    nulls = {}
    if with_nulls and rng.random() < 0.5:
        nulls["x"] = rng.random(n) < 0.3
    return raw, rows_pp, nulls


def both_tables(raw, rows_pp, nulls, name="t"):
    return (RTable.build(name, raw, rows_pp, nulls),
            TTable.build(name, raw, rows_pp, nulls))


def port_pred(node):
    """The port's copy of a reference predicate (or expression): each
    node rebuilt as the port's class of the same name."""
    if isinstance(node, (list, tuple)):
        return tuple(port_pred(c) for c in node)
    if dataclasses.is_dataclass(node):
        cls = getattr(TE, type(node).__name__)
        return cls(**{f.name: port_pred(getattr(node, f.name))
                      for f in dataclasses.fields(node)})
    return node


def port_table(rt):
    """The port's copy of a reference table, carried over array for array
    (``Table.from_arrays``; the stats are recomputed)."""
    return TTable.from_arrays(rt.name, rt.columns, rt.data, rt.nulls,
                              rt.part_bounds)


def assert_stats_equal(a, b):
    for f in ("mins", "maxs", "null_counts", "row_counts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert [c.name for c in a.columns] == [c.name for c in b.columns]
    assert [c.kind for c in a.columns] == [c.kind for c in b.columns]
    for ca, cb in zip(a.columns, b.columns):
        if ca.dictionary is None:
            assert cb.dictionary is None
        else:
            np.testing.assert_array_equal(ca.dictionary, cb.dictionary)


# ---------------------------------------------------------------------------
# filter pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(16))
def test_eval_tv_and_extract_ranges_match_reference(seed):
    rng = np.random.default_rng(seed)
    rt, tt = both_tables(*table_raw(rng))
    assert_stats_equal(rt.stats, tt.stats)
    for _ in range(24):
        spec = pred_spec(rng)
        rp, tp = build_pred(spec, RE), build_pred(spec, TE)
        assert RE.canonical_key(rp) == TE.canonical_key(tp)
        want = RF.eval_tv(rp, rt.stats)
        got = TF.eval_tv(tp, tt.stats)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=repr(rp))
        assert TF.extract_ranges(tp, tt.stats) == \
            RF.extract_ranges(rp, rt.stats), repr(rp)


@pytest.mark.parametrize("seed", range(6))
def test_row_matches_equal_reference(seed):
    """Row-level evaluation, LIKE included, over a whole table (LIKE
    matched once a dictionary entry) and over single partitions (fewer
    rows than dictionary entries: matched a row at a time)."""
    from repro.core.rowval import matches as r_matches
    from repro_torch.core.rowval import matches as t_matches
    rng = np.random.default_rng(300 + seed)
    rt, tt = both_tables(*table_raw(rng, n=int(rng.integers(30, 200))))
    for _ in range(24):
        spec = pred_spec(rng)
        rp, tp = build_pred(spec, RE), build_pred(spec, TE)
        np.testing.assert_array_equal(t_matches(tp, tt.global_ctx()),
                                      r_matches(rp, rt.global_ctx()))
        for p in range(min(tt.num_partitions, 4)):
            np.testing.assert_array_equal(
                t_matches(tp, tt.partition_ctx(p)),
                r_matches(rp, rt.partition_ctx(p)))


@pytest.mark.parametrize("seed", range(4))
def test_fully_matching_two_pass_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    rt, tt = both_tables(*table_raw(rng, with_nulls=False))
    for _ in range(16):
        spec = pred_spec(rng)
        np.testing.assert_array_equal(
            TF.fully_matching_two_pass(build_pred(spec, TE), tt.stats),
            RF.fully_matching_two_pass(build_pred(spec, RE), rt.stats))


# ---------------------------------------------------------------------------
# tables and generator
# ---------------------------------------------------------------------------

GENERATORS = {
    "events": dict(n_rows=6000, rows_per_partition=16, ts_clustering=0.995,
                   user_clustering=0.995),
    "events_default_clustering": dict(n_rows=5000, rows_per_partition=50),
    "users": dict(n_rows=600, rows_per_partition=750),
    "lineitem": dict(n_rows=4000, rows_per_partition=100),
    "orders": dict(n_rows=3000, rows_per_partition=100),
}
_MAKERS = {"events": "make_events_table",
           "events_default_clustering": "make_events_table",
           "users": "make_users_table", "lineitem": "make_lineitem",
           "orders": "make_orders"}


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generator_stats_identical_for_one_seed(kind):
    fn = _MAKERS[kind]
    rt = getattr(RG, fn)(np.random.default_rng(7), **GENERATORS[kind])
    tt = getattr(TG, fn)(np.random.default_rng(7), **GENERATORS[kind])
    assert rt.num_partitions == tt.num_partitions
    np.testing.assert_array_equal(rt.part_bounds, tt.part_bounds)
    assert_stats_equal(rt.stats, tt.stats)
    for c in rt.data:
        np.testing.assert_array_equal(rt.data[c], tt.data[c])


def test_sample_limit_k_sequence_identical():
    ra, ta = np.random.default_rng(3), np.random.default_rng(3)
    assert [RG.sample_limit_k(ra) for _ in range(500)] == \
        [TG.sample_limit_k(ta) for _ in range(500)]


@pytest.mark.parametrize("seed", range(4))
def test_from_arrays_carries_reference_table(seed):
    rng = np.random.default_rng(200 + seed)
    raw, rows_pp, nulls = table_raw(rng, n=int(rng.integers(40, 200)))
    nulls["y"] = rng.random(len(raw["y"])) < 0.5
    nulls["y"][: 2 * rows_pp] = True          # all-null partitions
    rt = RTable.build("carried", raw, rows_pp, nulls)
    tt = TTable.from_arrays(rt.name, rt.columns, rt.data, rt.nulls,
                            rt.part_bounds)
    assert tt.name == rt.name and tt.num_partitions == rt.num_partitions
    assert_stats_equal(rt.stats, tt.stats)
    for c in rt.data:
        np.testing.assert_array_equal(tt.data[c], rt.data[c])
        assert tt.data[c] is not rt.data[c]       # copied, not shared
    for c in rt.nulls:
        np.testing.assert_array_equal(tt.nulls[c], rt.nulls[c])


@pytest.mark.parametrize("seed", range(4))
def test_vectorised_stats_equal_per_partition_loop(seed):
    """from_columns reduces per segment; the reference loops per
    partition.  Nulls, all-null and empty partitions included."""
    rng = np.random.default_rng(300 + seed)
    n = 300
    cuts = np.sort(rng.integers(0, n, 30))
    bounds = np.concatenate([[0], cuts, [n, n]]).astype(np.int64)
    vals = {"a": rng.normal(size=n), "b": rng.integers(-5, 5, n) * 1.0}
    nmask = {"a": rng.random(n) < 0.4, "b": np.zeros(n, dtype=bool)}
    nmask["a"][bounds[3]:bounds[5]] = True
    rcols = [RM.ColumnMeta("a", "float"), RM.ColumnMeta("b", "int")]
    tcols = [TM.ColumnMeta("a", "float"), TM.ColumnMeta("b", "int")]
    assert_stats_equal(
        RM.PartitionStats.from_columns(rcols, vals, nmask, bounds),
        TM.PartitionStats.from_columns(tcols, vals, nmask, bounds))


def test_table_dml_bumps_version_and_logs_deltas():
    rng = np.random.default_rng(5)
    raw, _, _ = table_raw(rng, n=80, with_nulls=False)
    rt, tt = both_tables(raw, 10, {})
    more = {"x": np.arange(15, dtype=np.int64),
            "y": np.arange(15, dtype=np.int64),
            "s": np.array(["Bear"] * 15)}
    for t in (rt, tt):
        t.append_partitions(more, rows_per_partition=5)
        t.drop_partitions([1, 2])
        t.update_column("y", np.arange(t.num_rows) % 7)
    assert tt.version == rt.version == 3
    assert [(d.version, d.kind) for d in tt.deltas] == \
        [(d.version, d.kind) for d in rt.deltas]
    assert_stats_equal(rt.stats, tt.stats)
    np.testing.assert_array_equal(tt.live_mask, rt.live_mask)


# ---------------------------------------------------------------------------
# LIMIT pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_limit_prune_matches_reference(seed):
    rng = np.random.default_rng(400 + seed)
    rt, tt = both_tables(*table_raw(rng, n=200, with_nulls=False))
    for _ in range(12):
        spec = pred_spec(rng)
        rp, tp = build_pred(spec, RE), build_pred(spec, TE)
        tv = RF.eval_tv(rp, rt.stats)
        keep = tv > 0
        ids = np.where(keep)[0]
        k = int(rng.choice([0, 1, 5, 30, 500]))
        supported = bool(rng.random() < 0.8)
        want = RL.limit_prune(RM.ScanSet(ids, tv[keep]), rt.stats, k,
                              supported_shape=supported)
        got = TL.limit_prune(TM.ScanSet(ids, tv[keep]), tt.stats, k,
                             supported_shape=supported)
        assert (got.applied, got.category, got.partitions_before,
                got.partitions_after) == (want.applied, want.category,
                                          want.partitions_before,
                                          want.partitions_after)
        np.testing.assert_array_equal(got.scan.part_ids, want.scan.part_ids)
        np.testing.assert_array_equal(got.scan.match, want.scan.match)
