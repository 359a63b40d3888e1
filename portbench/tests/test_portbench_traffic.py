"""The traffic and table generators: shares, determinism, seeds."""

from __future__ import annotations

import collections

import numpy as np
import pytest

from portbench import gen
from portbench.traffic import Stream, make_cycle

from .tiny import SEED, tiny_cell

CELLS = ["events-prod.mixed", "tpch-sf1000.mixed"]


@pytest.mark.parametrize("name", CELLS)
def test_kind_cycle_reproduces_the_mix_shares(name):
    mix = tiny_cell(name).mix
    cycle = make_cycle(mix)
    want = {k: n for k, n in mix["cycle"]}
    assert collections.Counter(cycle) == want
    s = Stream(mix, SEED)
    n = 3 * len(cycle)
    got = collections.Counter(s.kind(i) for i in range(n))
    assert got == {k: 3 * c for k, c in want.items()}
    # each kind spread evenly: no gap between its slots beyond three times
    # the cycle over its count
    for k, c in want.items():
        pos = [i for i, x in enumerate(cycle) if x == k]
        gaps = np.diff(pos + [pos[0] + len(cycle)])
        assert gaps.max() <= 3 * len(cycle) / c + 2


def test_events_mix_holds_the_papers_table_1_shares():
    mix = tiny_cell("events-prod.mixed").mix
    s = Stream(mix, SEED)
    cls = collections.Counter(s.spec(i).cls for i in range(len(s.cycle)))
    topk = sum(1 for i in range(len(s.cycle))
               if s.spec(i).order_by is not None)
    assert abs(topk / len(s.cycle) - 0.0555) < 0.001
    assert abs(cls["limit"] / len(s.cycle) - 0.026) < 0.002
    assert cls["join"] == 0                  # Table 1 gives no join share
    filters = [s.spec(i).kind for i in range(len(s.cycle))
               if s.spec(i).cls == "filter"]
    fam = collections.Counter(k.split(".")[1] for k in filters)
    for k, share in (("recent", 0.28), ("recent_status", 0.14),
                     ("status", 0.33), ("unselective", 0.25)):
        assert abs(fam[k] / len(filters) - share) < 0.005


@pytest.mark.parametrize("name", CELLS)
def test_generator_is_deterministic_by_seed(name):
    cfg = tiny_cell(name).config
    a, b = gen.make_tables(cfg, SEED), gen.make_tables(cfg, SEED)
    c = gen.make_tables(cfg, SEED + 1)
    assert a.keys() == b.keys() == c.keys()
    differs = False
    for t in a:
        assert a[t].rows_per_partition == b[t].rows_per_partition
        for col in a[t].columns:
            assert np.array_equal(a[t].columns[col].values,
                                  b[t].columns[col].values)
            differs |= not np.array_equal(a[t].columns[col].values,
                                          c[t].columns[col].values)
    assert differs


@pytest.mark.parametrize("name", CELLS)
def test_stream_is_deterministic_and_exact_in_float32(name):
    cell = tiny_cell(name)
    a, b = Stream(cell.mix, SEED), Stream(cell.mix, SEED)
    for i in range(200):
        assert a.spec(i) == b.spec(i)
        for _t, cons in a.spec(i).scans.values():
            for _c, _op, v in cons:
                if not isinstance(v, str):
                    assert float(np.float32(v)) == float(v)
    raw = gen.make_tables(cell.config, SEED)
    for t in raw.values():
        for col in t.columns.values():
            assert np.array_equal(col.values.astype(np.float32)
                                  .astype(np.float64), col.values) \
                or col.values.max() > 2 ** 24   # keys no predicate reads


def test_seeds_beyond_32_bits_and_negative_are_taken():
    for seed in (0, 2 ** 31 + 5, 2 ** 33, -7):
        gen.rng_for(seed, 1).random()
