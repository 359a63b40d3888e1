"""The plain reference against the port's CPU service, and the judge."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import gen
from portbench.harness import plain_answer, port_tables
from portbench.reference.engine import Reference, to_bfloat16
from portbench.reference.judge import judge
from portbench.traffic import Stream, to_port

from .tiny import SEED, tiny_cell

CELLS = ["events-prod.mixed", "tpch-sf1000.mixed"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_cpu_service(name):
    from repro_torch.serve.prune_service import PruningService

    cell = tiny_cell(name)
    raw = gen.make_tables(cell.config, SEED)
    tables = port_tables(raw)
    stream = Stream(cell.mix, SEED)
    n = 2 * len(stream.cycle) if name.startswith("tpch") else 400
    specs = [stream.spec(i) for i in range(n)]
    svc = PruningService(device="cpu")
    reports = []
    for lo in range(0, n, 64):
        reports += svc.run_batch([to_port(q, tables)
                                  for q in specs[lo:lo + 64]])
    ref = Reference(raw, cell.config)
    bad = {q.index: judge(ref, q, plain_answer(r))
           for q, r in zip(specs, reports)}
    assert not {i: b for i, b in bad.items() if b}
    # every stage of the mix was judged
    stages = {s for q in specs for s in q.stages}
    assert stages == ({"filter", "join"} if name.startswith("tpch")
                      else {"filter", "limit", "topk"})


@pytest.mark.parametrize("name", CELLS)
def test_reference_answers_pass_their_own_judge(name):
    cell = tiny_cell(name)
    raw = gen.make_tables(cell.config, SEED)
    ref = Reference(raw, cell.config)
    stream = Stream(cell.mix, SEED)
    for i in range(120):
        q = stream.spec(i)
        assert judge(ref, q, ref.answer(q)) == []


def test_bfloat16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.0e6, -2.5, np.inf])
    got = to_bfloat16(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.015625
    assert got[3] == 2998272.0 and got[4] == -2.5 and np.isinf(got[5])


@pytest.mark.parametrize("precision", ["float64", "bfloat16"])
def test_topk_truth_reads_every_row_it_needs(precision):
    from portbench.reference.engine import PRECISIONS, row_mask

    cell = tiny_cell("events-prod.mixed")
    raw = gen.make_tables(cell.config, SEED)
    ref = Reference(raw, cell.config, precision)
    rnd = PRECISIONS[precision]
    stream = Stream(cell.mix, SEED)
    specs = [q for q in (stream.spec(i) for i in range(4 * 360))
             if q.order_by is not None][:40]
    for q in specs:
        alias, col, desc = q.order_by
        table, cons = q.scans[alias]
        sign = 1.0 if desc else -1.0
        k = q.limit + q.offset
        t = raw[table]
        every = sign * rnd(t.columns[col].values[row_mask(t, cons, rnd)])
        want = np.sort(every)[::-1][:k]
        values, kth, _best = ref.topk_truth(q)
        assert np.array_equal(sign * values, want)
        assert kth == (want[-1] if every.size >= k else -np.inf)
