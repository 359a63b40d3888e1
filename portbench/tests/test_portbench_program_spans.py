"""The readers of the program's own spans (``metrics/host_ms.py``,
``launch_ms.py``, ``admission.py``, ``topk_scan.py``) on the tiny traced
CPU runs: a number wherever the cell's traffic reaches the stage, None in
an untraced run (and None in a CPU run for what only the card path
feeds), and the parts of a stage within the stage."""

from __future__ import annotations

import importlib
import json

import pytest

from portbench import run as run_py

from .tiny import run_tiny, tiny_cell

NEW = {"host_ms", "launch_ms", "admission", "topk_scan"}
CELLS = ("events-prod.mixed", "tpch-sf1000.mixed")
# the thirteen metrics that first read the program's spans
SPAN_METRICS = {
    "host_ms.topk.scan", "host_ms.topk.order", "host_ms.join.build",
    "host_ms.join.summary", "host_ms.join.match", "host_ms.filter.plan",
    "host_ms.filter.decode", "launch_ms.minmax_prune_batched.host",
    "launch_ms.minmax_prune_batched.wait", "launch_ms.topk_init_batched.host",
    "launch_ms.topk_init_batched.wait", "admission.wait_p95_ms",
    "topk_scan.useful_pct"}
# fed only by the card path (a CUDA service summarising a large build
# side), so a CPU run has nothing for them to read
CARD_ONLY = {"launch_ms.bloom_build.host", "launch_ms.bloom_build.wait"}


def _reader(name):
    return importlib.import_module(
        f"portbench.metrics.{name.split('.')[0]}")


def _new_metrics(cell):
    return [m for m in cell.bench["per_layer"]
            if m["name"].split(".")[0] in NEW
            and cell.workload["name"] in m["workloads"]]


@pytest.fixture(scope="module")
def lines():
    from repro_torch import tracing

    out = {}
    for name in CELLS:
        cell = tiny_cell(name)
        for traced in (False, True):
            tracing.clear()
            res = run_tiny(cell, seconds=1.0, traced=traced)
            line = run_py.result_line(cell, res, traced, {
                "platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0})
            out[name, traced] = (cell, res, json.loads(json.dumps(line)))
    return out


def test_thirteen_new_metrics_each_with_its_cells():
    cell = tiny_cell(CELLS[0])
    new = [m for m in cell.bench["per_layer"]
           if m["name"].split(".")[0] in NEW]
    names = {m["name"] for m in new}
    assert SPAN_METRICS <= names
    assert names <= SPAN_METRICS | CARD_ONLY
    for m in new:
        assert m["moves"] == "queries_per_s" and m["workloads"]
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_each_new_metric_reads_in_a_traced_run(lines, name):
    cell, _res, line = lines[name, True]
    for m in _new_metrics(cell):
        if m["name"] in CARD_ONLY:
            assert m["name"] not in line["metrics"], m["name"]
            continue
        assert m["name"] in line["metrics"], m["name"]
        v = line["metrics"][m["name"]]["value"]
        assert v >= 0.0 and line["metrics"][m["name"]]["unit"] == m["unit"]


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_reads_none(lines, name):
    cell, res, line = lines[name, False]
    assert res["run"].trace is None
    for m in _new_metrics(cell):
        assert m["name"] not in line["metrics"]
        assert _reader(m["name"]).read(res["run"], m["name"]) is None


def _value(line, name):
    return line["metrics"][name]["value"]


def test_topk_parts_lie_within_the_topk_stage(lines):
    _cell, _res, line = lines["events-prod.mixed", True]
    parts = (_value(line, "host_ms.topk.scan")
             + _value(line, "host_ms.topk.order"))
    assert 0.0 < parts <= _value(line, "stage_ms.topk")
    assert 0.0 <= _value(line, "topk_scan.useful_pct") <= 100.0


def test_join_parts_lie_within_the_join_stage(lines):
    _cell, _res, line = lines["tpch-sf1000.mixed", True]
    parts = sum(_value(line, f"host_ms.join.{p}")
                for p in ("build", "summary", "match"))
    assert 0.0 < parts <= _value(line, "stage_ms.join")


def test_a_run_whose_ring_dropped_window_spans_reads_none(lines,
                                                          monkeypatch):
    from repro_torch import tracing

    cell, res, _line = lines["events-prod.mixed", True]
    run = res["run"]
    monkeypatch.setattr(tracing, "_dropped", 1)
    monkeypatch.setattr(tracing, "_dropped_t1", run.trace.t_open + 1e-3)
    for m in _new_metrics(cell):
        assert _reader(m["name"]).read(run, m["name"]) is None, m["name"]
