"""The harness as a whole: the last line, the import check, the refusal
without a card, and a new cell made of data files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import run as run_py
from portbench.harness import Cell

from .tiny import SEED, run_tiny, tiny_cell

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(cell, traced):
    res = run_tiny(cell, traced=traced)
    return run_py.result_line(cell, res, traced, {
        "platform": "cpu", "kind": "cpu", "count": 1,
        "memory_peak_bytes": 0})


def test_last_line_keys_plain_run():
    cell = tiny_cell("tpch-sf1000.mixed")
    line = json.loads(json.dumps(_line(cell, False)))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"queries_per_s",
                                    "partitions_scanned_pct", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert all(set(v) == {"value", "limit"}
               for v in line["checks"].values())


def test_last_line_keys_traced_run():
    cell = tiny_cell("events-prod.mixed")
    line = json.loads(json.dumps(_line(cell, True)))
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    listed = {m["name"] for m in cell.bench["per_layer"]}
    assert set(line["metrics"]) <= listed
    assert {"frontend.query_p95_ms", "stage_ms.topk",
            "pruned_pct.filter"} <= set(line["metrics"])
    assert not set(line["metrics"]) & {m["name"]
                                       for m in cell.bench["end_to_end"]}


def test_a_window_that_fails_stops_the_profiler(monkeypatch):
    """A traced run whose window fails (a service thread lost) raises its
    own error with the profiler stopped and the program's methods
    unwrapped, so the process ends with that error."""
    import pytest
    from torch.autograd import profiler as autograd_profiler

    from portbench import harness
    from repro_torch.serve.prune_service import PruningService

    run_batch = PruningService.__dict__["run_batch"]

    def lost(self, seconds, limit_s):
        assert autograd_profiler._is_profiler_enabled
        raise RuntimeError("the window did not close")

    monkeypatch.setattr(harness.Clients, "window", lost)
    with pytest.raises(RuntimeError, match="did not close"):
        run_tiny(tiny_cell("tpch-sf1000.mixed"), traced=True)
    assert not autograd_profiler._is_profiler_enabled
    assert PruningService.__dict__["run_batch"] is run_batch


def _python(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'src'}",
               CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from portbench.tests.tiny import tiny_cell, run_tiny\n"
        "from portbench import run as run_py\n"
        "from portbench.harness import forbidden_modules\n"
        "cell = tiny_cell('events-prod.mixed')\n"
        "res = run_tiny(cell, traced=True)\n"
        "line = run_py.result_line(cell, res, True, {'platform': 'cpu'})\n"
        "assert line['metrics'], line\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "bad = top & {'jax', 'jaxlib', 'flax', 'repro'}\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in top\n")
    r = _python(code)
    assert r.returncode == 0, r.stderr[-2000:]


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "import portbench.reference.engine, portbench.reference.judge\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "bad = top & {'repro_torch', 'repro', 'jax', 'torch'}\n"
        "assert not bad, bad\n")
    r = _python(code)
    assert r.returncode == 0, r.stderr[-2000:]


def test_run_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "events-prod.mixed", "--seed", str(SEED), "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_new_cell_needs_data_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "portbench/mixes/tpch-mixed.json").read_text())
    mix["cycle"] = [["q6", 2], ["full.orders", 1]]
    mix["clients"] = 8
    (root / "portbench/mixes/throwaway.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "tpch-sf1000.throwaway",
                               "config": "tpch-sf1000",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("tpch-sf1000.throwaway", root)
    assert isinstance(cell, Cell)
    res = run_tiny(cell)
    assert res["judged"] > 0 and not any(res["checks"].values())
    kinds = {res["run"].stream.kind(i) for i in res["run"].window}
    assert kinds == {"q6", "full.orders"}
