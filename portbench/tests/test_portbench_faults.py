"""``correct`` has to come out false: the control (the reference in
bfloat16, put in the program's place) and faults planted in the timed
path, each run through the rest of a run with the look for a card
skipped."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from portbench.control import control

from .tiny import SEED, run_tiny, tiny_cell

CELLS = ["events-prod.mixed", "tpch-sf1000.mixed"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_is_not_correct(name, seed):
    cell = tiny_cell(name)
    assert not any(control(cell, seed, "float64", 200)["checks"].values())
    assert sum(control(cell, seed, "bfloat16", 200)["checks"].values()) > 0


def test_sound_run_is_correct():
    res = run_tiny(tiny_cell("events-prod.mixed"))
    assert res["judged"] > 48 and not any(res["checks"].values())


def _drop_one_kept(orig):
    def scan_set(tv, table=None):
        ss = orig(tv, table)
        return ss.keep(np.arange(len(ss)) > 0) if len(ss) > 1 else ss
    return staticmethod(scan_set)


def test_answer_altered_where_the_filter_makes_it(monkeypatch):
    from repro_torch.serve.prune_service import PruningService

    monkeypatch.setattr(PruningService, "_scan_set",
                        _drop_one_kept(PruningService._scan_set))
    res = run_tiny(tiny_cell("tpch-sf1000.mixed"))
    assert res["checks"]["filter"] > 0


def test_topk_value_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core import flow

    orig = flow.run_topk

    def run_topk(*a, **kw):
        r = orig(*a, **kw)
        if len(r.values):
            r.values = r.values.copy()
            r.values[-1] += 1.0
        return r

    monkeypatch.setattr(flow, "run_topk", run_topk)
    res = run_tiny(tiny_cell("events-prod.mixed"))
    assert res["checks"]["topk"] > 0


def test_join_drops_a_partition_it_must_keep(monkeypatch):
    from repro_torch.core import flow

    orig = flow.prune_probe

    def prune_probe(*a, **kw):
        r = orig(*a, **kw)
        if len(r.scan) > 1:
            r.scan = r.scan.keep(np.arange(len(r.scan)) > 0)
        return r

    monkeypatch.setattr(flow, "prune_probe", prune_probe)
    res = run_tiny(tiny_cell("tpch-sf1000.mixed"))
    assert res["checks"]["join"] > 0


def bloom_join_cell():
    """Tiny events joined to a 20,000-row user dimension on user_id: the
    build side's ~8,000 keys take the Bloom summary, and 16 rows a
    partition leave user_id ranges narrow enough to enumerate."""
    cell = tiny_cell("events-prod.mixed")
    cfg = copy.deepcopy(cell.config)
    cfg["tables"][0].update(partitions=4096, rows_per_partition=16)
    cfg["tables"].append({"name": "users_20k", "generator": "users",
                          "rows": 20000, "rows_per_partition": 1000,
                          "id_domain": 500000})
    cfg["guarantees"].update(join_exact_ndv=4096,
                             join_bloom={"bits_per_key": 16,
                                         "enum_limit": 1024})
    mix = copy.deepcopy(cell.mix)
    mix["preds"]["age_old"] = [{"col": "age", "op": "ge",
                                "value": {"int": [60, 66]}}]
    mix["kinds"] = {"join.none": {
        "scans": {"users": {"table": "users_20k", "pred": "age_old"},
                  "events": {"table": "events"}},
        "join": ["users", "events", "id", "user_id"]}}
    mix["cycle"] = [["join.none", 1]]
    mix["verify_rate"] = {"join": 1.0}
    cell.config, cell.mix = cfg, mix
    return cell


def test_bloom_summary_rebuilt_by_the_reference():
    from portbench import gen
    from portbench.reference.engine import Reference
    from portbench.traffic import Stream

    cell = bloom_join_cell()
    ref = Reference(gen.make_tables(cell.config, SEED), cell.config)
    q = Stream(cell.mix, SEED).spec(0)
    in_range, holds, kept = ref.join_sets(q)
    assert len(ref.build_keys(q)) > 4096
    assert not (holds & ~kept).any() and not (kept & ~in_range).any()
    assert (in_range & ~kept).sum() > 0      # the Bloom prunes in range


def test_bloom_passthrough_is_not_correct(monkeypatch):
    from repro_torch.core import flow

    res = run_tiny(bloom_join_cell())
    assert res["judged"] > 0 and not any(res["checks"].values())
    orig = flow.prune_probe

    def prune_probe(scan, stats, key_col, summary, **kw):
        if summary.bloom is not None:
            kw["bloom_hit"] = np.ones(len(scan), dtype=bool)
        return orig(scan, stats, key_col, summary, **kw)

    monkeypatch.setattr(flow, "prune_probe", prune_probe)
    res = run_tiny(bloom_join_cell())
    assert res["checks"]["join"] > 0


def test_half_of_each_batch_left_unpruned(monkeypatch):
    from repro_torch.serve.prune_service import PruningService

    orig = PruningService.run_batch

    def run_batch(self, queries, pipeline=None):
        reps = orig(self, queries, pipeline)
        for r, q in list(zip(reps, queries))[::2]:
            for name, spec in q.scans.items():
                r.scan_sets[name] = self._passthrough_set(spec.table)
        return reps

    monkeypatch.setattr(PruningService, "run_batch", run_batch)
    res = run_tiny(tiny_cell("events-prod.mixed"))
    assert res["checks"]["filter"] > 0
