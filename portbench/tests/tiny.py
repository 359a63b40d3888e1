"""Tiny deployments of the benchmark's cells, for the CPU tests: each
configuration with its tables cut to a few hundred partitions, each mix
with a short verified prefix."""

from __future__ import annotations

import copy
import time

from portbench.harness import REPO, Cell, run_cell

SEED = 2 ** 31 + 11          # larger than 32 signed bits hold


def tiny_cell(name: str, root=REPO) -> Cell:
    cell = Cell.load(name, root)
    cfg = copy.deepcopy(cell.config)
    for t in cfg["tables"]:
        if t["generator"] == "columns":
            t["partitions"] = 256
        elif t["generator"] == "tpch":
            for side, p in (("orders", 32), ("lineitem", 128)):
                t[side]["partitions"] = p
                t[side]["rows_per_partition"] = 64
    cell.config = cfg
    cell.mix = dict(cell.mix, verify_prefix=48, scanned_prefix=96)
    return cell


def run_tiny(cell: Cell, seconds: float = 0.5, traced: bool = False,
             seed: int = SEED) -> dict:
    import torch
    return run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter(), log=lambda *_: None)
