"""Phase 6 (b)'s delta replays of two checkouts timed in turns on one card.

    python3 tools/replay_pair.py --parent DIR [--seed 0] [--rows N]

``DIR`` is another checkout (``git archive <commit> | tar -x -C
build/parent``).  Its ``repro_torch`` is loaded under another name beside
this checkout's, so both run in one process on one table: phase 3's events
table (``--rows`` rows, 2**24 by default, 16 a partition) with each
checkout's ``DeviceStatsCache(tree_fanout=256)`` holding every plane
family phase 6 (b) replays (stat, tree, join-key and enumeration planes of
``user_id``, block-top-k of ``num_sightings``).  Then phase 6 (b)'s five
DML steps (``chip_smoke.dml_steps``): after each, both caches bring every
family current one getter at a time, on the host clock around
synchronised calls, the two checkouts in turns (the order flips each
step).  Prints one JSON line a step and the card's name and power limit.
Needs one CUDA card (``--device cpu`` rehearses it on the plain path).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def load_as(name: str, pkg_dir: Path):
    """Import the package at ``pkg_dir`` under the top-level ``name`` (its
    imports are relative, so they resolve inside it)."""
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py", submodule_search_locations=[
            str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.core.device_stats")


def families(cache, events, dev) -> dict:
    """Each family brought current on ``cache``: ms and staging counts."""
    import chip_smoke as cs
    out, box = {}, []

    def timed(name, fn):
        before = cache.staging_snapshot()
        ms = cs.host_ms(fn, dev)
        after = cache.staging_snapshot()
        out[name] = dict(ms=ms, **{k: after[k] - before[k] for k in (
            "staged_bytes", "delta_stages", "full_restages")})

    timed("stat", lambda: box.append(cache.get(events)))
    timed("tree_stat", lambda: cache.tree_plane(events, box[0]))
    timed("join_key", lambda: cache.join_key_plane(events, cs.JOIN_KEY))
    timed("enum", lambda: cache.enum_plane(events, cs.JOIN_KEY))
    timed("block_topk", lambda: cache.block_topk_plane(
        events, cs.ORDER_COL, True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=2 ** 24)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the tool on the plain path")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import device_stats as mine
    from repro_torch.data.generator import make_events_table

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("replay_pair: no CUDA device available", file=sys.stderr)
        return 2
    theirs = load_as("parent_repro_torch",
                     Path(args.parent).resolve() / "src" / "repro_torch")
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    events = make_events_table(np.random.default_rng(args.seed),
                               n_rows=args.rows, rows_per_partition=16,
                               ts_clustering=0.995, user_clustering=0.99999)
    caches = {k: m.DeviceStatsCache(tree_fanout=cs.TREE_FANOUT, device=dev)
              for k, m in (("parent", theirs), ("this", mine))}
    staged = {k: families(c, events, dev) for k, c in caches.items()}
    print(json.dumps(dict(step="stage", card=card,
                          P=events.num_partitions, **staged)), flush=True)
    for si, (name, apply) in enumerate(cs.dml_steps(events, args.seed)):
        apply()
        order = ("parent", "this") if si % 2 == 0 else ("this", "parent")
        got = {k: families(caches[k], events, dev) for k in order}
        print(json.dumps(dict(step=name, order=order, card=card, **got)),
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
