"""Phase 3's batch of two checkouts timed in turns on one card.

    python3 tools/phase3_pair.py --parent DIR [--seed 0]

``DIR`` is another checkout (``git archive <commit> | tar -x -C
build/parent``).  Each turn runs in a process of its own (the two
checkouts' packages share their names): it builds phase 3's tables and
batch with that checkout's ``chip_smoke.py``, then a warm-up and three
timed batches through the checkout's default card service (the flat
rungs), on the host clock around synchronised calls.  The turns go
parent, this checkout, this checkout, parent, and each prints one JSON
line with the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(root: str, label: str, seed: int) -> None:
    sys.path[:0] = [root, root + "/src"]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.serve.prune_service import PruningService

    ops.load_kernels()
    dev = torch.device("cuda")
    card = cs.card_line()
    queries, _ctx = cs.main_path_traffic(seed, card)
    svc = PruningService(device=dev)
    times = []
    for b in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.run_batch(queries)
        torch.cuda.synchronize()
        if b:
            times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(label=label, card=card, batch_ms=times,
                          median_ms=statistics.median(times))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(*args.one, args.seed)
        return 0
    for root, label in ((args.parent, "parent"), (str(ROOT), "change"),
                        (str(ROOT), "change"), (args.parent, "parent")):
        done = subprocess.run(
            [sys.executable, __file__, "--parent", args.parent, "--seed",
             str(args.seed), "--one", root, label],
            capture_output=True, text=True)
        lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
        if done.returncode or not lines:
            print(done.stdout[-2000:], done.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
