#!/usr/bin/env python3
"""The dry-run's ``kimi-k2-1t-a32b train_4k`` cell at full width on the
16x16 mesh under the ``"resident"`` MoE layout with the ``"grouped"``
dispatch, for this checkout and, with ``--parent``, another one, side by
side in subprocesses (fake process group, fake tensors: nothing is
allocated and the card is not touched).

    python3 tools/moe_dryrun_pair.py [--parent DIR] [--layers 61 4]
                                     [--out chiprun_out/moe_dryrun.json]

Each (checkout, layer count) runs ``launch.dryrun.run_cell`` in a process
of its own, all started together; ``--layers`` cuts ``n_layers`` (the
config's 61 by default).  Prints one line a run: its peak bytes a device
against the card's 80 GB, the argument and temp bytes, the collective
bytes a device by mesh axis and kind, and the seconds it took.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OVERRIDES = dict(moe_dispatch="grouped", moe_sharding="resident")
CARD_BYTES = 80e9

CODE = """
import json, sys
from repro_torch.launch import dryrun
dryrun.init_fake_group(256)
over = json.loads(sys.argv[1])
rec = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", False, overrides=over)
print("RECORD " + json.dumps(rec))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--layers", type=int, nargs="*", default=[61])
    ap.add_argument("--timeout", type=float, default=3000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    roots = [("this", ROOT)] + ([("parent", Path(args.parent).resolve())]
                                if args.parent else [])
    procs = []
    for name, root in roots:
        for n in args.layers:
            over = dict(OVERRIDES, n_layers=n)
            env = dict(os.environ, PYTHONPATH=str(root / "src"),
                       CUDA_VISIBLE_DEVICES="")
            procs.append((name, n, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-c", CODE, json.dumps(over)], cwd=root,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = []
    for name, n, t0, p in procs:
        try:
            text, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        s = time.perf_counter() - t0
        line = [x for x in text.splitlines() if x.startswith("RECORD ")]
        if p.returncode != 0 or not line:
            print(f"{name} {n} layers: exited {p.returncode} after {s:.1f} "
                  f"s: {text[-1500:]}", flush=True)
            out.append(dict(checkout=name, layers=n, rc=p.returncode, s=s))
            continue
        rec = json.loads(line[-1][len("RECORD "):])
        rec.pop("trace", None)
        rec.update(checkout=name, layers=n, s=s)
        out.append(rec)
        if rec["status"] != "OK":
            print(f"{name} {n} layers: {rec['status']} "
                  f"{rec.get('error')} ({s:.1f} s)", flush=True)
            continue
        rl = rec["roofline"]
        by_axis = "; ".join(f"{a}: " + ", ".join(
            f"{k} {v:,.0f}" for k, v in kinds.items())
            for a, kinds in rl["coll_by_axis"].items())
        peak = rec["peak_bytes_per_device"]
        print(f"{name} {n} layers: peak {peak:,} bytes a device "
              f"({peak / CARD_BYTES:.1%} of 80 GB; args "
              f"{rec['argument_size_in_bytes']:,}, temp "
              f"{rec['temp_size_in_bytes']}, out "
              f"{rec['output_size_in_bytes']:,}, alias "
              f"{rec['alias_size_in_bytes']:,}); collective bytes a device "
              f"by axis: {by_axis}; collective {rl['collective_s']:.4g} s, "
              f"compute {rl['compute_s']:.4g} s, memory "
              f"{rl['memory_s']:.4g} s: {rl['bottleneck']}; {s:.1f} s",
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r.get("status") == "OK" for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
