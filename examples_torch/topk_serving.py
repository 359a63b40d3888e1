"""Serving-side example: batched top-k analytics + LM decode behind one
stack.

Production serving deployments carry an analytics sidecar (request logs,
feature stores) — exactly the workload the paper's top-k pruning (Sec. 5)
accelerates.  This example:
  1. serves `ORDER BY ... DESC LIMIT k` queries over a logged-requests
     table with boundary-value pruning (vs. the full scan), and
  2. runs a small LM through prefill+decode with the ``Generator``.

Run:  PYTHONPATH=src python examples_torch/topk_serving.py [--device cpu]
"""

import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import expr as E
from repro_torch.core.device_stats import resolve_device
from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
from repro_torch.data.generator import ColumnSpec, gen_table
from repro_torch.data.scan import execute_query
from repro_torch.models import build_model
from repro_torch.models.sharding import init_params
from repro_torch.serve.serve_step import Generator


def main(device=None):
    rng = np.random.default_rng(0)
    dev = resolve_device(device)

    # ---- 1. the analytics sidecar: top-k over logged requests -----------
    requests = gen_table(
        "requests", rng, n_rows=200_000, rows_per_partition=1000,
        specs=[
            ColumnSpec("ts", "int", 0, 10_000_000, clustering=0.99),
            ColumnSpec("latency_ms", "float", 1.0, 5000.0, clustering=0.35),
            ColumnSpec("model", "str", n_distinct=8, clustering=0.2,
                       str_groups=("lm", "vlm")),
            ColumnSpec("tokens_out", "int", 1, 4096, clustering=0.0),
        ],
    )

    pipe = PruningPipeline(filter_mode="device", device=dev)
    queries = [
        ("slowest requests today",
         Query(scans={"requests": TableScanSpec(requests,
                                                E.col("ts") >= 9_000_000)},
               limit=20, order_by=("requests", "latency_ms", True))),
        ("top token producers",
         Query(scans={"requests": TableScanSpec(requests)},
               limit=10, order_by=("requests", "tokens_out", True))),
    ]
    for name, q in queries:
        t0 = time.perf_counter()
        rep = pipe.run(q)
        res = execute_query(q, rep)
        dt = (time.perf_counter() - t0) * 1e3
        base = execute_query(q, None)
        t = rep.per_scan["requests"].get("topk")
        skipped = len(rep.topk.skipped) if rep.topk is not None else 0
        print(f"[analytics] {name}: {skipped} of "
              f"{t.before if t else '?'} partitions skipped "
              f"({res.total_bytes()/1e6:.1f} MB vs "
              f"{base.total_bytes()/1e6:.1f} MB unpruned) in {dt:.0f} ms")

    # ---- 2. the LM behind it: batched prefill + decode -------------------
    cfg = get_smoke_config("llama3.2-3b")
    model = build_model(cfg, device=dev)
    params = init_params(model.specs,
                         torch.Generator(device=dev).manual_seed(0), dev)
    gen = Generator(model, params, max_seq=64, device=dev)
    prompts = np.array([[1, 5, 9, 13, 17, 21, 25, 29]] * 4)  # batch of 4
    out = gen.generate(prompts, steps=16)
    print(f"[serving] decoded {out.shape} tokens; sample: "
          f"{out[0][:8].tolist()}")


if __name__ == "__main__":
    from _device import parse_device
    main(parse_device(__doc__))
