#!/usr/bin/env python3
"""Which collectives a gloo process group carries on CUDA tensors, with
several ranks on one card (NCCL refuses two ranks on one device).

    python3 tools/gloo_cuda_probe.py [--ranks 4] [--elements 1048576]

Each case spawns the ranks afresh on a ``FileStore`` (a rank that dies
takes only its case down) and prints one line: the case, then ``ok`` and
the seconds of the collective, or how the ranks ended.  The c10d calls
(``torch.distributed.all_reduce`` and the rest) and the functional ones
that DTensor redistributes through (``_functional_collectives``) are
separate cases; a case ending in ``backward`` also runs the autograd
form's backward.  Used by ``chip_smoke.py`` phase 13 to decide where its
sharded step runs (``SHARDED_STEP_DEVICE``) and where its expert-parallel
MoE layer runs (``MOE_MESH_DEVICE``).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ("c10d all_reduce sum f32", "c10d all_reduce max f32",
         "c10d all_reduce sum int32", "c10d all_reduce sum bf16",
         "c10d all_gather_into_tensor bf16",
         "c10d reduce_scatter_tensor bf16", "c10d all_to_all_single bf16",
         "c10d broadcast bf16", "funcol all_reduce bf16",
         "funcol all_gather_tensor bf16", "funcol reduce_scatter_tensor bf16",
         "funcol all_gather_tensor int64", "funcol all_to_all_single bf16",
         "funcol all_to_all_single_autograd f32 backward",
         "funcol all_reduce f32 backward")


def run_case(rank: int, world: int, store: str, case: str, n: int,
             out: str) -> None:
    import torch.distributed._functional_collectives as fc

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        words = case.split()
        backward = words[-1] == "backward"
        if backward:
            words = words[:-1]
        api, op, dtype = words[0], words[1], words[-1]
        dt = {"f32": torch.float32, "int32": torch.int32,
              "int64": torch.int64, "bf16": torch.bfloat16}[dtype]
        x = torch.full((n,), rank + 1, dtype=dt, device=dev,
                       requires_grad=backward)
        g = dist.group.WORLD
        t0 = time.perf_counter()
        if case.startswith("c10d all_reduce"):
            dist.all_reduce(x, op=dist.ReduceOp.MAX if words[2] == "max"
                            else dist.ReduceOp.SUM)
        elif op == "all_gather_into_tensor":
            dist.all_gather_into_tensor(
                torch.empty(n * world, dtype=dt, device=dev), x)
        elif op == "reduce_scatter_tensor" and api == "c10d":
            dist.reduce_scatter_tensor(
                torch.empty(n // world, dtype=dt, device=dev), x)
        elif op == "all_to_all_single" and api == "c10d":
            dist.all_to_all_single(torch.empty_like(x), x)
        elif op == "all_to_all_single":
            fc.wait_tensor(fc.all_to_all_single(x, None, None, g))
        elif op == "all_to_all_single_autograd":
            # unequal splits: rank r sends r + 1 elements to every rank
            k = rank + 1
            y = fc.all_to_all_single_autograd(
                x[:k * world], [s + 1 for s in range(world)], [k] * world,
                g)
            y.sum().backward()
            if not torch.equal(x.grad[:k * world],
                               torch.ones(k * world, device=dev)):
                raise RuntimeError("the backward is not the ones it sent")
        elif op == "broadcast":
            dist.broadcast(x, 0)
        elif op == "all_reduce" and backward:
            y = fc.all_reduce(x, "sum", g)
            y.sum().backward()
        elif op == "all_reduce":
            fc.wait_tensor(fc.all_reduce(x, "sum", g))
        elif op == "all_gather_tensor":
            fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
        else:
            fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, g))
        torch.cuda.synchronize(dev)
        if rank == 0:
            with open(out, "w") as f:
                f.write(f"{time.perf_counter() - t0:.3f}")
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--elements", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; {args.ranks} gloo ranks on "
          f"one card, {args.elements:,} elements a rank", flush=True)
    d = tempfile.mkdtemp(prefix="gloo_probe_")
    for i, case in enumerate(CASES):
        out = f"{d}/case{i}.txt"
        try:
            mp.spawn(run_case, args=(args.ranks, f"{d}/store{i}", case,
                                     args.elements, out),
                     nprocs=args.ranks, join=True)
            with open(out) as f:
                result = f"ok {f.read()} s"
        except mp.ProcessExitedException as e:      # a rank was killed
            result = f"FAILED: {e}"
        except mp.ProcessRaisedException as e:      # a rank raised
            result = "RAISED: " + str(e).strip().splitlines()[-1]
        print(f"{case}: {result}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
