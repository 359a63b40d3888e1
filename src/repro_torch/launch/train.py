"""End-to-end training driver: pruned data pipeline -> train loop with
checkpoint/restart.

The counterpart of the JAX package's ``launch/train.py``, printing the
same lines.  CPU-scale by default (a ~20M-param llama-family model);
pass ``--arch`` for a repo config.  The step runs eagerly (the JAX
driver's ``jax.jit`` and ``donate_argnums`` have no counterpart: the
optimizer updates the state in place).

Fault tolerance exercised here:
  * periodic atomic checkpoints (params, optimizer, data cursors),
  * --simulate-failure N stops the process at step N (exit code 42);
    re-running the same command resumes from the last checkpoint and
    replays the loader to it,
  * the paper's engine curates the data in the loop (``data.pipeline``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..core import expr as E
from ..core.device_stats import resolve_device
from ..data.pipeline import PrunedDataLoader, curate, make_corpus_metadata
from ..models import build_model
from ..train import checkpoint as ckpt
from ..train.optimizer import AdamW, cosine_schedule
from ..train.train_step import init_state, make_train_step


def default_config(vocab: int = 8192) -> ModelConfig:
    """~20M-param dense model that trains at CPU speed."""
    return ModelConfig(
        name="cpu-20m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab=vocab,
        logits_chunk=128, attn_chunk=128,
    )


CURATION_PRED = (
    (E.col("quality") >= 0.35)
    & E.in_(E.col("lang"), ["en-00000", "en-00001", "en-00002", "en-00003"])
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the GPU by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.arch:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    else:
        cfg = default_config()
    if cfg.frontend != "none":
        raise SystemExit("train driver covers LM archs; use examples_torch/ "
                         "for frontend-stub archs")

    model = build_model(cfg, device=dev)
    optimizer = AdamW(
        lr=cosine_schedule(3e-4, warmup=20, total=max(args.steps, 100)),
        state_dtype=getattr(torch, cfg.optimizer_state_dtype),
    )
    step_fn = make_train_step(model, optimizer, microbatches=args.microbatches,
                              compress=args.compress)

    # --- pruned data pipeline (the paper's engine in the loop) ---
    rng = np.random.default_rng(args.seed)
    meta = make_corpus_metadata(rng, n_shards=512, docs_per_shard=16)
    scan, report = curate(meta, CURATION_PRED)
    print(f"[train] curation pruned {report.pruning_ratio:.1%} of shards "
          f"({report.shards_selected}/{report.shards_total} fetched)")
    loader = PrunedDataLoader(
        scan, worker=0, n_workers=1, batch_size=args.batch,
        seq_len=args.seq, vocab=cfg.vocab, seed=args.seed)

    # --- init or resume ---
    start = 0
    state = init_state(model, optimizer,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       compress=args.compress, device=dev)
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        state, manifest = ckpt.restore(args.ckpt_dir, latest, state,
                                       device=dev)
        start = manifest["step"]
        print(f"[train] resumed from step {start}")

    it = iter(loader)
    # replay the loader to the resume point (deterministic shards)
    for _ in range(start):
        next(it)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = next(it)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step+1} loss={losses[-1]:.4f} "
                  f"({dt/args.log_every:.2f}s/step)", flush=True)
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            path = ckpt.save(args.ckpt_dir, step + 1, state,
                             extra={"loader": loader.state()})
            print(f"[train] checkpoint -> {path}", flush=True)
        if args.simulate_failure and step + 1 == args.simulate_failure:
            print("[train] simulated failure (SIGKILL semantics)", flush=True)
            raise SystemExit(42)

    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
