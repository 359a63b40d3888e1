#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 1] [--json PATH]

Phases (each failure exits non-zero; nothing is caught and passed over):

  1. environment: torch version, the card's name and power limit, and the
     build of all nine CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all started together), with ptxas's
     registers, spills and static shared memory for the kernel functions
     of ``flash_attention``, ``topk_init_batched``,
     ``minmax_prune_batched``, ``bloom_probe_batched``, ``minmax_prune``
     and ``topk_boundary``, and the count
     of tensor-core instructions (HMMA, HGMMA) in ``flash_attention``'s
     SASS, which must not be 0;
  2. each kernel vs its plain version on the card, on
     the same inputs: exact equality of every output for the pruning
     kernels, the JAX package's bounds for ``flash_attention`` (rtol =
     atol = 2e-5 in f32, 2e-2 in bf16):
       * ``minmax_prune_batched`` over Q x Kb x C x P grids with drop
         sentinels inside P and in the capacity tail, (-inf, +inf) no-op
         slots, bounds equal to a stat, denormal bounds and stats,
         conjunctions of up to 8192 ranges, P = 1, 3, 15 mod 16,
         capacities P + 3, planes at storage offsets that differ mod 16
         bytes, more slots than the kernel's slot tile, more columns than
         its shared tile and than its column map (C = 1100), and phase
         3's largest group at P = 2**20 - 1;
       * ``join_overlap_batched`` with +inf key padding, drop and capacity
         sentinels (+f32max, -f32max), keys on a partition's bounds and
         key rows longer than the kernel's staged capacity, on random
         planes and on clustered ones (narrow, nearly sorted intervals
         as in the events plane, all-empty tiles, Q up to 70, past a
         block's query chunk), and tiles whose key windows take each of
         the kernel's paths (empty, in a warp's lanes, staged, in place;
         the count of (query, tile) windows on each is logged and none
         may be 0);
       * ``bloom_probe_batched`` with widths 0 and above the enumeration
         limit, negative candidates and both ends of int32, and filters
         of 1, 8, 256 and 1024 blocks; at Q in {1, 16, 32, 33, 70} and
         64 and 256 blocks too, all widths 0, and one partition 20,000
         wide among narrow ones in a warp;
       * ``topk_init_batched`` with k in {1, 3, 64, 128}, queries with no
         candidate, ties, all -inf rows and candidate lists long enough to
         need many slabs; at k in {1, 2, 17, 100, 127, 128} every row head
         equal, every value equal, mostly all -inf rows, all but one query
         empty, lists that repeat ids, rows of at most 2 values, both
         signed zeros; and 70,000 queries (past a grid's 65,535 in y);
       * the per-query kernels at P in {1, 7, 2047, 2048, 2049, 2**20,
         2**21}: ``minmax_prune`` with K in {1, 3} and, at the small P,
         {2049, 8192} (past its shared tile), empty intervals, bounds on a
         stat, denormals; ``join_overlap`` with D in {1, 64, 4096, 4097,
         9000} (past its staged capacity), keys on a partition's bounds,
         denormals, keys at both infinities and empty partitions, and
         clustered intervals with -0.0 and infinite keys and each window
         path taken, as for the batched kernel;
         ``topk_boundary`` with k in {1, 8, 64} and its largest k, random,
         descending and (P <= 2049) ascending row orders, ties, all -inf
         rows, with and without an upfront boundary, and k in {1, 8, 25}
         at the edges of its tiles (P = 4095-4097, 2**20 +- 1); P up to
         2**21 throughout;
       * ``flash_attention`` in f32 and bf16 at every head dim D in {8,
         16, 32, 64, 72, 80, 100, 128, 200, 256}: Sq = Sk in {1, 7, 128,
         130, 256} with and without causal, Sk != Sq without it (up to
         2048) and with it (130 x 300, 300 x 130), 2048 causal, BH = 128
         at 2048 causal for D in {128, 256}, Whisper's non-causal 1,500 x
         1,500 and 64 x 1,500 for D in {64, 80} (80: Zamba2's head dim),
         and views at an odd element offset (a data_ptr off 16 bytes: the
         element-load path);
  3. the main path at full size: ``PruningService.run_batch`` over the
     production-like events table (2**24 rows in 1,048,576
     micro-partitions, 6 columns), a 600-row users dimension table and a
     20,000-row users table that is the build side of the joins: one batch
     of 256 queries (128 filter-only, 48 plain LIMIT, 48 top-k, 32 join of
     which 8 also ORDER BY) — one warm-up batch, then ``--batches`` timed
     ones.  Every batch must be bit-identical to the same service on the
     CPU (the plain versions), bit-identical to the f64 host pipeline on
     int/dictionary predicates (scan sets and reports; top-k values equal
     and the device's skipped partitions a superset of the host's; Bloom
     joins are held to the CPU run only), keep every partition the host
     pipeline keeps, run with no demotion, salvage or passthrough, launch
     each kernel once per table group, and fall back to the host top-k
     init exactly for the join + ORDER BY queries.  Then the split of one
     batch's time by stage, with each kernel timed at the main path's
     shapes beside its plain version and, where one exists, a PyTorch
     library call computing the same function (top-k: and its bound with
     each gathered row head a 32-byte sector).
  4. the per-query path of ``ops`` on phase 3's events table, with the
     three per-query kernels' launch counts set to 0 just before and read
     just after: each of the 128 filter-only queries through
     ``extract_ranges`` + ``prune_ranges_device`` (equal to its row of one
     batched launch and to the CPU call), each of the 32 joins' distinct
     build keys through ``join_overlap_device`` (equal to the CPU call and,
     for the 16 distinct summaries, to the batched row), and four
     unfiltered ``ORDER BY num_sightings LIMIT k`` queries, both
     directions, through ``topk_boundary_device`` on ordered block-top-k
     rows (heap equal to ``topk_oracle``, skips equal to the host
     ``run_topk(strategy="sort")``, equal to the CPU call; ``prefix`` the
     same heap and a superset of the skips).  Then the per-query split
     (host staging, H2D, kernel, D2H), the per-query loop's queries/s
     beside one batched call's, the host ``run_topk`` time beside the
     ``topk_boundary`` launch, and each kernel at this path's shapes
     beside its plain version, bound and library call (``minmax_prune``
     at the widest conjunction and at the one whose data needs the most
     bytes, each bound counted from what its data needs); for
     ``minmax_prune`` and ``topk_boundary`` the wrapper (the row's time)
     and the launch alone, and the scan's tiles and grid.
  5. LM serving at full width: GLM-4-9B (``get_config("glm4-9b")``, all 40
     layers, bf16, parameters from the port's ``init_params`` seeded by
     ``--seed``), the ``Generator`` on 4 prompts of 2,048 tokens and 16
     greedy steps, and the ``ContinuousBatcher`` on 8 requests of 128 to
     1,024 tokens, 16 new tokens each, in 4 slots; checks: (a)
     ``flash_attention`` launched once a layer per prefill (40 for the
     ``Generator``, 40 x 8 for the batcher); (b) the kernel equals its
     plain version at every layer's q, k, v of the served prefill; (c)
     the served logits at every served position agree with the f32
     forward without cache or kernel (``reference_logits``), and an fp8
     control does not; (d) the served path with the plain attention in
     place of the kernel agrees with the kernel run (and logs how far its
     prefill drifts from it, layer by layer), and (e) the batcher's logits
     agree with the ``Generator``'s fed the same tokens, within (c)'s
     bound (bounds and reasons at ``SERVE_VS_F32_TOL``).  The logits are
     recorded by a model whose steps wrap the real ones, on the timed
     runs.  Then the prefill and decode times and
     tokens/s, the batcher's requests/s, weight, cache and peak bytes, and
     the kernel (its template and TFLOP/s) at the prefill shape beside its
     bound, its plain version and SDPA.
  6. (run after phase 4, on phase 3's tables) the tree path and
     incremental ingest at full width.  (a) A batch of 64 selective
     filters on events (32 recent-data scans and 32 time windows, the
     selected share lognormal around 1% and capped at 10%; 16 of them
     also ``ORDER BY num_sightings DESC LIMIT k``) and the 16 joins of
     phase 3 whose probe scan is unfiltered or a ``ts`` scan, through
     ``PruningService(tree_fanout=256)``: one warm-up and
     ``TREE_BATCHES`` (3) timed batches, each bit-identical to the flat card service (phase
     3's default service, which takes no tree rung), to the CPU service
     and, on int and dictionary predicates, to the f64 host pipeline;
     the filter group takes the ``tree`` path, every technique launches
     on the tree rung, nothing is demoted, and each batched kernel's
     launches are counted from 0 over these batches.
     Then the same batches on the flat service (the tree batch's time
     beside the flat one's), the group densities, the filter stage and
     the join and Bloom group calls alone on both services in turns
     (what the tree rung's pre-pass costs), and phase 3's batch once
     through the tree service, bit-identical to phase 3's reports (its
     groups' paths logged).  (b) On events in turn: append 4,096
     partitions (65,536 generated rows, ``ts`` past the table's), drop
     1,024, ``update_column("score")``, ``update_column("num_sightings")``
     (the top-k plane's own column), rewrite 256.  After each step every
     resident plane family of the tree service is brought current one
     getter at a time (timed, with the bytes it staged) beside a fresh
     card service's full stage of it; the planes must be byte-equal to the
     fresh stage, the batch's reports equal to the fresh service's (and
     the CPU service's after the first and last step); steps 1-3 replay
     with no full restage, step 4 restages only the top-k plane, step 5
     everything, and step 1's stat replay stages 3 * C * 4,096 * 4 bytes.

  7. (run after phase 6, on its tables) the serving surface around
     ``run_batch``.  (a) The verdict cache: five batches of 128 filter
     queries on events from a pool of 32 of phase 3's int and dictionary
     filter predicates, each in two spellings with one canonical key
     (the first load: every predicate in both spellings and Zipf draws;
     then three refreshes and, after appending phase 6's step 1 again,
     one more, each 128 Zipf draws with s = 1.1), through a service with
     the cache on: each batch equal to the cache-off card service and the
     CPU run, ``verdict_deduped`` = jobs - unique keys, a batch whose
     keys were all seen twice before launches no filter kernel, and the
     batch after the append is served by repair (no launch) and equals a
     fresh card service; each batch's time and its filter stage alone
     beside the cache-off service's, in turns.  (b) A fleet of events and
     11 tables of P = 131,072 whose resident planes pass 1 GiB, under a
     budget of 25% of them: two services share one cache (a re-budget
     raises), reports equal an unbudgeted service's, evictions happen;
     ``fleet_summary()`` logged.  (c) A service sharded over a logical
     mesh of 4 shards on the card: phase 3's 128 filter, 48 LIMIT and 32
     join queries (top-k off) and the 48 top-k queries' boundary inits
     equal to the unsharded service, every launch sharded, each shard's
     kernel launch equal to its plain version on the same inputs;
     ``make_plane_mesh()`` of the machine and the default service.  (d)
     A threaded ``ServingFrontend(max_batch=32, deadline_s=0.01)`` fed
     phase 3's 128 filter and 32 join queries from 4 threads: every
     response equal to a direct ``run_batch``, none unresolved; latency
     percentiles and dispatch causes logged.

  8. (run after phase 7, on its tables) answers and the paper's other
     mechanisms, each driven from the card's reports.  (a) One batch of
     phase 6's 64 selective filters (16 of them top-k), phase 3's 48 plain
     LIMIT, 48 top-k and 24 joins without ORDER BY (distinct and Bloom
     summaries) through ``run_batch``; of each kind at least 8 queries
     (more while the kind's time allows) run through
     ``data.scan.execute_query(q, report)``, their answers equal to an
     oracle over whole columns (filters and joins as multisets of rows,
     top-k by its ordered values, NULLS LAST, a plain LIMIT as min(k,
     matching) rows that satisfy the predicate), and one of each kind
     through ``execute_query(q, None)`` too; the partitions and bytes
     scanned with and without pruning logged.  (b) 16 of phase 6's
     windows and 4 single-leaf scans through ``PruningPipeline(
     adaptive=True)``: no kernel launch, no demotion, kept sets containing
     the card's exact ones, FULL only where the card's is, single leaves
     equal to it.  (c) The top-k predicate cache: phase 3's 48 top-k
     queries recorded from the batch's reports, phase 6's append, every
     lookup a hit whose scan gives a fresh ``run_batch``'s top-k, then an
     update of ``num_sightings`` and every lookup a miss.  (d)
     ``IcebergTable.from_table(events, 8)`` and ``two_level_prune`` on 24
     int and dictionary predicates, each equal to the card's verdict row;
     ``curate`` over a corpus of 65,536 shards equal to the card's scan
     set; a ``PrunedDataLoader`` resumed from ``state()`` gives the same
     batches.  (e) ``ServingFrontend(threaded=True, prefetch=True)`` fed
     filters that read ``score`` from 4 threads while a fifth alternates
     ``update_column("score", A / B)`` 20 times: every response's
     verdicts equal version A's or B's, from two fresh card services.

  9. (run after phase 5, its model freed) the MoE family at full width:
     Qwen3-MoE-30B-A3B (``get_config("qwen3-moe-30b-a3b")``, all 48
     layers, 128 experts top-8, bf16, 60,158,251,008 bytes of weights
     from ``init_params`` seeded by ``--seed``, drawn a layer at a time)
     with phase 5's traffic; the served routes are recorded
     (``RouteTape``) and slots dropped at capacity counted per prefill
     chunk and per decode step (more than none at 4 slots, none at B =
     1); checks: (a) ``flash_attention`` once a layer per prefill; (b) the
     kernel equals its plain version at every layer's q, k, v; (c) the
     served logits agree with the f32 forward given the served routes and
     keep mask (``moe_reference``), and an fp8 control on the same routes
     does not; (d) the plain attention in place of the kernel on the
     served routes agrees with the kernel run (its own routes logged);
     (e) the batcher's decode logits equal a replay of its own decode
     inputs (``batcher_replay``); bounds and reasons at
     ``MOE_VS_F32_TOL``.  Then prefill and decode times and tokens/s, the
     decode step's bound reading every expert and reading only the
     experts with a kept slot, the batcher's requests/s, and the bytes
     held before the init, the weights' and the peak.
  10. the port's seven examples (``examples_torch/``) run in process on
     the card and on the CPU: the same printed counts (times, sampled
     tokens, training losses and checkpoint paths left out;
     ``pruned_pretraining`` with a short argv, ``EXAMPLE_ARGV``).
  11. (run after phase 10, its memory freed) the other four families at
     full width, each model drawn by ``init_params`` from ``--seed`` in
     bf16, served through the ``Generator`` and freed before the next:
     Mamba2-1.3B (ssm; 4 prompts of 2,048 tokens, 16 greedy steps, then
     one prompt of 32,768 tokens, 8 steps), Zamba2-2.7B (hybrid; 4 x
     2,048, 16 steps), Whisper-small (encdec; 4 x 1,500 frames as the
     ``prefix``, a decoder prompt of 64 tokens, 16 steps) and
     LLaVA-NeXT-34B (vlm; 4 x (576 patch embeddings + 2,048 tokens), 16
     steps; 68.78 GB of weights), the prefixes standard normal from the
     seed.  Checks (``serve_family``): (a) ``flash_attention`` launches a
     prefill = 0, 9, 36 and 60, and the ``ContinuousBatcher`` refuses the
     family; (b) the kernel equals its plain version at every launch of
     the served prefill (and is timed at each shape beside its plain
     version, SDPA and its bound); (c) the served logits at the prefill's
     last position and every decode step agree with the f32 forward with
     no cache and no kernel whose SSM layers run the step-by-step
     recurrence (``family_reference_logits``), teacher-forced on the
     served tokens, and an fp8 control is logged beside it (a control
     inside the bound is said, not failed); (d) plain attention in place
     of the kernel agrees with the kernel run; (e) the chunked scan
     agrees with the recurrence in f32 on layer 0's served inputs, and
     after Mamba2's 32,768-token prompt the first decode step's logits
     agree with a 32,769-token prefill's last.  Bounds and reasons at
     ``FAMILY_VS_F32_TOL``.  Then prefill and decode times and tokens/s
     beside the bytes a decode step must read (weights, SSM state, K/V,
     cross K/V) over the memory rate, Mamba2's decode step after 32,768
     tokens beside the one after 2,048, weight bytes and peak memory.

  12. (run after phase 11, its memory freed) training at full width:
     Llama-3.2-3B (``get_config("llama3.2-3b")``, all 28 layers, remat,
     bf16 parameters from ``init_params`` seeded by ``--seed``, f32 AdamW
     moments) on the first batch of a ``PrunedDataLoader`` over the
     curated corpus (4 sequences of 4,096 tokens, 2 microbatches of 2),
     checks in this order: (a) ``flash_attention`` launched twice a layer
     a microbatch (the forward and the remat recompute), 112 a step; (b)
     one microbatch's bf16 gradients finite and non-zero in every leaf and
     within ``TRAIN_VS_F32_TOL`` of the f32 gradients with the plain
     attention, while the control with the kernel's output detached (F3)
     leaves wq, wk, wv off by at least 0.99; (c) layer 0's attention
     backward (BH = 48, S = 4,096, D = 128) against autograd of the plain
     attention, and the kernel's forward against its plain version; (d)
     the loss falling over 5 steps of ``make_train_step(AdamW(lr=1e-3),
     microbatches=2)``; (e) the first AdamW update of layer 0's wq and of
     the embedding equal to the CPU's within 1 ulp; (f) the port's
     ``launch.train`` restart drill at its default_config (stopped at
     step 6, resumed from step 5 with its state restored bit for bit,
     losses within 1e-3 of an uninterrupted run's, a checkpoint restored
     on the CPU bit for bit).  Then the step's time, tokens/s and 6ND
     share, its split (forward, recompute, plain attention backward, the
     rest of the backward, the update) and peak memory.  Bounds and
     reasons at ``TRAIN_VS_F32_TOL``.

  13. (run after phase 12, on its live state) the mesh: (a)
     ``make_host_mesh()`` and ``plan_mesh()`` are (1, 1) on a one-rank
     NCCL group; phase 12's state resharded onto it, one step (its batch,
     2 microbatches) under ``use_mesh`` equals the step without a mesh
     from the same state bit for bit (loss, every parameter, m, v and the
     step; deterministic algorithms on; the state's copies on the host),
     112 flash launches each; (b) ``compressed_psum`` over that group
     bit for bit ``_quantize``'s dequantisation, and over 4 gloo ranks'
     CUDA tensors spawned on the card bit for bit the plain int8 sum; (c)
     the sharded dense step on those 4 ranks as a 2x2 (data, model) mesh,
     every leaf's gradient within ``TRAIN_VS_F32_TOL`` of the one-rank
     step's, flash on each rank's local heads: on the CPU at the smoke
     config (``SHARDED_STEP_DEVICE``: gloo's functional all-gather of
     CUDA tensors kills a rank); (d) the port's dry-run in subprocesses
     on the host's cores, started with phase 3's references and done
     beside them and phase 2, before any timed phase: the six smoke cells of the
     JAX package's ``tests/test_dryrun.py``, ``kimi-k2-1t-a32b
     train_4k`` again under the ``"resident"`` MoE layout with the
     ``"grouped"`` dispatch, and ``llama3.2-3b train_4k`` at full width
     on 16x16 and 2x16x16, each OK with its peak bytes a device within
     the card's 80 GB, its collective bytes by axis and its roofline
     (derived from H100 peaks); (e) on the 4 gloo ranks after (c), on
     the card's tensors (``MOE_MESH_DEVICE``): one Qwen3-MoE-30B-A3B MoE
     layer at full width (d_model 2,048, 128 experts top-8, expert d_ff
     768, bf16 weights from the seed), 4 x 2,048 tokens in 8 dispatch
     chunks, dispatched expert-parallel on the 2x2 (data, model) mesh
     under ``"scatter"`` + ``"fsdp"`` (experts over ``model``) and
     ``"grouped"`` + ``"resident"`` (experts over ``data``, d_ff over
     ``model``), given the one-card routes: every rank's kept slots equal
     to ``moe.kept_slots`` on the global routes, y bit for bit the
     one-card ``dispatch_scatter`` under the first and within
     ``MOE_VS_F32_TOL`` of ``dispatch_grouped`` under the second, with
     the collective bytes counted by kind, the seconds and the expert
     bytes a rank holds.  The phase tears its process group down.
 14. (after phase 2's report, before phase 3) the JOIN build summary on
     the card: ``bloom_build`` (dedupe and Bloom-set, no TPU kernel)
     through ``ops.summarize_build_batched_device``, batched and one
     build side a call, against its plain version and numpy's
     ``summarize_build`` field for field, Bloom words bit for bit, on the
     CPU tests' key sets (empty, all null, NDV at and over the 4,096
     limit, heavy duplicates, sparse, int64 extremes, int32, float64-encoded
     integers) and on three Q3 build sides of 250,000 sparse keys in
     1..6e9, float64 as a table holds them; the kernels' time
     at a Q3 (CUDA events, L2 flushed) beside their byte bound and the
     plain version's and numpy's times; the service's card path against
     the host summary from 1,024 to 250,000 keys (the crossover) and six
     Q3 sides in one call.

Phases 3, 4, 6 and 8 run their services with the verdict cache off, so
that every batch launches its table groups' kernels.  The kernels'
build and phase 2 run in a process of their own, beside phase 3's
tables and host references (the CPU service and the f64 host pipeline),
which need the host alone.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed just before them.  Without a CUDA device, or without the rest of
the repository beside this file, the script exits non-zero before any
result is printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The port's kernels, in the order of the pipeline's stages: (the path
# that launches it: phase 3's service technique counter, PER_QUERY for
# phase 4 or LM for phase 5; its stage; the TPU kernel it replaces, by the
# JAX package's wrapper).
PER_QUERY = "per-query"
LM = "lm-serving"
KERNELS = {
    "minmax_prune_batched": ("filter", "filter",
                             "src/repro/kernels/minmax_prune_batched.py:82"),
    "join_overlap_batched": ("join", "join",
                             "src/repro/kernels/join_overlap.py:67"),
    "bloom_probe_batched": ("join_bloom", "join",
                            "src/repro/kernels/bloom_probe.py:100"),
    "topk_init_batched": ("topk", "topk",
                          "src/repro/kernels/topk_boundary.py:140"),
    "minmax_prune": (PER_QUERY, "filter",
                     "src/repro/kernels/minmax_prune.py:49"),
    "join_overlap": (PER_QUERY, "join",
                     "src/repro/kernels/join_overlap.py:116"),
    "topk_boundary": (PER_QUERY, "topk",
                      "src/repro/kernels/topk_boundary.py:185"),
    "flash_attention": (LM, "prefill",
                        "src/repro/kernels/flash_attention.py:81"),
}
# Phase 3's kernels by the service's technique counter.
MAIN_KERNELS = {path: name for name, (path, _, _) in KERNELS.items()
                if path not in (PER_QUERY, LM)}

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the f32 rate
# outside the tensor cores, which also stands for the 32-bit integer ALU
# operations of the hash and the compares (the int32 rate is not above it).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events around
    each run), with the 50 MB L2 cache flushed before every run: a batch
    finds the resident planes cold, not in L2 from the previous launch."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for e0, e1 in zip(starts, ends):
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / reps


def host_ms(fn, dev) -> float:
    """Host-clock time of ``fn`` between two synchronisations."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def abs_err(got, want) -> float:
    """Largest |got - want| (0 when equal, inf on a shape or infinity
    mismatch)."""
    import torch
    if got.shape != want.shape:
        return math.inf
    if torch.equal(got, want):
        return 0.0
    g, w = got.double(), want.double()
    d = (g - w).abs()
    d[g == w] = 0.0
    d[torch.isnan(d)] = math.inf
    return float(d.max().item())


def require_equal(name: str, got, want, where: str) -> float:
    err = abs_err(got, want)
    if err:
        raise SystemExit(f"{name} kernel != plain version at {where}: "
                         f"max abs err {err}")
    return err


def short_name(mangled: str) -> str:
    """``flash_tc_kernel<128>`` from a kernel's mangled name in the
    anonymous namespace of its source file."""
    import re
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    t = re.match(r"ILi(\d+)E", rest[n:])
    return rest[:n] + (f"<{t.group(1)}>" if t else "")


def build_report(card: str) -> dict:
    """Phase 1's look at what was built: each kernel function's registers
    and spill bytes as ptxas reported them, and the tensor-core
    instructions in ``flash_attention``'s SASS (HMMA: mma.sync, HGMMA:
    wgmma; ``cuobjdump -sass``), which must be more than none."""
    import re

    from repro_torch.kernels import build, ops

    out = {}
    for name in ops.KERNELS:
        fns, cur = {}, None
        for line in build.ptxas_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = fns.setdefault(short_name(m.group(1)), {})
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur is not None:
                cur["spill_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m and cur is not None:
                cur["static_smem_bytes"] = int(m.group(1))
        out[name] = fns
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    hmma = len(re.findall(r"\bHMMA\b", sass))
    hgmma = len(re.findall(r"\bHGMMA\b", sass))
    log(f"[env] {card}: flash_attention SASS: {hmma} HMMA (mma.sync), "
        f"{hgmma} HGMMA (wgmma); ptxas: " + "; ".join(
            f"{fn} {r.get('registers')} registers, {r.get('spill_bytes')} "
            f"bytes spilled" for fn, r in out["flash_attention"].items()))
    for name in ("topk_init_batched", "minmax_prune_batched",
                 "bloom_probe_batched", "minmax_prune", "topk_boundary"):
        log(f"[env] {card}: {name} ptxas: " + "; ".join(
            f"{fn} {r.get('registers')} registers, {r.get('spill_bytes')} "
            f"bytes spilled, {r.get('static_smem_bytes')} bytes static "
            f"shared" for fn, r in out[name].items()))
    if hmma + hgmma == 0:
        raise SystemExit("flash_attention's SASS holds no tensor-core "
                         "instruction")
    return dict(ptxas=out, flash_hmma=hmma, flash_hgmma=hgmma)


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

F32_MAX = np.float32(np.finfo(np.float32).max)
DENORMALS = np.array([1e-45, 1e-40, 1.1754942e-38, -1e-45, -1e-40, 0.0,
                      -0.0], dtype=np.float32)


def random_planes(rng, C: int, P: int, cap: int):
    """[C, cap] planes: integer-ish intervals, denormal values, all-null
    style demotes, drop sentinels inside P and the sentinel tail."""
    mins = rng.integers(-1000, 1000, (C, cap)).astype(np.float32)
    maxs = mins + rng.integers(0, 200, (C, cap)).astype(np.float32)
    den = rng.random((C, cap)) < 0.05
    mins[den] = rng.choice(DENORMALS, int(den.sum()))
    maxs[den] = np.maximum(mins[den], rng.choice(DENORMALS, int(den.sum())))
    demote = (rng.random((C, cap)) < 0.25).astype(np.float32)
    drop = rng.random((C, cap)) < 0.05
    drop[:, P:] = True
    mins[drop], maxs[drop], demote[drop] = F32_MAX, -F32_MAX, 1.0
    return mins, maxs, demote


def random_constraints(rng, Q: int, Kb: int, C: int, mins, maxs, P: int):
    cids = rng.integers(0, C, (Q, Kb)).astype(np.int32)
    lo = rng.integers(-1100, 1100, (Q, Kb)).astype(np.float32)
    hi = lo + rng.integers(0, 400, (Q, Kb)).astype(np.float32)
    # bounds equal to a stat of some partition (inclusive ends)
    pick = rng.integers(0, max(P, 1), (Q, Kb))
    eq = rng.random((Q, Kb)) < 0.3
    lo[eq] = mins[cids[eq], pick[eq]]
    eq = rng.random((Q, Kb)) < 0.3
    hi[eq] = maxs[cids[eq], pick[eq]]
    # denormal bounds
    den = rng.random((Q, Kb)) < 0.15
    lo[den] = rng.choice(DENORMALS, int(den.sum()))
    den = rng.random((Q, Kb)) < 0.15
    hi[den] = rng.choice(DENORMALS, int(den.sum()))
    # one-sided and no-op slots
    lo[rng.random((Q, Kb)) < 0.1] = -F32_MAX
    hi[rng.random((Q, Kb)) < 0.1] = F32_MAX
    noop = rng.random((Q, Kb)) < 0.25
    lo[noop], hi[noop] = -np.inf, np.inf
    return cids, lo, hi


def minmax_cases(rng, dev, sizes) -> dict:
    import torch

    from repro_torch.core.device_stats import plane_capacity
    from repro_torch.kernels.minmax_prune_batched import minmax_prune_batched
    from repro_torch.kernels.ref import minmax_prune_batched_ref

    cases, max_p = 0, 0
    for C in (1, 6, 33):
        for P in sizes:
            cap = plane_capacity(P)
            mins, maxs, demote = random_planes(rng, C, P, cap)
            planes = [torch.from_numpy(a).to(dev) for a in (mins, maxs, demote)]
            for Q in (1, 7, 256, 300):
                for Kb in (1, 2, 4, 8):
                    cids, lo, hi = random_constraints(rng, Q, Kb, C, mins,
                                                      maxs, P)
                    cq = [torch.from_numpy(a).to(dev) for a in (cids, lo, hi)]
                    got = minmax_prune_batched(*cq, *planes, num_partitions=P)
                    sync(dev)
                    want = minmax_prune_batched_ref(*cq, *planes,
                                                    num_partitions=P)
                    require_equal("minmax_prune_batched", got, want,
                                  f"Q={Q} Kb={Kb} C={C} P={P}")
                    max_p = max(max_p, P)
                    cases += 1
            del planes
    # conjunctions longer than the kernel's 2048-slot shared tile: a
    # block stages its slots in chunks
    for Q, Kb, P in ((3, 3000, 4097), (2, 8192, 4097), (33, 2049, 31)):
        C = 6
        mins, maxs, demote = random_planes(rng, C, P, plane_capacity(P))
        cids, lo, hi = random_constraints(rng, Q, Kb, C, mins, maxs, P)
        # keep the long conjunctions satisfiable: mostly no-op slots
        keep = rng.random((Q, Kb)) < 0.02
        lo[~keep], hi[~keep] = -np.inf, np.inf
        args = [torch.from_numpy(a).to(dev)
                for a in (cids, lo, hi, mins, maxs, demote)]
        got = minmax_prune_batched(*args, num_partitions=P)
        sync(dev)
        want = minmax_prune_batched_ref(*args, num_partitions=P)
        require_equal("minmax_prune_batched", got, want,
                      f"Q={Q} Kb={Kb} C={C} P={P}")
        cases += 1
    # the kernel's edges: P = 1, 3, 15 mod 16 (rows of tv that start off
    # a 4-byte boundary), capacities P + 3 (plane rows off a 16-byte
    # boundary), more slots than its 1024-slot tile, more referenced
    # columns than its 4-column shared tile (C = 33) and than its
    # 1024-column map (C = 1100: every slot read from global memory), and
    # phase 3's largest group at P = 2**20 - 1
    for Q, Kb, C, P, cap in ((5, 2, 6, 4097, None), (64, 3, 6, 4099, None),
                             (300, 2, 33, 4111, None), (7, 4, 6, 4097, 4100),
                             (40, 8, 33, 2049, 2052), (1100, 1, 6, 1000, None),
                             (3, 5, 1100, 37, 40),
                             (176, 2, 6, (1 << 20) - 1, (1 << 20) + 2)):
        mins, maxs, demote = random_planes(rng, C, P,
                                           cap or plane_capacity(P))
        cids, lo, hi = random_constraints(rng, Q, Kb, C, mins, maxs, P)
        args = [torch.from_numpy(a).to(dev)
                for a in (cids, lo, hi, mins, maxs, demote)]
        got = minmax_prune_batched(*args, num_partitions=P)
        sync(dev)
        want = minmax_prune_batched_ref(*args, num_partitions=P)
        require_equal("minmax_prune_batched", got, want,
                      f"Q={Q} Kb={Kb} C={C} P={P} capacity={mins.shape[1]}")
        cases += 1
        del args, got, want
    # the planes as views of one tensor at storage offsets that differ mod
    # 16 bytes: mins aligned and maxs not, staged and read from global
    for Q, Kb, C, P, cap, gaps in ((64, 3, 6, 4096, None, (0, 1, 3)),
                                   (7, 2, 3, 4096, 4099, (0, 0, 0)),
                                   (40, 8, 33, 2049, None, (0, 2, 1))):
        planes = random_planes(rng, C, P, cap or plane_capacity(P))
        cids, lo, hi = random_constraints(rng, Q, Kb, C, *planes[:2], P)
        cq = [torch.from_numpy(a).to(dev) for a in (cids, lo, hi)]
        views = packed_planes(planes, gaps, dev)
        got = minmax_prune_batched(*cq, *views, num_partitions=P)
        sync(dev)
        want = minmax_prune_batched_ref(*cq, *views, num_partitions=P)
        require_equal("minmax_prune_batched", got, want,
                      f"Q={Q} Kb={Kb} C={C} P={P} plane gaps {gaps}")
        cases += 1
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p)


def packed_planes(planes, gaps, dev):
    """The three [C, Pc] planes as contiguous views of one flat tensor on
    ``dev``, plane i starting gaps[i] elements after the end of plane
    i - 1."""
    import torch
    n = planes[0].size
    flat = torch.empty(sum(gaps) + 3 * n, dtype=torch.float32, device=dev)
    out, at = [], 0
    for a, gap in zip(planes, gaps):
        at += gap
        out.append(flat[at:at + n].view(a.shape))
        out[-1].copy_(torch.from_numpy(a))
        at += n
    return out


def join_cases(rng, dev, sizes) -> dict:
    import torch

    from repro_torch.core.device_stats import plane_capacity
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.join_overlap import join_overlap_batched
    from repro_torch.kernels.ref import join_overlap_batched_ref

    cases, max_p, paths = 0, 0, {}
    grid = [(P, Q, D) for P in sizes for Q in (1, 7, 48)
            for D in (1, 64, 4096)] + [(4097, 3, 9000)]
    for P, Q, max_keys in grid:
        cap = plane_capacity(P)
        pmin = rng.integers(-5000, 10_000, cap).astype(np.float32)
        pmax = pmin + rng.integers(0, 100, cap).astype(np.float32)
        drop = rng.random(cap) < 0.1
        drop[P:] = True                         # capacity tail
        pmin[drop], pmax[drop] = F32_MAX, -F32_MAX
        lists = []
        for qi in range(Q):
            keys = rng.integers(-5000, 10_000,
                                int(rng.integers(1, max_keys + 1)))
            if qi % 3 == 0:                      # a partition's own bounds
                p = int(rng.integers(0, P))
                keys = np.append(keys, [pmin[p], pmax[p]])
            lists.append(np.unique(keys).astype(np.float32))
        dist = torch.from_numpy(ops.pack_distinct(lists)).to(dev)
        plane = [torch.from_numpy(a).to(dev) for a in (pmin, pmax)]
        got = join_overlap_batched(dist, *plane, num_partitions=P)
        sync(dev)
        want = join_overlap_batched_ref(dist, *plane, num_partitions=P)
        require_equal("join_overlap_batched", got, want,
                      f"Q={Q} Db={dist.shape[1]} P={P}")
        add_paths(paths, dist, *plane, ref.JOIN_TILE_BATCHED, P)
        max_p = max(max_p, P)
        cases += 1
    # clustered planes (the events plane's shape: narrow, nearly sorted
    # intervals, all-empty tiles) with sparse and dense key rows, and
    # tiles whose windows take each path of the kernel
    for P, Q, n_keys in [(P, Q, n) for P in sizes for Q in (1, 16, 70)
                         for n in (40, 3000)] + [(None, 3, None),
                                                 (None, 70, None)]:
        if P is None:
            pmin, pmax, keys = window_plane(rng, WINDOW_SIZES,
                                            ref.JOIN_TILE_BATCHED, F32_MAX)
            P = pmin.size
            cap = plane_capacity(P)
            pmin = np.concatenate([pmin, np.full(cap - P, F32_MAX)])
            pmax = np.concatenate([pmax, np.full(cap - P, -F32_MAX)])
            lists = [keys[int(rng.integers(0, 3)):][::int(rng.integers(1, 3))]
                     for _ in range(Q - 1)] + [keys]
        else:
            cap = plane_capacity(P)
            pmin, pmax = clustered_join_plane(rng, P, cap, F32_MAX,
                                              ref.JOIN_TILE_BATCHED)
            lists = [clustered_join_keys(rng, pmin, pmax, P, n_keys,
                                         ref.JOIN_TILE_BATCHED)
                     for _ in range(Q)]
        dist = torch.from_numpy(ops.pack_distinct(lists)).to(dev)
        plane = [torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (pmin, pmax)]
        got = join_overlap_batched(dist, *plane, num_partitions=P)
        sync(dev)
        want = join_overlap_batched_ref(dist, *plane, num_partitions=P)
        require_equal("join_overlap_batched", got, want,
                      f"clustered Q={Q} Db={dist.shape[1]} P={P}")
        add_paths(paths, dist, *plane, ref.JOIN_TILE_BATCHED, P)
        max_p = max(max_p, P)
        cases += 1
    log_paths("join_overlap_batched", paths)
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p, paths=paths)


# Key windows a tile of window_plane holds: empty, 1 and 32 (held in a
# warp's lanes), 1,024 and 4,096 (staged), 33, 1,023, 4,097 and 9,000 (in
# place)
WINDOW_SIZES = (0, 1, 32, 33, 1023, 1024, 4096, 4097, 9000, 0)


def clustered_join_plane(rng, P, cap, sentinel, tile):
    """Join-key intervals like the events table's ``user_id`` ones: at most
    40 ids wide over a running sum of small steps (nearly sorted), 5% and
    two whole tiles of ``tile`` partitions empty (``sentinel``,
    -``sentinel``), the capacity tail too."""
    start = np.cumsum(rng.integers(0, 4, cap)) + rng.integers(-2, 3, cap)
    pmin = start.astype(np.float32)
    pmax = (start + rng.integers(0, 41, cap)).astype(np.float32)
    gone = rng.random(cap) < 0.05
    t0 = (P // 3) // tile * tile
    if 4 * tile <= P:
        gone[t0:t0 + 2 * tile] = True
    gone[P:] = True
    pmin[gone], pmax[gone] = sentinel, -sentinel
    return pmin, pmax


def clustered_join_keys(rng, pmin, pmax, P, n, tile):
    """At most n distinct ids over the live range of the first P intervals,
    sorted, with one tile's min pmin and max pmax among them."""
    live = pmin[:P] <= pmax[:P]
    if not live.any():
        return np.array([1.0], np.float32)
    lo, hi = float(pmin[:P][live].min()), float(pmax[:P][live].max())
    keys = rng.integers(int(lo) - 50, int(hi) + 50, n)
    t = int(rng.integers(0, -(-P // tile)))
    s = slice(t * tile, min((t + 1) * tile, P))
    if live[s].any():
        keys = np.append(keys, [pmin[s][live[s]].min(),
                                pmax[s][live[s]].max()])
    return np.unique(keys).astype(np.float32)


def window_plane(rng, sizes, tile, sentinel):
    """Intervals [len(sizes) * tile] and the keys 0, 1, 2, ... such that
    tile i's key window holds exactly sizes[i] keys (its first partition
    spans the window, the others lie inside, 10% empty)."""
    pmin = np.empty(len(sizes) * tile, np.float32)
    pmax = np.empty_like(pmin)
    at = 0
    for i, w in enumerate(sizes):
        s = slice(i * tile, (i + 1) * tile)
        if w == 0:
            pmin[s], pmax[s] = at + 0.25, at + 0.75
        else:
            lo = at + rng.integers(0, w, tile)
            pmin[s] = lo
            pmax[s] = np.minimum(lo + rng.integers(0, 40, tile), at + w - 1)
            pmin[i * tile], pmax[i * tile] = at, at + w - 1
            empty = rng.random(tile) < 0.1
            empty[0] = False
            pmin[s][empty], pmax[s][empty] = sentinel, -sentinel
        at += w + 1
    return pmin, pmax, np.arange(at, dtype=np.float32)


def add_paths(paths: dict, keys, pmin, pmax, tile: int, P: int) -> None:
    """Add to ``paths`` the (query, tile) windows of these inputs by the
    kernel path each takes (``ref.window_paths``)."""
    from repro_torch.kernels import ref
    rows = keys if keys.dim() == 2 else keys[None]
    for k, v in ref.window_paths(*ref.join_windows(rows, pmin, pmax, tile,
                                                   P)).items():
        paths[k] = paths.get(k, 0) + v


def log_paths(name: str, paths: dict) -> None:
    log(f"[kernels] {name}: (query, tile) windows by path: " + ", ".join(
        f"{k} {v}" for k, v in paths.items()))
    if min(paths.values()) == 0:
        raise SystemExit(f"{name}: a window path was never taken: {paths}")


def bloom_cases(rng, dev, sizes, limit: int = 64) -> dict:
    import torch

    from repro_torch.core.device_stats import plane_capacity
    from repro_torch.core.prune_join import BlockedBloom
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import bloom_probe_batched
    from repro_torch.kernels.ref import bloom_probe_batched_ref

    cases, max_p = 0, 0
    for P in sizes:
        cap = plane_capacity(P)
        pmin = rng.integers(-3000, 3000, cap).astype(np.int32)
        width = rng.integers(0, 40, cap).astype(np.int32)
        width[rng.random(cap) < 0.1] = 0
        width[rng.random(cap) < 0.05] = 2 * limit        # above the limit
        if P >= 2:                                       # ends of int32
            pmin[0], width[0] = np.iinfo(np.int32).min, 7
            pmin[1], width[1] = np.iinfo(np.int32).max - 9, 10
        width[P:] = 0
        plane = [torch.from_numpy(pmin).to(dev), torch.from_numpy(
            np.where(width <= limit, width, 0).astype(np.int32)).to(dev)]
        for n_blocks in ((1,), (8,), (256,), (1024,), (1, 8, 256, 1024)):
            for Q in (1, 33):
                blooms = []
                for qi in range(Q):
                    nb = n_blocks[qi % len(n_blocks)]
                    b = BlockedBloom(nb * 32)        # 16 bits a key: nb blocks
                    b.add(rng.integers(-3000, 3000, nb * 32))
                    blooms.append(b)
                words = torch.from_numpy(ops.pack_blooms(blooms)).to(dev)
                got = bloom_probe_batched(words, *plane, num_partitions=P)
                sync(dev)
                want = bloom_probe_batched_ref(words, *plane,
                                               num_partitions=P)
                require_equal("bloom_probe_batched", got, want,
                              f"Q={Q} blocks={n_blocks} P={P}")
                max_p = max(max_p, P)
                cases += 1
    # the kernel's edges: Q across its 8-, 16- and 32-query chunks, tables
    # of 1 to 1024 blocks, all widths 0, one very wide partition among
    # narrow ones in a warp, and the ends of int32
    P = 4097
    cap = plane_capacity(P)
    for Q in (1, 16, 32, 33, 70):
        for nb in (1, 64, 256, 1024):
            for edge in ("random", "zero", "wide"):
                pmin = rng.integers(-3000, 3000, cap).astype(np.int32)
                width = rng.integers(0, 40, cap).astype(np.int32)
                width[rng.random(cap) < 0.1] = 0
                pmin[0], width[0] = np.iinfo(np.int32).min, 7
                pmin[1], width[1] = np.iinfo(np.int32).max - 9, 10
                if edge == "zero":
                    width[:] = 0
                elif edge == "wide":
                    width[32:64] = rng.integers(0, 3, 32)
                    width[45] = 20_000
                    pmin[45] = -10_000
                width[P:] = 0
                blooms = []
                for _ in range(Q):
                    b = BlockedBloom(nb * 32)
                    b.add(rng.integers(-3000, 3000, nb * 32))
                    blooms.append(b)
                words = torch.from_numpy(ops.pack_blooms(blooms)).to(dev)
                plane = [torch.from_numpy(a).to(dev) for a in (pmin, width)]
                got = bloom_probe_batched(words, *plane, num_partitions=P)
                sync(dev)
                want = bloom_probe_batched_ref(words, *plane,
                                               num_partitions=P)
                require_equal("bloom_probe_batched", got, want,
                              f"Q={Q} blocks={nb} P={P} widths {edge}")
                cases += 1
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p)


def topk_plane(rng, dev, P: int, K: int, edge: str = "random"):
    """A [P, K] block-top-k plane on ``dev``, rows sorted descending and
    each cut to its own count, -inf padded, 10% all -inf: small integers
    (ties) or, at an ``edge``, every row head 7 ("equal_heads"), every
    value 3 ("equal_values"), 80% all -inf rows ("neg_inf_rows"), at most
    2 values a row ("few_values") or values of both signed zeros and +-1
    ("signed_zeros")."""
    import torch

    if edge == "signed_zeros":
        pick = np.array([0.0, -0.0, 1.0, -1.0], np.float32)
        vals = torch.from_numpy(pick[rng.integers(0, 4, (P, K))]).to(dev)
    else:
        vals = torch.from_numpy(rng.integers(-60, 60, (P, K)).astype(
            np.float32)).to(dev)
    if edge == "equal_values":
        vals.fill_(3.0)
    plane = torch.sort(vals, dim=1, descending=True).values
    if edge == "equal_heads":
        plane = torch.minimum(plane, torch.tensor(6.0, device=dev))
        plane[:, 0] = 7.0
    n = rng.integers(0, K + 1, P)
    n[rng.random(P) < (0.8 if edge == "neg_inf_rows" else 0.1)] = 0
    if edge == "few_values":
        n = np.minimum(n, 2)
    cut = torch.arange(K, device=dev)[None, :] >= \
        torch.from_numpy(n).to(dev)[:, None]
    plane[cut] = float("-inf")
    return plane


TOPK_EDGES = ("equal_heads", "equal_values", "neg_inf_rows", "empty",
              "duplicates", "few_values", "signed_zeros")


def topk_check(plane, lists, ks, dev, where: str) -> int:
    """``topk_init_batched`` on the card against its plain version, for
    each k of ``ks``; returns the number of cases."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import topk_init_batched_ref
    from repro_torch.kernels.topk_boundary import topk_init_batched

    offsets, ids = (torch.from_numpy(a).to(dev)
                    for a in ops.pack_candidates(lists))
    for k in ks:
        got = topk_init_batched(plane, offsets, ids, k)
        sync(dev)
        want = topk_init_batched_ref(plane, offsets, ids, k)
        require_equal("topk_init_batched", got, want,
                      f"{where} Q={len(lists)} k={k} P={plane.shape[0]} "
                      f"nnz={int(ids.numel())}")
    return len(ks)


def topk_cases(rng, dev, sizes, K: int = 64) -> dict:
    """``topk_init_batched``: planes of small integers (ties, all -inf
    rows) with 6 or 48 queries (one empty, one of every row, the rest
    random subsets, long enough at P = 2**21 for many slabs) at k in {1,
    3, 64, 128}; each of ``TOPK_EDGES`` at P = 4097 (lists that repeat
    ids, all but one query empty) at k in {1, 2, 17, 100, 127, 128}; and
    70,000 queries of at most 3 candidates (more than a grid's 65,535 in
    y)."""
    from repro_torch.core.device_stats import plane_capacity

    cases, max_p = 0, 0
    for P in sizes:
        plane = topk_plane(rng, dev, plane_capacity(P), K)
        plane[P:] = float("-inf")
        Q = 48 if P > 4096 else 6
        lists = [np.zeros(0, dtype=np.int32), np.arange(P, dtype=np.int32)]
        for _ in range(Q - 2):
            keep = rng.random(P) < rng.choice([0.001, 0.05, 0.5])
            lists.append(np.nonzero(keep)[0].astype(np.int32))
        cases += topk_check(plane, lists, (1, 3, 64, 128), dev, "random")
        max_p = max(max_p, P)
        del plane
    P = 4097
    for edge in TOPK_EDGES:
        plane = topk_plane(rng, dev, P, K, edge)
        lists = [np.zeros(0, dtype=np.int32), np.arange(P, dtype=np.int32)]
        for _ in range(6):
            if edge == "empty":
                ids = np.zeros(0, dtype=np.int64)
            elif edge == "duplicates":
                ids = rng.integers(0, P, int(rng.integers(1, 3 * P)))
            else:
                ids = np.nonzero(rng.random(P) < rng.choice([0.01, 0.3,
                                                             0.9]))[0]
            lists.append(ids.astype(np.int32))
        if edge == "empty":
            lists[1] = lists[1][:0]
            lists[-1] = np.arange(0, P, 3, dtype=np.int32)
        cases += topk_check(plane, lists, (1, 2, 17, 100, 127, 128), dev,
                            edge)
    plane = topk_plane(rng, dev, P, K)
    lists = [rng.integers(0, P, int(rng.integers(0, 4))).astype(np.int32)
             for _ in range(70_000)]
    cases += topk_check(plane, lists, (1, 5), dev, "many queries")
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p)


# P of the per-query kernels' grids: 2048 is the TPU kernels' block
SINGLE_SIZES = (1, 7, 2047, 2048, 2049, 1 << 20, 1 << 21)


def minmax_single_cases(rng, dev, sizes) -> dict:
    """``minmax_prune``: K in {1, 3} at every P, and K in {2049, 8192}
    (past the kernel's 2048-slot shared tile, in chunks) at the small P;
    empty intervals, nullable rows, bounds equal to a stat, denormal bounds
    and stats."""
    import torch

    from repro_torch.kernels.minmax_prune import minmax_prune
    from repro_torch.kernels.ref import minmax_prune_ref

    cases, max_p = 0, 0
    grid = [(K, P) for P in sizes for K in (1, 3)] + \
        [(K, P) for K in (2049, 8192) for P in sizes if P <= 4096]
    for K, P in grid:
        mins = rng.integers(-1000, 1000, (K, P)).astype(np.float32)
        maxs = mins + rng.integers(0, 200, (K, P)).astype(np.float32)
        den = rng.random((K, P)) < 0.05
        mins[den] = rng.choice(DENORMALS, int(den.sum()))
        maxs[den] = np.maximum(mins[den], rng.choice(DENORMALS,
                                                     int(den.sum())))
        empty = rng.random((K, P)) < 0.05
        mins[empty], maxs[empty] = np.inf, -np.inf
        nullable = (rng.random((K, P)) < 0.2).astype(np.float32)
        lo = rng.integers(-1100, 1100, K).astype(np.float32)
        hi = lo + rng.integers(0, 800, K).astype(np.float32)
        pick = rng.integers(0, P, K)
        eq = rng.random(K) < 0.3
        lo[eq] = np.where(np.isfinite(mins[eq, pick[eq]]),
                          mins[eq, pick[eq]], lo[eq])
        lo[rng.random(K) < 0.1] = DENORMALS[0]
        if K > 64:                 # long conjunctions: mostly wide ranges
            wide = rng.random(K) < 0.98
            lo[wide], hi[wide] = -2000.0, 2000.0
        args = [torch.from_numpy(a).to(dev)
                for a in (lo, hi, mins, maxs, nullable)]
        got = minmax_prune(*args)
        sync(dev)
        require_equal("minmax_prune", got, minmax_prune_ref(*args),
                      f"K={K} P={P}")
        max_p = max(max_p, P)
        cases += 1
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p)


def join_single_cases(rng, dev, sizes) -> dict:
    """``join_overlap``: key lists of D from 1 past the kernel's
    4096-key staged capacity, keys on a partition's bounds, denormal
    intervals and keys, keys at both infinities and empty partitions
    (+inf, -inf); then clustered intervals and tiles whose windows take
    each of the kernel's paths."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.join_overlap import join_overlap
    from repro_torch.kernels.ref import join_overlap_ref

    cases, max_p, paths = 0, 0, {}
    for P in sizes:
        pmin = rng.integers(-5000, 10_000, P).astype(np.float32)
        pmax = pmin + rng.integers(0, 100, P).astype(np.float32)
        den = rng.random(P) < 0.02
        pmin[den], pmax[den] = -DENORMALS[1], DENORMALS[0]
        empty = rng.random(P) < 0.05
        pmin[empty], pmax[empty] = np.inf, -np.inf
        plane = [torch.from_numpy(a).to(dev) for a in (pmin, pmax)]
        live = np.nonzero(~empty)[0]
        for D in (1, 64, 4096, 4097, 9000):
            p = rng.choice(live, min(4, live.size)) if live.size else []
            extra = np.concatenate([pmin[p], pmax[p], DENORMALS[:2],
                                    [-np.inf, np.inf]]).astype(np.float32)
            keys = np.unique(np.concatenate([rng.choice(
                np.arange(-5000, 10_000), D, replace=False), extra]
            ).astype(np.float32))
            # exactly D distinct keys, most of the edge keys among them
            keys = np.delete(keys, rng.choice(keys.size, keys.size - D,
                                              replace=False))
            d = torch.from_numpy(keys).to(dev)
            got = join_overlap(*plane, d)
            sync(dev)
            require_equal("join_overlap", got, join_overlap_ref(*plane, d),
                          f"P={P} D={int(d.numel())}")
            add_paths(paths, d, *plane, ref.JOIN_TILE_SINGLE, P)
            max_p = max(max_p, P)
            cases += 1
    # clustered intervals with all-empty tiles, keys at both infinities and
    # -0.0, intervals that are a zero or reach +inf, and tiles whose
    # windows take each path of the kernel
    inf = np.float32(np.inf)
    for P, n_keys in [(P, n) for P in sizes for n in (40, 7132)] + [
            (None, None)]:
        if P is None:
            pmin, pmax, keys = window_plane(rng, WINDOW_SIZES,
                                            ref.JOIN_TILE_SINGLE, inf)
            P = pmin.size
        else:
            pmin, pmax = clustered_join_plane(rng, P, P, inf,
                                              ref.JOIN_TILE_SINGLE)
            keys = clustered_join_keys(rng, pmin, pmax, P, n_keys,
                                       ref.JOIN_TILE_SINGLE)
            keys = np.unique(np.concatenate([keys, [-inf, inf, 0.0]])
                             ).astype(np.float32)
            keys[keys == 0] = np.float32(-0.0)
            if P >= 4:
                pmin[1:4], pmax[1:4] = [0.0, 7.0, inf], [0.0, inf, inf]
        plane = [torch.from_numpy(a).to(dev) for a in (pmin, pmax)]
        d = torch.from_numpy(keys).to(dev)
        got = join_overlap(*plane, d)
        sync(dev)
        require_equal("join_overlap", got, join_overlap_ref(*plane, d),
                      f"clustered P={P} D={int(d.numel())}")
        add_paths(paths, d, *plane, ref.JOIN_TILE_SINGLE, P)
        max_p = max(max_p, P)
        cases += 1
    log_paths("join_overlap", paths)
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p, paths=paths)


def topk_rows(gen, dev, P: int, k: int, order: str, lo: int, hi: int):
    """[P, k] block-top-k rows made on the card: integers in [lo, hi)
    (ties), each row cut to a random count and -inf padded, 10% all -inf;
    in random order, by descending head (the scan's sort strategy), or
    with strictly rising heads (every row merges)."""
    import torch
    if order == "ascending":
        heads = 2.0 * torch.arange(P, device=dev, dtype=torch.float32)
        return heads[:, None] - torch.arange(k, device=dev,
                                             dtype=torch.float32)[None, :]
    rows = torch.randint(lo, hi, (P, k), generator=gen, device=dev).float()
    rows = torch.sort(rows, dim=1, descending=True).values
    n = torch.randint(0, k + 1, (P,), generator=gen, device=dev)
    n[torch.rand(P, generator=gen, device=dev) < 0.1] = 0
    rows[torch.arange(k, device=dev)[None, :] >= n[:, None]] = float("-inf")
    if order == "descending":
        rows = rows[torch.sort(-rows[:, 0], stable=True).indices]
    return rows.contiguous()


# P at the edges of the boundary scan's tiles on an H100 (132 SMs): tiles
# of 2,048 rows up to P = 540,672 (P = 2047-2049 are in SINGLE_SIZES), of
# 4,096 at P = 2**20 (256 tiles), each edge and one row either side
SCAN_EDGE_SIZES = (4095, 4096, 4097, (1 << 20) - 1, (1 << 20) + 1)


def topk_scan_cases(rng, dev, sizes) -> dict:
    """``topk_boundary``: k in {1, 8} at every P and 64 up to 2**20, the
    largest k the kernel takes at the small P; k in {1, 8, 25} at the
    tiles' edges (``SCAN_EDGE_SIZES``); random and descending row orders,
    ascending (every row merges) up to P = 2049; ties, all -inf rows; no
    upfront boundary and one at the median head."""
    import torch

    from repro_torch.kernels.ref import topk_boundary_ref
    from repro_torch.kernels.topk_boundary import MAX_K_SCAN, topk_boundary

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2 ** 31)))
    cases, max_p = 0, 0
    grid = []
    for P in sizes:
        ks = (1, 8) + ((64,) if P <= 1 << 20 else ()) + \
            ((MAX_K_SCAN,) if P <= 7 else ())
        for k in ks:
            for order in ("random", "descending") + \
                    (("ascending",) if P <= 2049 and k <= 64 else ()):
                grid.append((P, k, order))
    grid.append((40, MAX_K_SCAN, "random"))
    grid += [(P, k, order) for P in SCAN_EDGE_SIZES for k in (1, 8, 25)
             for order in ("random", "descending")]
    for P, k, order in grid:
        lo, hi = (-20, 20) if (P + k) % 2 else (-100_000, 100_000)
        rows = topk_rows(gen, dev, P, k, order, lo, hi)
        for b_init in (float("-inf"), float(rows[P // 2, 0])):
            skip, heap = topk_boundary(rows, b_init)
            sync(dev)
            want_skip, want_heap = topk_boundary_ref(rows, b_init)
            where = f"P={P} k={k} order={order} b_init={b_init}"
            require_equal("topk_boundary", skip, want_skip, where)
            require_equal("topk_boundary", heap, want_heap, where)
            if order == "ascending" and b_init == float("-inf") \
                    and bool(skip.any()):
                raise SystemExit(f"topk_boundary skipped a rising row at "
                                 f"{where}")
            cases += 1
        max_p = max(max_p, P)
        del rows
    return dict(cases=cases, max_abs_err=0.0, max_p=max_p)


def require_close(name: str, got, want, tol: float, where: str) -> float:
    """Largest |got - want|; raises unless every element is within
    ``tol + tol * |want|`` (rtol = atol = tol)."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise SystemExit(f"{name}: shape {tuple(g.shape)} != "
                         f"{tuple(w.shape)} at {where}")
    d = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((d > tol + tol * w.abs())
                                                  .any()):
        raise SystemExit(f"{name} kernel != plain version at {where}: max "
                         f"abs err {float(d.max())} (tolerance {tol})")
    return float(d.max()) if d.numel() else 0.0


# flash_attention: the JAX package's bounds, rtol and atol
# (tests/test_flash_attention.py): the f32 sums run in another order
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def flash_cases(rng, dev, sizes) -> dict:
    """``flash_attention``, f32 and bf16, every head dim D in ``sizes``:
    BH = 3 at Sq = Sk in {1, 7, 128, 130, 256}, with and without causal;
    Sk != Sq without it (1 x 2048, 7 x 130, 130 x 7, 256 x 1, 128 x 256,
    2048 x 130) and with it (130 x 300, 300 x 130); BH = 1 at Sq = Sk =
    2048 causal; BH = 128 at 2048 causal for D in {128, 256}, the serving
    prefill's shape; for D in {64, 80} Whisper's non-causal 1,500 x 1,500
    encoder and 64 x 1,500 cross-attention; and q, k, v that are views at
    an odd element offset
    (a data_ptr off 16 bytes) at 130 x 130 causal and 7 x 200."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2 ** 31)))
    grid = []
    for D in sizes:
        grid += [(3, S, S, c, D, False) for S in (1, 7, 128, 130, 256)
                 for c in (True, False)]
        grid += [(3, sq, sk, False, D, False) for sq, sk in (
            (1, 2048), (7, 130), (130, 7), (256, 1), (128, 256), (2048, 130))]
        grid += [(3, sq, sk, True, D, False) for sq, sk in ((130, 300),
                                                             (300, 130))]
        grid.append((1, 2048, 2048, True, D, False))
        if D in (128, 256):
            grid.append((128, 2048, 2048, True, D, False))
        if D in (64, 80):       # Whisper's encoder and cross-attention
            grid += [(3, 1500, 1500, False, D, False),
                     (3, 64, 1500, False, D, False)]
        grid += [(2, 130, 130, True, D, True), (2, 7, 200, False, D, True)]
    cases, err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        for BH, Sq, Sk, causal, D, odd in grid:
            shapes = [(BH, S, D) for S in (Sq, Sk, Sk)]
            if odd:     # views one element into their buffers
                q, k, v = (torch.randn(math.prod(sh) + 1, generator=gen,
                                       device=dev).to(dtype)[1:].view(sh)
                           for sh in shapes)
                assert q.data_ptr() % 16
            else:
                q, k, v = (torch.randn(sh, generator=gen, device=dev)
                           .to(dtype) for sh in shapes)
            got = flash_attention(q, k, v, causal=causal)
            sync(dev)
            want = flash_attention_ref(q, k, v, causal=causal)
            err = max(err, require_close(
                "flash_attention", got, want, tol,
                f"BH={BH} Sq={Sq} Sk={Sk} D={D} causal={causal} {dtype}"
                f"{' at an odd offset' if odd else ''}"))
            cases += 1
            del q, k, v, got, want
    return dict(cases=cases, max_abs_err=err, max_p=max(sizes))


def phase_kernel_vs_plain(seed: int, dev, names=tuple(KERNELS)) -> dict:
    """Phase 2 for the kernels in ``names`` (all eight unless a rehearsal
    picks some), in the order of ``KERNELS``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, fn, sizes in (
            ("minmax_prune_batched", minmax_cases, (1, 31, 4097, 1 << 20)),
            ("join_overlap_batched", join_cases, (1, 31, 4097, 1 << 21)),
            ("bloom_probe_batched", bloom_cases, (1, 4097, 1 << 21)),
            ("topk_init_batched", topk_cases, (1, 4097, 1 << 21)),
            ("minmax_prune", minmax_single_cases, SINGLE_SIZES),
            ("join_overlap", join_single_cases, SINGLE_SIZES),
            ("topk_boundary", topk_scan_cases, SINGLE_SIZES),
            ("flash_attention", flash_cases,
             (8, 16, 32, 64, 72, 80, 100, 128, 200, 256))):
        if name not in names:
            continue
        t0 = time.perf_counter()
        out[name] = fn(rng, dev, sizes)
        out[name]["s"] = time.perf_counter() - t0
    return out


KERNEL_VS_PLAIN_TIMEOUT_S = 600    # the build and phase 2: minutes


def kernel_vs_plain_child(seed: int, out: str) -> None:
    """The kernels' build and phase 2 in a process of their own (spawned
    by ``main``): each kernel against its plain version on the card, the
    numbers written to ``out`` as JSON.  They need the card
    and not phase 3's tables, so they run beside the tables' build and
    the host references, which need the host alone."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.load_kernels()
    build_s = time.perf_counter() - t0
    kv = phase_kernel_vs_plain(seed, torch.device("cuda"))
    Path(out).write_text(json.dumps(dict(build_s=build_s, kv=kv)))


# ---------------------------------------------------------------------------
# Phase 14: the JOIN build summary on the card
# ---------------------------------------------------------------------------
# ``bloom_build`` replaces no TPU kernel: the JAX package summarises the
# build side on the host.  Its gate holds the card's ``BuildSummary`` to
# the plain version's and to numpy's ``summarize_build``, field for field
# (the Bloom words bit for bit): the benchmark's answers cannot see a
# wrong word where no probe partition is narrow enough to enumerate.

SUMMARY_Q3_KEYS = 250_000     # a TPC-H Q3 build side (orders before a day)
SUMMARY_NDV_LIMIT = 4096      # PruningPipeline's join_ndv_limit
SUMMARY_SIZES = (1024, 2048, 3072, 4096, 6144, 8192, 16384, 65536, 250_000)


def summary_problems(got, want) -> list:
    """The fields in which two ``BuildSummary``s differ."""
    bad = [f for f in ("min", "max", "count", "size_bytes")
           if getattr(got, f) != getattr(want, f)]
    for f in ("distinct", "bloom"):
        if (getattr(got, f) is None) != (getattr(want, f) is None):
            bad.append(f)
    if got.distinct is not None and want.distinct is not None and (
            got.distinct.dtype != want.distinct.dtype
            or not np.array_equal(got.distinct, want.distinct)):
        bad.append("distinct")
    if got.bloom is not None and want.bloom is not None and (
            got.bloom.n_blocks != want.bloom.n_blocks
            or not np.array_equal(got.bloom.words, want.bloom.words)):
        bad.append("bloom.words")
    return bad


def q3_keys(rng, n: int = SUMMARY_Q3_KEYS) -> np.ndarray:
    """n distinct sparse order keys in 1..6e9, in no order (SF1000's)."""
    keys = np.unique(rng.integers(1, 6_000_000_001, int(n * 1.01)))
    return rng.permutation(keys)[:n].astype(np.int64)


def summary_cases(rng) -> dict:
    """The key sets the CPU tests hold the plain version to, as (keys,
    null mask or None)."""
    lim = SUMMARY_NDV_LIMIT
    ext = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0,
                    1], dtype=np.int64)
    return {
        "empty": (np.zeros(0, dtype=np.int64), None),
        "all_null": (rng.integers(0, 100, 500).astype(np.int64),
                     np.ones(500, dtype=bool)),
        "ndv_at_limit": (rng.permutation(np.repeat(
            rng.choice(10 ** 9, lim, replace=False), 3)), None),
        "ndv_over_limit": (rng.permutation(np.repeat(
            rng.choice(10 ** 9, lim + 1, replace=False), 3)), None),
        "duplicates": (rng.integers(0, 3000, 100_000).astype(np.int64),
                       None),
        "sparse": (rng.integers(1, 6_000_000_001, 50_000), None),
        "extreme_distinct": (np.tile(ext, 40), None),
        "extreme_bloom": (np.concatenate(
            [ext, -rng.integers(1, 2 ** 62, 20_000)]), None),
        "int32": (rng.integers(-2 ** 31, 2 ** 31 - 1, 30_000
                               ).astype(np.int32), None),
        "q3": (q3_keys(rng), None),
        # as a table holds an integer column: float64 (the benchmark's Q3)
        "q3_encoded": (q3_keys(rng).astype(np.float64), None),
        "duplicates_encoded": (rng.integers(0, 3000, 100_000).astype(
            np.float64), None),
    }


def phase_join_summary(seed: int, card: str, dev) -> dict:
    """Phase 14: ``bloom_build`` against its plain version and numpy's
    ``summarize_build`` on every case and on three Q3-sized build sides
    (a hard gate), its time beside its byte bound, and the crossover of
    the service's card path against the host summary."""
    import torch

    from repro_torch.core.prune_join import summarize_build
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_build import bloom_build, plan_builds
    from repro_torch.serve.prune_service import PruningService

    lim = SUMMARY_NDV_LIMIT
    rng = np.random.default_rng(seed + 14)
    cases = summary_cases(rng)
    for s in range(3):
        cases[f"q3_seed{s}"] = (q3_keys(np.random.default_rng(seed + s)
                                        ).astype(np.float64), None)
    sides = [k if m is None else k[~m] for k, m in cases.values()]
    launches = bloom_build.launches
    got = ops.summarize_build_batched_device(sides, lim, device=dev)
    alone = [ops.summarize_build_batched_device([k], lim, device=dev)[0]
             for k in sides]
    sync(dev)
    plain = ops.summarize_build_batched_device(sides, lim, device="cpu")
    for name, (keys, mask), g, a, p in zip(cases, cases.values(), got, alone,
                                           plain):
        want = summarize_build(keys, mask, ndv_limit=lim)
        for what, have in (("batched", g), ("alone", a), ("plain", p)):
            bad = summary_problems(have, want)
            if bad:
                raise SystemExit(f"join summary {name}: the {what} "
                                 f"summary differs from numpy's in {bad}")
    n_launched = bloom_build.launches - launches
    if n_launched != 1 + sum(1 for k in sides if k.size):
        raise SystemExit(f"join summary: {n_launched} bloom_build launches")
    log(f"[summary] {card}: bloom_build == plain version == numpy "
        f"summarize_build on {len(cases)} cases, batched and alone, "
        f"{n_launched} launches")

    # the kernels alone at one Q3 (CUDA events, L2 flushed): the data
    # needs the keys read once and the words written once
    keys = cases["q3_seed0"][0].astype(np.int64)
    plan = plan_builds([keys.size], lim, 16)
    staged = torch.from_numpy(np.concatenate([plan.reshape(-1), keys])).to(
        dev)
    ms = cuda_ms(lambda: bloom_build(staged, plan, lim, 16), 20)
    words = int(got[list(cases).index("q3_seed0")].bloom.words.nbytes)
    bound_ms, bound_by = bound(keys.nbytes + words, 0)
    plain_ms = host_ms(lambda: bloom_build(staged.cpu(), plan, lim, 16),
                       torch.device("cpu"))
    numpy_ms = statistics.median(
        host_ms(lambda: summarize_build(keys, ndv_limit=lim),
                torch.device("cpu")) for _ in range(5))
    log(f"[summary] {card}: bloom_build at {keys.size:,} keys "
        f"({keys.nbytes:,} bytes in, {words:,} bytes of words out): "
        f"{ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), plain "
        f"version {plain_ms:.1f} ms, numpy summarize_build {numpy_ms:.2f} "
        f"ms")

    # the crossover: the service's card path (staging, launch, two reads
    # back, the BuildSummary) against numpy, one build side a call and a
    # Q3 batch's 6 at 250,000 keys, float64 as a table holds them
    svc = PruningService(device=dev, verdict_cache=False)
    sweep = []
    for n in SUMMARY_SIZES:
        k = q3_keys(rng, n).astype(np.float64)
        card_path = lambda k=k: svc.join_summary_batch([k], lim)
        card_path()
        card_ms = statistics.median(host_ms(card_path, dev)
                                    for _ in range(15))
        host_path = lambda k=k: summarize_build(k, ndv_limit=lim)
        cpu_ms = statistics.median(host_ms(host_path, dev)
                                   for _ in range(15))
        sweep.append(dict(n=n, card_ms=card_ms, host_ms=cpu_ms))
        log(f"[summary] {card}: {n:>7,} keys: card path {card_ms:.3f} ms, "
            f"host summarize_build {cpu_ms:.3f} ms")
    six = [q3_keys(rng).astype(np.float64) for _ in range(6)]
    svc.join_summary_batch(six, lim)
    batch_ms = statistics.median(
        host_ms(lambda: svc.join_summary_batch(six, lim), dev)
        for _ in range(9))
    log(f"[summary] {card}: six Q3 build sides in one call: "
        f"{batch_ms:.3f} ms ({batch_ms / 6:.3f} ms a Q3)")
    if svc.counters.join_summary["host"]:
        raise SystemExit(f"join summary: the ladder sent build sides to "
                         f"the host: {svc.counters.join_summary}")
    return dict(cases=len(cases), launches=n_launched, ms=ms,
                bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
                numpy_ms=numpy_ms, sweep=sweep, six_q3_ms=batch_ms)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
# The traffic is a copy of the reference benchmark's production mix
# (benchmarks/workload.py: sample_filter_pred, small_table,
# sample_limit_query, sample_topk_query, sample_join_query) written against
# the port's own modules.

def sample_filter_pred(rng, E):
    u = rng.random()
    ts_max = 10_000_000
    if u < 0.28:
        # recent-data scan: selectivity lognormal around ~1%
        frac = float(np.exp(rng.normal(np.log(0.01), 1.4)))
        frac = min(frac, 1.0)
        return E.col("ts") >= ts_max * (1 - frac)
    if u < 0.42:
        # time window + categorical
        frac = float(np.exp(rng.normal(np.log(0.03), 1.0)))
        lo = ts_max * (1 - min(frac, 1.0))
        grp = rng.choice(["ok", "warn", "err", "crit"])
        return (E.col("ts") >= lo) & E.startswith(E.col("status"), str(grp))
    if u < 0.75:
        # categorical only
        grp = rng.choice(["ok", "warn", "err", "crit"])
        return E.like(E.col("status"), f"{grp}-%")
    # unselective predicate (prunes nothing)
    return E.col("score") >= float(rng.uniform(0.0, 0.2))


def sample_limit_query(rng, events, users, m):
    E = m.E
    with_pred = rng.random() < (2.23 / 2.60)
    if rng.random() < 0.72:
        # dashboard-style LIMIT over the small dimension table
        pred = (E.col("age") >= int(rng.integers(20, 60))) if with_pred \
            else E.true()
        scans = {"events": m.TableScanSpec(users, pred)}
    else:
        pred = sample_filter_pred(rng, E) if with_pred else E.true()
        scans = {"events": m.TableScanSpec(events, pred)}
    return m.Query(scans=scans, limit=m.sample_limit_k(rng),
                   offset=int(rng.integers(0, 10)) if rng.random() < 0.1
                   else 0)


def sample_topk_query(rng, events, m, desc: bool):
    """ORDER BY num_sightings LIMIT k, k from the Fig. 6 distribution
    (positive, capped at 200), half of them with a predicate."""
    k = 0
    while k <= 0:
        k = m.sample_limit_k(rng)
    pred = sample_filter_pred(rng, m.E) if rng.random() < 0.5 \
        else m.E.true()
    return m.Query(scans={"events": m.TableScanSpec(events, pred)},
                   limit=int(min(k, 200)),
                   order_by=("events", "num_sightings", desc))


def sample_join_query(rng, events, build, m, order_by: bool):
    """events JOIN users ON user_id = id with a selective build-side
    predicate on the correlated age; with ``order_by`` also ORDER BY
    events.num_sightings LIMIT 10 (Fig. 7b)."""
    E = m.E
    age_lo = int(rng.integers(65, 85))
    q = m.Query(
        scans={"users": m.TableScanSpec(build, E.col("age") >= age_lo),
               "events": m.TableScanSpec(
                   events, sample_filter_pred(rng, E)
                   if rng.random() < 0.5 else E.true())},
        join=m.JoinSpec("users", "events", "id", "user_id"))
    if order_by:
        q.limit, q.order_by = 10, ("events", "num_sightings", True)
    return q


def topk_equal(a, b) -> bool:
    if (a.topk is None) != (b.topk is None):
        return False
    if a.topk is None:
        return True
    return (np.array_equal(a.topk.values, b.topk.values)
            and np.array_equal(a.topk.scanned, b.topk.scanned)
            and np.array_equal(a.topk.skipped, b.topk.skipped)
            and a.topk_scan == b.topk_scan)


def scan_sets_equal(a, b) -> bool:
    if a.scan_sets.keys() != b.scan_sets.keys():
        return False
    return all(np.array_equal(a.scan_sets[n].part_ids, b.scan_sets[n].part_ids)
               and np.array_equal(a.scan_sets[n].match, b.scan_sets[n].match)
               for n in a.scan_sets)


def reports_equal(a, b) -> bool:
    """Bit-identical reports: scan sets, every technique report, top-k."""
    if not scan_sets_equal(a, b):
        return False
    for name in a.scan_sets:
        if a.per_scan[name].keys() != b.per_scan[name].keys():
            return False
        for tech in a.per_scan[name]:
            ra, rb = a.per_scan[name][tech], b.per_scan[name][tech]
            if (ra.before, ra.after, ra.applied, ra.detail) != \
                    (rb.before, rb.after, rb.applied, rb.detail):
                return False
    return topk_equal(a, b)


def host_equal(dev_rep, host_rep) -> bool:
    """The device pipeline against the f64 host pipeline: the same scan
    sets and technique reports (but for the execution path and the top-k
    boundary, which the device init strengthens), the same top-k values,
    and every partition the host skips skipped too."""
    def strip(detail):
        return {k: v for k, v in detail.items() if k != "path"}

    if not scan_sets_equal(dev_rep, host_rep):
        return False
    for name in host_rep.scan_sets:
        if dev_rep.per_scan[name].keys() != host_rep.per_scan[name].keys():
            return False
        for tech, rh in host_rep.per_scan[name].items():
            if tech == "topk":
                continue
            rd = dev_rep.per_scan[name][tech]
            if (rd.before, rd.after, rd.applied, strip(rd.detail)) != \
                    (rh.before, rh.after, rh.applied, strip(rh.detail)):
                return False
    if (dev_rep.topk is None) != (host_rep.topk is None):
        return False
    if host_rep.topk is None:
        return True
    return (np.array_equal(dev_rep.topk.values, host_rep.topk.values)
            and np.isin(host_rep.topk.skipped, dev_rep.topk.skipped).all())


def keeps_superset(dev_rep, host_rep) -> bool:
    return all(np.isin(host_rep.scan_sets[n].part_ids,
                       dev_rep.scan_sets[n].part_ids).all()
               for n in host_rep.scan_sets)


def integral_only(q) -> bool:
    for spec in q.scans.values():
        for c in spec.pred.columns():
            if spec.table.columns[c].kind == "float":
                return False
    return True


def bloom_work(words, pmin, width, P: int):
    """What one Bloom launch's data needs: (candidates hashed, candidate x
    query tests).  A (query, partition) pair tests candidates up to its
    first hit, or all ``width`` of them; a candidate is hashed once for
    all the queries that need it.  The candidates and their probes are
    the plain version's own (``ref.bloom_slabs``)."""
    import torch
    from repro_torch.kernels import ref
    none = 1 << 40
    hashed = tested = 0
    for s, e, w, seg, j, passes in ref.bloom_slabs(words, pmin, width, P):
        need = torch.zeros(e - s, dtype=torch.int64, device=w.device)
        for q in range(int(words.shape[0])):
            first = torch.full((e - s,), none, dtype=torch.int64,
                               device=w.device)
            first.scatter_reduce_(0, seg, torch.where(passes(q), j, none),
                                  reduce="amin")
            n_q = torch.minimum(first + 1, w)
            tested += int(n_q.sum().item())
            need = torch.maximum(need, n_q)
        hashed += int(need.sum().item())
    return hashed, tested


def minmax_need(lo, hi, mins, maxs, nullable):
    """What one ``minmax_prune`` launch's data needs: (bytes, operations).
    AND is a min and NO is its floor, so constraint i's min and max are
    needed only for the partitions no earlier constraint has made NO, and
    its nullable flag only where the verdict can still be FULL (2 so far,
    and the partition's interval inside [lo, hi]).  Loads are counted in
    32-byte sectors, the least the card moves; the bounds and the [P]
    int32 verdicts are added whole."""
    import torch
    K, P = mins.shape
    v = torch.full((P,), 2, dtype=torch.int32, device=mins.device)

    def sectors(i, need):
        idx = (i * P + torch.nonzero(need).flatten()) // 8
        return 32 * (int(idx.numel() > 0)
                     + int((idx[1:] != idx[:-1]).sum().item()))

    nbytes, nops = 8 * K + 4 * P, 0
    for i in range(K):
        live = v > 0
        if not bool(live.any()):
            break
        pmin, pmax = mins[i], maxs[i]
        empty = pmin > pmax
        no = (pmax < lo[i]) | (pmin > hi[i]) | empty
        inside = (pmin >= lo[i]) & (pmax <= hi[i]) & ~empty
        nbytes += 2 * sectors(i, live) + sectors(i, live & (v == 2) & inside)
        nops += 10 * int(live.sum().item())
        t = torch.where(no, 0, torch.where(inside & (nullable[i] == 0), 2, 1))
        v = torch.where(live, torch.minimum(v, t.to(torch.int32)), v)
    return nbytes, nops


def main_path_traffic(seed: int, card: str, n_rows: int = 2 ** 24):
    """Phase 3's tables and batch: (the batch of 256 queries in its
    shuffled order, the tables and query lists phase 4 reuses)."""
    import types

    from repro_torch.core import expr as E
    from repro_torch.core.flow import JoinSpec, Query, TableScanSpec
    from repro_torch.data.generator import (make_events_table,
                                            make_users_table, sample_limit_k)
    from repro_torch.data.table import Table

    m = types.SimpleNamespace(E=E, Query=Query, TableScanSpec=TableScanSpec,
                              JoinSpec=JoinSpec, sample_limit_k=sample_limit_k)
    t0 = time.perf_counter()
    # user_clustering 0.99999 keeps every partition's user_id range narrow
    # enough to enumerate against a Bloom filter (width <= 1024)
    events = make_events_table(np.random.default_rng(seed), n_rows=n_rows,
                               rows_per_partition=16, ts_clustering=0.995,
                               user_clustering=0.99999)
    users = make_users_table(np.random.default_rng(seed + 99), n_rows=600,
                             rows_per_partition=750)
    u20k = make_users_table(np.random.default_rng(seed + 99))
    build = Table.from_arrays("users_20k", u20k.columns, u20k.data,
                              u20k.nulls, u20k.part_bounds)
    log(f"[main] {card} host: tables built in {time.perf_counter() - t0:.1f} s: events "
        f"P={events.num_partitions} C={len(events.columns)}, users "
        f"P={users.num_partitions}, {build.name} P={build.num_partitions}")

    rng = np.random.default_rng(seed)
    queries = [Query(scans={"events": TableScanSpec(
        events, sample_filter_pred(rng, E))}) for _ in range(128)]
    queries += [sample_limit_query(rng, events, users, m) for _ in range(48)]
    queries += [sample_topk_query(rng, events, m, desc=i % 4 != 0)
                for i in range(48)]
    queries += [sample_join_query(rng, events, build, m, order_by=i < 8)
                for i in range(32)]
    # the per-query path (phase 4) takes the filter, top-k and join queries
    ctx = dict(events=events, build=build, filter_queries=queries[:128],
               limit_queries=queries[128:176],
               topk_queries=queries[176:224], join_queries=queries[224:])
    return [queries[i] for i in rng.permutation(len(queries))], ctx


def main_path_references(queries) -> dict:
    """Phase 3's references, on the host alone: the same service on the
    CPU (the plain versions) over the whole batch, and the f64 host
    pipeline over every query but the Bloom joins.  The host matcher
    expands every narrow partition of a Bloom join to a dense [n, 1024]
    candidate array (GBs a query at this P): Bloom joins are held to the
    CPU run only.  ``main`` runs this beside the kernels' build and phase
    2, which run in a process of their own and need the card alone."""
    from repro_torch.core.flow import PruningPipeline
    from repro_torch.serve.prune_service import PruningService

    t0 = time.perf_counter()
    cpu_reports = PruningService(device="cpu",
                                 verdict_cache=False).run_batch(queries)
    t_cpu = time.perf_counter() - t0
    bloom_q = [i for i, r in enumerate(cpu_reports)
               if "join" in r.per_scan.get("events", {})
               and r.per_scan["events"]["join"].detail["summary_kind"]
               == "bloom"]
    host_idx = [i for i in range(len(queries)) if i not in set(bloom_q)]
    host = PruningPipeline(filter_mode="host")
    t0 = time.perf_counter()
    host_reports = {i: host.run(queries[i]) for i in host_idx}
    return dict(cpu_reports=cpu_reports, t_cpu=t_cpu, bloom_q=bloom_q,
                host_idx=host_idx, host_reports=host_reports,
                t_host=time.perf_counter() - t0)


def phase_main_path(seed: int, n_batches: int, card: str, dev,
                    n_rows: int = 2 ** 24, traffic=None, refs=None):
    """Phase 3; returns (the tables, query lists and service that phase 4
    reuses, the phase's numbers).  ``traffic`` is ``main_path_traffic``'s
    result and ``refs`` ``main_path_references``' where the caller made
    them ahead (None: made here)."""
    from repro_torch.core import expr as E
    from repro_torch.core.device_stats import plane_checksum
    from repro_torch.core.prune_filter import extract_ranges
    from repro_torch.kernels import ops
    from repro_torch.serve.prune_service import PruningService

    queries, ctx = traffic or main_path_traffic(seed, card, n_rows)
    events = ctx["events"]
    n_join_topk = sum(1 for q in queries if q.is_topk and q.join is not None)

    # table groups with lowered predicates: one filter launch each per batch
    groups = {}
    non_lowering = 0
    for q in queries:
        for spec in q.scans.values():
            if isinstance(spec.pred, E.TruePred):
                continue
            ranges = extract_ranges(spec.pred, spec.table.stats)
            if ranges is None:
                non_lowering += 1
            else:
                groups.setdefault(spec.table.name, []).append(ranges)
    log(f"[main] {len(queries)} queries, filter table groups "
        f"{ {k: len(v) for k, v in groups.items()} }, non-lowering "
        f"predicates {non_lowering}, join + ORDER BY {n_join_topk}")

    ahead = refs is not None
    r = refs if ahead else main_path_references(queries)
    cpu_reports, t_cpu, bloom_q = r["cpu_reports"], r["t_cpu"], r["bloom_q"]
    host_idx, host_reports = r["host_idx"], r["host_reports"]
    t_host = r["t_host"]
    cpu_tech = cpu_reports[0].counters["technique"]
    log(f"[main] {card} host: references: CPU plain service {t_cpu:.2f} s, f64 host "
        f"pipeline {t_host:.2f} s over {len(host_idx)} queries"
        f"{' (beside the build and phase 2)' if ahead else ''}; "
        f"CPU technique counters {cpu_tech}; Bloom joins {len(bloom_q)}")
    exact_host = {i: integral_only(queries[i]) for i in host_idx}
    for tech, want in (("filter", len(groups)), ("join", 1),
                       ("join_bloom", 1)):
        got = cpu_tech.get(tech, {}).get("launches", 0)
        if got != want:
            raise SystemExit(f"traffic: {got} {tech} launches, expected "
                             f"{want} table groups")
    if not 1 <= cpu_tech.get("topk", {}).get("launches", 0) <= 2:
        raise SystemExit(f"traffic: top-k launches {cpu_tech.get('topk')}")

    kernel_of = {t: getattr(ops, n) for t, n in MAIN_KERNELS.items()}
    # the verdict cache off: every batch launches each table group's
    # kernels (a repeated batch would otherwise be served from verdicts)
    svc = PruningService(device=dev, verdict_cache=False)
    for fn in kernel_of.values():
        fn.launches = 0                     # the main path's count from here
    times = []
    last = None
    for b in range(n_batches + 1):
        before = {t: fn.launches for t, fn in kernel_of.items()}
        sync(dev)
        t0 = time.perf_counter()
        reports = svc.run_batch(queries)
        sync(dev)
        dt = time.perf_counter() - t0
        if b:
            times.append(dt)
        c = reports[0].counters
        res, tech = c["resilience"], c["technique"]
        launched = {t: fn.launches - before[t] for t, fn in kernel_of.items()}
        problems = []
        if any(res["demotions"].values()):
            problems.append(f"demotions {res['demotions']}")
        if res["salvaged_batches"] or res["passthroughs"] or res["errors"]:
            problems.append(f"resilience {res}")
        if tech != cpu_tech:
            problems.append(f"technique counters {tech} != CPU {cpu_tech}")
        for t, n in launched.items():
            if n != tech.get(t, {}).get("launches", 0) or not n:
                problems.append(f"{n} {t} kernel launches, technique "
                                f"counters {tech.get(t)}")
        if tech["topk"]["fallbacks"] != n_join_topk:
            problems.append(f"top-k fallbacks {tech['topk']} for "
                            f"{n_join_topk} join + ORDER BY queries")
        if tech["join"]["fallbacks"] or tech["join_bloom"]["fallbacks"]:
            problems.append(f"join fallbacks {tech}")
        for i, (r, rc) in enumerate(zip(reports, cpu_reports)):
            if not reports_equal(r, rc):
                problems.append(f"query {i}: differs from the CPU run")
            rh = host_reports.get(i)
            if rh is None:
                continue
            if exact_host[i] and not host_equal(r, rh):
                problems.append(f"query {i}: differs from the host pipeline")
            if not keeps_superset(r, rh):
                problems.append(f"query {i}: drops a partition the host "
                                f"pipeline keeps")
        if problems:
            raise SystemExit(f"batch {b}: " + "; ".join(problems[:10]))
        log(f"[main] {card}: batch {b}{' (warm-up)' if b == 0 else ''}: "
            f"{dt * 1e3:.2f} ms, launches {launched}, technique {tech}, "
            f"checks passed")
        last = reports
    main_launches = {t: fn.launches for t, fn in kernel_of.items()}
    med = statistics.median(times)
    kept = sum(len(ss) for r in last for ss in r.scan_sets.values())
    touched = sum(s.table.num_partitions for q in queries
                  for s in q.scans.values())
    log(f"[main] {card}: median batch {med * 1e3:.3f} ms over "
        f"{len(times)} batches ({[round(t * 1e3, 3) for t in times]}), "
        f"{len(queries) / med:.1f} queries/s; partitions kept "
        f"{kept} of {touched} ({1 - kept / touched:.4%} pruned); "
        f"{sum(exact_host.values())} of {len(queries)} queries held "
        f"bit-exact to the host pipeline")

    split, kern = stage_split(svc, queries, events, card, dev)
    for t, k in kern.items():
        k["launches"] = main_launches[t]
    t0 = time.perf_counter()
    dstats = svc.cache.get(events)
    if plane_checksum(dstats.planes) != dstats.checksum:
        raise SystemExit("resident events plane fails its checksum")
    split["integrity_verify_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"[split] {card}: resident plane bytes {svc.cache.resident_bytes}; "
        f"integrity {svc.cache.integrity_snapshot()}")
    ctx["svc"] = svc
    ctx["queries"], ctx["reports"] = queries, last
    return ctx, dict(
        queries=len(queries), groups={k: len(v) for k, v in groups.items()},
        non_lowering=non_lowering, join_topk=n_join_topk,
        bloom_queries=len(bloom_q), batch_ms=[t * 1e3 for t in times],
        median_batch_ms=med * 1e3, queries_per_s=len(queries) / med,
        partitions_kept=kept, partitions_touched=touched,
        exact_host_queries=sum(exact_host.values()), cpu_ref_s=t_cpu,
        host_ref_s=t_host, split_ms=split, kernels=kern,
        resident_bytes=svc.cache.resident_bytes)


def stage_split(svc, queries, events, card, dev):
    """One batch's stages run one after another with the kernels' inputs
    recorded: each stage's wall time, and for each kernel its H2D copy,
    device time (cold L2), D2H copy, plain-version time and library-call
    time at the main path's shapes, and its bound from these inputs."""
    import torch

    from repro_torch.core.flow import PruningPipeline
    from repro_torch.kernels import ops, ref, topk_boundary

    seen = {t: [] for t in MAIN_KERNELS}
    real = {t: getattr(ops, n) for t, n in MAIN_KERNELS.items()}

    def recorder(tech):
        def rec(*a, **kw):
            out = real[tech](*a, **kw)
            seen[tech].append((a, kw, out))
            return out
        return rec

    pipe = PruningPipeline(filter_mode="device", service=svc)
    states = [pipe.make_state(q) for q in queries]
    stage_ms = {}
    for t, n in MAIN_KERNELS.items():
        setattr(ops, n, recorder(t))
    try:
        for tech in pipe.techniques:
            sync(dev)
            t0 = time.perf_counter()
            tech.run_batch(pipe, states, service=svc)
            sync(dev)
            stage_ms[tech.name] = (time.perf_counter() - t0) * 1e3
    finally:
        for t, fn in real.items():
            setattr(ops, MAIN_KERNELS[t], fn)

    def h2d(tensors):
        host = [t.cpu() for t in tensors]
        return host_ms(lambda: [h.to(dev) for h in host], dev)

    split = {"stage_ms": stage_ms}
    kern = {}
    for tech, calls in seen.items():
        if not calls:
            raise SystemExit(f"the split batch launched no {tech} kernel")
        parts = dict(launches=len(calls), h2d_ms=0.0, kernel_ms=0.0,
                     d2h_ms=0.0)
        best = None
        for a, kw, out in calls:
            fn = timed = real[tech]
            work = None
            if tech == "filter":
                queries_in = a[:3]
                planes, P = a[3:6], kw["num_partitions"]
                cols = len({int(c) for c in a[0].flatten().tolist()})
                Q, Kb = a[1].shape
                nbytes = 3 * 4 * cols * P + Q * P + Q * Kb * 12
                ops_n = 10 * Q * Kb * P
                plain = lambda a=a, kw=kw: ref.minmax_prune_batched_ref(*a, **kw)
                library = None
            elif tech == "join":
                queries_in = a[:1]
                dist, pmin, pmax = a
                P = kw["num_partitions"]
                Q, Db = dist.shape
                nbytes = 8 * P + Q * P + 4 * Q * Db
                ops_n = Q * P * (int(math.log2(Db)) + 2)
                plain = lambda a=a, kw=kw: ref.join_overlap_batched_ref(*a, **kw)
                work = ref.window_paths(*ref.join_windows(
                    dist, pmin, pmax, ref.JOIN_TILE_BATCHED, P))
                lo_e = pmin[:P].expand(Q, P).contiguous()
                hi_e = pmax[:P].expand(Q, P).contiguous()
                library = lambda d=dist, lo=lo_e, hi=hi_e: (
                    torch.searchsorted(d, hi, right=True)
                    > torch.searchsorted(d, lo))
            elif tech == "join_bloom":
                queries_in = a[:1]
                words, pmin, width = a
                P = kw["num_partitions"]
                Q, W = words.shape
                hashed, tested = bloom_work(words, pmin, width, P)
                nbytes = 8 * P + Q * P + 4 * Q * W
                # a candidate: 3 mixes (8 ops each) and its add, then, in
                # a bit-sliced table, 4 probes (the word's and the bit's
                # shift-mask, the address, the load, the AND) that serve
                # 32 queries at once
                ops_n = (25 + 20 * -(-Q // 32)) * hashed
                # the count the first port was held to: 28 ops a
                # (candidate, query) test, each query probed on its own
                test_ops = 25 * hashed + 28 * tested
                work = dict(hashed=hashed, tested=tested)
                plain = lambda a=a, kw=kw: ref.bloom_probe_batched_ref(*a, **kw)
                library = None
            else:
                queries_in = a[1:3]
                plane, offsets, ids, k = a
                Q = int(offsets.numel()) - 1
                nnz = int(ids.numel())
                nbytes = 8 * nnz + 8 * (Q + 1) + 4 * Q * k
                # a gathered head really moves a 32-byte sector
                sector_bytes = 36 * nnz + 8 * (Q + 1) + 4 * Q * k
                ops_n = nnz
                plain = lambda a=a: ref.topk_init_batched_ref(*a)
                library = topk_library(plane, offsets, ids, k)
                # the launch alone: the wrapper's candidate check (three
                # reductions and a wait for them) is not the kernel's
                timed = topk_boundary.launch_checked
            err = require_equal(tech, fn(*a, **kw), plain(), "the main path")
            t_k = cuda_ms(lambda: timed(*a, **kw), 10)
            parts["kernel_ms"] += t_k
            parts["h2d_ms"] += h2d(queries_in)
            parts["d2h_ms"] += host_ms(lambda: out.cpu(), dev)
            if best is None or t_k > best["ms"]:
                bms, bby = bound(nbytes, ops_n)
                best = dict(ms=t_k, plain_ms=cuda_ms(plain, 2),
                            bound_sector_ms=(bound(sector_bytes, ops_n)[0]
                                             if tech == "topk" else None),
                            bound_per_test_ms=(bound(nbytes, test_ops)[0]
                                               if tech == "join_bloom"
                                               else None),
                            library_ms=(None if library is None
                                        else cuda_ms(library, 3)),
                            work=work,
                            bound_ms=bms, bound_by=bby, bound_bytes=nbytes,
                            bound_ops=ops_n, max_abs_err=err,
                            shape=shape_of(tech, a, kw))
            del library
        split[tech] = parts
        kern[tech] = best
    for stage in ("filter", "join", "topk"):
        dev_ms = sum(split[t]["h2d_ms"] + split[t]["kernel_ms"]
                     + split[t]["d2h_ms"] for t, n in MAIN_KERNELS.items()
                     if KERNELS[n][1] == stage)
        split[f"{stage}_host_ms"] = stage_ms[stage] - dev_ms
    for tech, parts in split.items():
        log(f"[split] {card}: {tech}: " + (
            ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            if isinstance(parts, dict) else f"{parts:.3f} ms"))
    for tech, k in kern.items():
        lib = ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.3f} ms")
        sector = ("" if k["bound_sector_ms"] is None else
                  f"; {k['bound_sector_ms']:.4f} ms with each gathered head "
                  f"a 32-byte sector")
        if tech == "join":
            sector = (f"; (query, tile) windows by path: " + ", ".join(
                f"{p} {n}" for p, n in k["work"].items()))
        if k["bound_per_test_ms"] is not None:
            sector = (f"; {k['bound_per_test_ms']:.4f} ms counting 28 "
                      f"operations a (candidate, query) test; "
                      f"{k['work']['hashed']} candidates hashed, "
                      f"{k['work']['tested']} tests")
        log(f"[split] {card}: {tech} kernel at {k['shape']}: {k['ms']:.4f} ms "
            f"vs bound {k['bound_ms']:.4f} ms ({k['bound_by']}: "
            f"{k['bound_bytes'] / 1e6:.1f} MB, {k['bound_ops']:.3g} ops"
            f"{sector}), plain version {k['plain_ms']:.3f} ms, library {lib}")
    return split, kern


def shape_of(tech, a, kw) -> dict:
    if tech == "filter":
        return dict(Q=int(a[1].shape[0]), Kb=int(a[1].shape[1]),
                    P=int(kw["num_partitions"]), capacity=int(a[3].shape[1]))
    if tech in ("join", "join_bloom"):
        return dict(Q=int(a[0].shape[0]), row=int(a[0].shape[1]),
                    P=int(kw["num_partitions"]), capacity=int(a[1].shape[0]))
    return dict(Q=int(a[1].numel()) - 1, nnz=int(a[2].numel()), k=int(a[3]),
                capacity=int(a[0].shape[0]))


def topk_library(plane, offsets, ids, k):
    """``torch.topk`` over each query's candidate rows: two calls, an
    ``index_select`` of the rows into a dense [Q, longest list * K] block
    (padded with an all -inf row) and one ``topk``."""
    import torch
    Q = int(offsets.numel()) - 1
    off = offsets.tolist()
    longest = max(off[q + 1] - off[q] for q in range(Q))
    padded = torch.cat([plane, torch.full_like(plane[:1], float("-inf"))])
    pad_id = int(plane.shape[0])
    idx = torch.full((Q, max(longest, 1)), pad_id, dtype=torch.int64,
                     device=plane.device)
    for q in range(Q):
        idx[q, :off[q + 1] - off[q]] = ids[off[q]:off[q + 1]]
    K = int(plane.shape[1])
    width = idx.shape[1] * K

    def call():
        rows = padded.index_select(0, idx.view(-1)).view(Q, width)
        return torch.topk(rows, min(k, width), dim=1).values

    return call


# ---------------------------------------------------------------------------
# Phase 4: the per-query device path
# ---------------------------------------------------------------------------

def lowered_filters(ctx: dict) -> list:
    """(query index, ranges) of the filter-only queries whose predicates
    lower to ranges over the events table."""
    from repro_torch.core.prune_filter import extract_ranges
    stats = ctx["events"].stats
    return [(i, r) for i, r in (
        (i, extract_ranges(q.scans["events"].pred, stats))
        for i, q in enumerate(ctx["filter_queries"])) if r is not None]


def minmax_roles(lowered, stats, dev):
    """(need, widest, heaviest): each conjunction's ``minmax_need`` with
    its query index, the index of the widest conjunction and of the one
    whose data needs the most bytes."""
    from repro_torch.kernels import ops
    need = [(minmax_need(*ops._stage_ranges(r, stats, dev)[0]), i)
            for i, r in lowered if r]
    widest = max(lowered, key=lambda ir: len(ir[1]))[0]
    return need, widest, max(need)[1]


def join_key_lists(ctx: dict) -> list:
    """Each join query's distinct build keys (the ids of the users_20k
    rows its predicate keeps), sorted: the per-query path's key lists."""
    from repro_torch.core.rowval import matches
    build = ctx["build"]
    bctx = build.global_ctx()
    ids, id_nulls = bctx.col("id")
    return [np.unique(ids[matches(q.scans["users"].pred, bctx) & ~id_nulls])
            for q in ctx["join_queries"]]


def picked_topk(ctx: dict) -> list:
    """Four unfiltered top-k queries of the traffic, two in each direction
    where there are: the per-query path's top-k scans."""
    from repro_torch.core import expr as E
    plain_topk = [q for q in ctx["topk_queries"]
                  if isinstance(q.scans["events"].pred, E.TruePred)]
    picked = [q for q in plain_topk if q.order_by[2]][:2] + \
        [q for q in plain_topk if not q.order_by[2]][:2]
    picked += [q for q in plain_topk if q not in picked][:4 - len(picked)]
    if len(picked) < 4 or len({q.order_by[2] for q in picked}) < 2:
        raise SystemExit(f"traffic: {len(plain_topk)} unfiltered top-k "
                         f"queries, need 4 in both directions")
    return picked


def ordered_topk_rows(events, picked) -> dict:
    """direction -> (block-top-k rows of ``num_sightings`` [P, kmax] in the
    host scan's order, that order) for each direction of ``picked``, kmax
    the largest k of the direction's picked queries."""
    from repro_torch.kernels import ops
    stats = events.stats
    vals, vnull = events.global_ctx().col("num_sightings")
    out = {}
    for desc in sorted({q.order_by[2] for q in picked}, reverse=True):
        kmax = max(q.limit for q in picked if q.order_by[2] == desc)
        sign = 1.0 if desc else -1.0
        rows = ops.build_block_topk(sign * vals, events.part_bounds, kmax,
                                    mask=~vnull)
        bmax = stats.col_max("num_sightings") if desc \
            else -stats.col_min("num_sightings")
        order = np.argsort(-bmax, kind="stable")
        out[desc] = (rows[order], order)
    return out


def phase_per_query(ctx: dict, card: str, dev) -> dict:
    """The per-query path of ``ops`` on phase 3's events table: every
    filter-only query through ``prune_ranges_device`` (held to the batched
    verdict row and the CPU call), every join's distinct build keys through
    ``join_overlap_device`` (held to the CPU call and, for the distinct
    summaries, the batched row) and four unfiltered top-k queries through
    ``topk_boundary_device`` (held to ``topk_oracle``, the host
    ``run_topk`` skips and the CPU call; ``prefix`` to the same heap and a
    superset of the skips).  Then the per-query split, the per-query
    loop's queries/s beside the batched launch's, the host ``run_topk``
    time beside the boundary kernel's, and each kernel timed at this
    path's shapes beside its plain version and bound."""
    import torch

    from repro_torch.core.flow import PruningPipeline
    from repro_torch.core.metadata import ScanSet
    from repro_torch.core.prune_topk import run_topk, topk_oracle
    from repro_torch.kernels import join_overlap as join_overlap_mod
    from repro_torch.kernels import minmax_prune as minmax_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk_boundary as topk_mod

    events, svc = ctx["events"], ctx["svc"]
    stats = events.stats
    P = events.num_partitions
    cpu = torch.device("cpu")
    kernel_of = {n: getattr(ops, n) for n, (path, _, _) in KERNELS.items()
                 if path == PER_QUERY}

    # inputs of the path, prepared before the counts start
    lowered = lowered_filters(ctx)
    join_keys = join_key_lists(ctx)
    ndv_limit = PruningPipeline(filter_mode="host").join_ndv_limit
    picked = picked_topk(ctx)
    t0 = time.perf_counter()
    topk_rows_of = ordered_topk_rows(events, picked)
    prep_s = time.perf_counter() - t0
    log(f"[per-query] {card} host: {len(lowered)} of "
        f"{len(ctx['filter_queries'])} filter queries lower to ranges; "
        f"{len(join_keys)} joins, {sum(len(k) <= ndv_limit for k in join_keys)}"
        f" distinct summaries, {min(map(len, join_keys))}-"
        f"{max(map(len, join_keys))} keys; top-k k = "
        f"{[(q.limit, 'desc' if q.order_by[2] else 'asc') for q in picked]};"
        f" block-top-k rows built in {prep_s:.1f} s")

    # the batched reference rows (their kernels are phase 3's)
    dstats = svc.cache.get(events)
    batched_tv = ops.prune_ranges_batched_device([r for _, r in lowered],
                                                 dstats)
    small = [i for i, k in enumerate(join_keys) if len(k) <= ndv_limit]
    pmin_plane, pmax_plane = svc.cache.join_key_plane(events, "user_id")
    batched_hit = ops.join_overlap_batched_device(
        [join_keys[i] for i in small], pmin_plane, pmax_plane, P)

    for fn in kernel_of.values():
        fn.launches = 0                  # the per-query path's count
    filter_ms, want_launch = [], {n: 0 for n in kernel_of}
    for qi, (i, ranges) in enumerate(lowered):
        t = time.perf_counter()
        tv = ops.prune_ranges_device(ranges, stats, device=dev)
        filter_ms.append((time.perf_counter() - t) * 1e3)
        want_launch["minmax_prune"] += bool(ranges)
        tv_cpu = ops.prune_ranges_device(ranges, stats, device="cpu")
        if not (np.array_equal(tv, batched_tv[qi])
                and np.array_equal(tv, tv_cpu)):
            raise SystemExit(f"filter query {i}: per-query verdicts differ "
                             f"from the batched row or the CPU call")
    join_ms = []
    for i, keys in enumerate(join_keys):
        t = time.perf_counter()
        hit = ops.join_overlap_device(stats, "user_id", keys, device=dev)
        join_ms.append((time.perf_counter() - t) * 1e3)
        want_launch["join_overlap"] += bool(len(keys))
        if not np.array_equal(hit, ops.join_overlap_device(
                stats, "user_id", keys, device="cpu")):
            raise SystemExit(f"join {i}: per-query hits differ from the "
                             f"CPU call")
        if i in small and not np.array_equal(hit,
                                             batched_hit[small.index(i)]):
            raise SystemExit(f"join {i}: per-query hits differ from the "
                             f"batched row")
    topk = []
    for q in picked:
        k, desc = q.limit, q.order_by[2]
        sign = 1.0 if desc else -1.0
        rows_all, order = topk_rows_of[desc]
        rows = np.ascontiguousarray(rows_all[:, :k])
        t = time.perf_counter()
        skip, heap = ops.topk_boundary_device(rows, device=dev)
        dev_ms = (time.perf_counter() - t) * 1e3
        want_launch["topk_boundary"] += 1
        scan = ScanSet.full(P)
        t = time.perf_counter()
        host = run_topk(events, scan, "num_sightings", k, desc=desc,
                        strategy="sort")
        host_ms_ = (time.perf_counter() - t) * 1e3
        oracle = topk_oracle(events, "num_sightings", k, desc=desc)
        got = sign * np.sort(heap[heap > -np.inf])[::-1]
        host_skip = np.isin(scan.part_ids[order], host.skipped)
        cpu_skip, cpu_heap = ops.topk_boundary_device(rows, device="cpu")
        pre_skip, pre_heap = ops.topk_boundary_device(rows, mode="prefix",
                                                      device=dev)
        problems = []
        if not np.array_equal(got, oracle.astype(np.float32)):
            problems.append("heap != topk_oracle")
        if not np.array_equal(skip.astype(bool), host_skip):
            problems.append("skips != host run_topk's")
        if not (np.array_equal(skip, cpu_skip)
                and np.array_equal(heap, cpu_heap)):
            problems.append("differs from the CPU call")
        if not (np.array_equal(pre_heap, heap) and (pre_skip >= skip).all()):
            problems.append("prefix: heap differs or skips not a superset")
        if problems:
            raise SystemExit(f"top-k k={k} desc={desc}: " + "; ".join(problems))
        topk.append(dict(k=k, desc=desc, kernel_call_ms=dev_ms,
                         host_run_topk_ms=host_ms_, skipped=int(skip.sum()),
                         merged=int(P - skip.sum()),
                         prefix_skipped=int(pre_skip.sum()),
                         host_rows_scanned=host.rows_scanned))
    launches = {n: fn.launches for n, fn in kernel_of.items()}
    if launches != want_launch or not all(launches.values()):
        raise SystemExit(f"per-query path launches {launches}, expected "
                         f"{want_launch}")
    log(f"[per-query] {card}: {len(lowered)} filter queries equal to their "
        f"batched rows and the CPU calls; {len(join_keys)} joins equal to "
        f"the CPU calls and {len(small)} to their batched rows; top-k "
        f"heaps equal to topk_oracle, skips to run_topk: {topk}; "
        f"launches {launches}")

    # ---- times (after the counts: comparison launches do not count) ----
    # per-query split over every 8th lowered query
    split = dict(stage_ms=[], h2d_ms=[], kernel_ms=[], d2h_ms=[])
    for _i, ranges in lowered[::8]:
        if not ranges:
            continue
        t = time.perf_counter()
        staged, _ = ops._stage_ranges(ranges, stats, cpu)
        split["stage_ms"].append((time.perf_counter() - t) * 1e3)
        split["h2d_ms"].append(host_ms(
            lambda: [a.to(dev) for a in staged], dev))
        staged_d = [a.to(dev) for a in staged]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        tv_d = ops.minmax_prune(*staged_d)
        e1.record()
        sync(dev)
        split["kernel_ms"].append(e0.elapsed_time(e1))
        split["d2h_ms"].append(host_ms(lambda: tv_d.cpu(), dev))
    split = {k: statistics.mean(v) for k, v in split.items()}
    reps = []
    ranges_all = [r for _, r in lowered]
    for _ in range(3):
        reps.append(host_ms(lambda: ops.prune_ranges_batched_device(
            ranges_all, dstats), dev))
    batched_ms = statistics.median(reps)
    qps_loop = len(lowered) / (sum(filter_ms) / 1e3)
    qps_batched = len(lowered) / (batched_ms / 1e3)
    log(f"[per-query] {card}: filter split per query (mean of "
        f"{len(lowered[::8])}): host staging {split['stage_ms']:.3f} ms, "
        f"H2D {split['h2d_ms']:.3f}, kernel {split['kernel_ms']:.4f}, D2H "
        f"{split['d2h_ms']:.3f}; per-query loop {sum(filter_ms):.1f} ms for "
        f"{len(lowered)} queries ({qps_loop:.1f} queries/s) vs one batched "
        f"call {batched_ms:.2f} ms ({qps_batched:.1f} queries/s, "
        f"{qps_batched / qps_loop:.1f}x); join per query "
        f"{statistics.mean(join_ms):.2f} ms")

    kern = {}
    # minmax_prune: what each conjunction's data needs (its bound), then
    # the kernel at the path's widest conjunction (the row) and at the one
    # that needs the most bytes
    need, widest, heaviest = minmax_roles(lowered, stats, dev)
    by_q = dict(lowered)
    mb = sorted(b / 1e6 for (b, _), _ in need)
    log(f"[per-query] {card}: minmax_prune data needed per conjunction: "
        f"{mb[0]:.2f} / {statistics.median(mb):.2f} / {mb[-1]:.2f} MB "
        f"(min / median / max over {len(mb)}); all three [K, P] rows would "
        f"be {12 * P / 1e6:.1f} MB a constraint")
    for role, i in (("widest", widest), ("heaviest", heaviest)):
        ranges = by_q[i]
        args = ops._stage_ranges(ranges, stats, dev)[0]
        err = require_equal("minmax_prune", ops.minmax_prune(*args),
                            ref.minmax_prune_ref(*args), "the per-query path")
        nbytes, nops = next(w for w, j in need if j == i)
        bms, bby = bound(nbytes, nops)
        timed = dict(
            ms=cuda_ms(lambda: ops.minmax_prune(*args), 10),
            launch_ms=cuda_ms(lambda: minmax_mod.launch_checked(*args), 10),
            plain_ms=cuda_ms(lambda: ref.minmax_prune_ref(*args), 3),
            library_ms=None, bound_ms=bms, bound_by=bby, bound_bytes=nbytes,
            bound_ops=nops, max_abs_err=err,
            shape=dict(query=i, K=len(ranges), P=P))
        del args
        if role == "widest":
            kern["minmax_prune"] = timed
        else:
            kern["minmax_prune"]["heaviest"] = timed
    # join_overlap at the longest key list, the launch alone; beside it
    # the wrapper with its sortedness / NaN check, and the launch at the
    # longest distinct summary's list; the (tile, query) windows of both by
    # the kernel's path
    pmin, pmax, d = ops._stage_join(stats, "user_id",
                                    max(join_keys, key=len), dev)
    d_tile = ops._stage_join(stats, "user_id", max(
        (join_keys[i] for i in small), key=len), dev)[2]
    D = int(d.numel())
    join_paths = {}
    for x in (d, d_tile):
        add_paths(join_paths.setdefault(int(x.numel()), {}), x, pmin, pmax,
                  ref.JOIN_TILE_SINGLE, P)
    err = max(require_equal("join_overlap", ops.join_overlap(pmin, pmax, x),
                            ref.join_overlap_ref(pmin, pmax, x),
                            "the per-query path") for x in (d, d_tile))
    bms, bby = bound(8 * P + 4 * D + 4 * P, P * (math.log2(D) + 2))
    kern["join_overlap"] = dict(
        ms=cuda_ms(lambda: join_overlap_mod.launch_checked(pmin, pmax, d),
                   10),
        plain_ms=cuda_ms(lambda: ref.join_overlap_ref(pmin, pmax, d), 3),
        library_ms=cuda_ms(lambda: torch.searchsorted(d, pmax, right=True)
                           > torch.searchsorted(d, pmin), 3),
        bound_ms=bms, bound_by=bby, max_abs_err=err, shape=dict(D=D, P=P),
        wrapper_ms=cuda_ms(lambda: ops.join_overlap(pmin, pmax, d), 10),
        tile_ms=cuda_ms(lambda: join_overlap_mod.launch_checked(
            pmin, pmax, d_tile), 10), tile_D=int(d_tile.numel()),
        paths=join_paths)
    # topk_boundary at the first picked query's shape, launch alone
    q = picked[0]
    k = q.limit
    rows = torch.from_numpy(np.ascontiguousarray(
        topk_rows_of[q.order_by[2]][0][:, :k])).to(dev)
    b = float("-inf")
    skip, heap = ops.topk_boundary(rows, b)
    want = ref.topk_boundary_ref(rows, b)
    err = max(require_equal("topk_boundary", skip, want[0], "the path"),
              require_equal("topk_boundary", heap, want[1], "the path"))
    merged = int(P - skip.sum().item())
    # the row heads (one 32-byte sector each), the merged rows, the skips
    bms, bby = bound(32 * P + 4 * k * merged + 4 * P + 4 * k,
                     P + 2 * k * merged * max(1.0, math.log2(k)))
    tile = topk_mod.scan_tile(P, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    kern["topk_boundary"] = dict(
        ms=cuda_ms(lambda: ops.topk_boundary(rows, b), 10),
        launch_ms=cuda_ms(lambda: topk_mod.scan_launch_checked(rows, b),
                          10),
        plain_ms=cuda_ms(lambda: ref.topk_boundary_ref(rows, b), 2),
        library_ms=None, bound_ms=bms, bound_by=bby, max_abs_err=err,
        shape=dict(P=P, k=k, merged=merged, tile=tile,
                   tiles=-(-P // tile)), host_run_topk_ms=next(
            t["host_run_topk_ms"] for t in topk if t["k"] == k
            and t["desc"] == q.order_by[2]))
    del rows
    for name, kk in kern.items():
        kk["launches"] = launches[name]
        lib = ("none" if kk["library_ms"] is None
               else f"{kk['library_ms']:.4f} ms")
        log(f"[per-query] {card}: {name} at {kk['shape']}: {kk['ms']:.4f} ms "
            f"vs bound {kk['bound_ms']:.4f} ms ({kk['bound_by']}), plain "
            f"version {kk['plain_ms']:.3f} ms, library {lib}")
    for role, mm in (("widest", kern["minmax_prune"]),
                     ("heaviest", kern["minmax_prune"]["heaviest"])):
        log(f"[per-query] {card}: minmax_prune at the {role} conjunction "
            f"{mm['shape']}: wrapper {mm['ms']:.4f} ms, launch alone "
            f"{mm['launch_ms']:.4f} ms vs bound {mm['bound_ms']:.5f} "
            f"ms ({mm['bound_bytes'] / 1e6:.2f} MB needed, "
            f"{mm['bound_ops']:.3g} ops; {mm['launch_ms'] / mm['bound_ms']:.1f}"
            f"x)")
    tb = kern["topk_boundary"]
    n = tb["shape"]["tiles"]
    groups = -(-(n - 1) // ref.scan_group(n - 1)) if n > 2 else 0
    grid = ("pass C alone, one block of 256 threads" if n == 1 else
            f"pass A {n} blocks of 256 threads (the first also writes tile "
            f"0's skips), pass C {n - 1}"
            + (f", pass B {groups} blocks of 1,024 threads"
               + (" then one" if groups > 1 else "") if n > 2 else ""))
    log(f"[per-query] {card}: topk_boundary at {tb['shape']}: wrapper "
        f"{tb['ms']:.4f} ms, launch alone {tb['launch_ms']:.4f} ms; {n} "
        f"tiles of {tb['shape']['tile']} rows: {grid}")
    jo = kern["join_overlap"]
    log(f"[per-query] {card}: join_overlap wrapper (key check + launch) "
        f"{jo['wrapper_ms']:.4f} ms; launch alone at D={jo['tile_D']} (the "
        f"longest distinct summary) {jo['tile_ms']:.4f} ms; tiles of "
        f"{ref.JOIN_TILE_SINGLE} partitions, windows by path: " + "; ".join(
            f"D={n}: " + ", ".join(f"{k} {v}" for k, v in c.items())
            for n, c in jo["paths"].items()))
    log(f"[per-query] {card}: top-k host run_topk "
        f"{kern['topk_boundary']['host_run_topk_ms']:.1f} ms vs the "
        f"topk_boundary launch {kern['topk_boundary']['ms']:.4f} ms for the "
        f"same query")
    return dict(filter_queries=len(lowered), join_queries=len(join_keys),
                distinct_joins=len(small), topk=topk, split_ms=split,
                filter_loop_ms=sum(filter_ms), batched_ms=batched_ms,
                queries_per_s_loop=qps_loop,
                queries_per_s_batched=qps_batched,
                join_ms_mean=statistics.mean(join_ms), launches=launches,
                kernels=kern)


# ---------------------------------------------------------------------------
# Phase 6: the tree path and incremental ingest at full width
# ---------------------------------------------------------------------------

TREE_FANOUT = 256
TREE_TECH = {"prune_ranges_batched_tree": "filter",
             "join_overlap_batched_tree": "join",
             "bloom_probe_batched_tree": "join_bloom",
             "topk_init_batched_tree": "topk"}
JOIN_KEY = "user_id"
ORDER_COL = "num_sightings"
TS_MAX = 10_000_000


def tree_traffic(ctx: dict, seed: int) -> list:
    """Phase 6's batch on phase 3's tables: 64 selective filters on events
    (32 recent-data scans ``ts >= TS_MAX (1 - f)`` and 32 windows ``lo <=
    ts < lo + w TS_MAX``, f and w lognormal around 1% with sigma 1.0,
    capped at 10%), every fourth also ``ORDER BY num_sightings DESC LIMIT
    k``, and the 16 joins of phase 3 whose probe scan is unfiltered or
    reads ``ts`` (the group's leaf work follows its widest query, and a
    probe predicate that prunes nothing would make that all of P)."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import Query, TableScanSpec
    from repro_torch.data.generator import sample_limit_k

    events = ctx["events"]
    rng = np.random.default_rng(seed + 6)
    out = []
    for i in range(64):
        f = min(float(np.exp(rng.normal(np.log(0.01), 1.0))), 0.10)
        if i < 32:
            pred = E.col("ts") >= TS_MAX * (1 - f)
        else:
            lo = float(rng.uniform(0, TS_MAX * (1 - f)))
            pred = (E.col("ts") >= lo) & (E.col("ts") < lo + f * TS_MAX)
        q = Query(scans={"events": TableScanSpec(events, pred)})
        if i % 4 == 0:
            k = 0
            while k <= 0:
                k = sample_limit_k(rng)
            q.limit, q.order_by = int(min(k, 200)), ("events", ORDER_COL,
                                                     True)
        out.append(q)
    joins = [q for q in ctx["join_queries"]
             if isinstance(q.scans["events"].pred, E.TruePred)
             or "ts" in q.scans["events"].pred.columns()][:16]
    if len(joins) < 16:
        raise SystemExit(f"traffic: {len(joins)} joins with a selective "
                         f"probe scan, expected 16")
    return out + joins


class TreeNotes:
    """Records what each tree wrapper call did (``ops.last_tree_stats``),
    by technique; the service looks the wrappers up on ``ops`` at each
    call, so wrapping them there sees every tree rung launch."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls, self._saved = ops, [], {}

    def __enter__(self):
        for name in TREE_TECH:
            fn = getattr(self.ops, name)
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                self.calls.append((TREE_TECH[_name],
                                   dict(self.ops.last_tree_stats())))
                return out
            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def batch_problems(reports, want, where: str) -> list:
    """Each report's difference from ``want``'s, and any demotion,
    salvage or passthrough of the batch."""
    out = [f"query {i}: differs from {where}"
           for i, (r, w) in enumerate(zip(reports, want))
           if not reports_equal(r, w)]
    res = reports[0].counters["resilience"]
    if any(res["demotions"].values()):
        out.append(f"demotions {res['demotions']}")
    if res["salvaged_batches"] or res["passthroughs"] or res["errors"]:
        out.append(f"resilience {res}")
    return out


def sync_families(svc, events, topk_keys, dev) -> dict:
    """Bring each of the events table's plane families current on
    ``svc``'s cache, one getter call at a time on the host clock around
    synchronised calls: its ms and the staging counters it moved."""
    cache = svc.cache
    out = {}
    box = []

    def timed(name, fn):
        before = cache.staging_snapshot()
        ms = host_ms(fn, dev)
        after = cache.staging_snapshot()
        out[name] = dict(ms=ms, **{k: after[k] - before[k]
                                   for k in ("staged_bytes", "delta_stages",
                                             "full_restages")})

    timed("stat", lambda: box.append(cache.get(events)))
    timed("tree_stat", lambda: cache.tree_plane(events, box[0]))
    timed("join_key", lambda: cache.join_key_plane(events, JOIN_KEY))
    timed("enum", lambda: cache.enum_plane(events, JOIN_KEY))
    for col, desc in topk_keys:
        timed("block_topk", lambda: cache.block_topk_plane(events, col, desc))
    return out


def resident_arrays(svc, events) -> dict:
    """(family, key without the table's uid) -> the resident arrays of
    the events table's planes, and the enumeration plane's host meta."""
    out = {}
    for fam, store in svc.cache._stores.items():
        for key, e in store.items():
            if key[:2] != (events.name, events.stats.uid):
                continue
            arrays = e.planes if fam == "stat" else e.arrays
            meta = ((e.meta["wmax"], e.meta["domain_ok"]) if fam == "enum"
                    else None)
            out[(fam,) + tuple(key[2:])] = (tuple(arrays), meta)
    return out


def planes_differ(got: dict, want: dict) -> list:
    import torch
    out = []
    if set(got) != set(want):
        out.append(f"resident families {sorted(got)} != {sorted(want)}")
    for k in set(got) & set(want):
        (ga, gm), (wa, wm) = got[k], want[k]
        if gm != wm or len(ga) != len(wa) or not all(
                a.shape == b.shape and a.dtype == b.dtype and
                torch.equal(a, b) for a, b in zip(ga, wa)):
            out.append(f"{k} differs from a fresh stage")
    return out


def filter_stage_ms(svcs: dict, queries, dev, rounds: int = 3) -> dict:
    """The filter stage alone (``prune_batch``: the launch or the tree
    pre-pass, the verdicts' read-back and the scan sets) on each service,
    in turns (a b, b a, a b): ms by service."""
    out = {name: [] for name in svcs}
    order = list(svcs)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            out[name].append(host_ms(
                lambda s=svcs[name]: s.prune_batch(queries), dev))
    return out


def join_group_calls(svc, queries) -> list:
    """(method, args, kwargs) of every join and Bloom group call one batch
    on ``svc`` makes (the flow looks the methods up on the service at each
    call, so attributes of the instance see every call)."""
    calls, names = [], ("join_hit_batch", "bloom_hit_batch")
    for name in names:
        def rec(*a, _fn=getattr(svc, name), _name=name, **kw):
            calls.append((_name, a, kw))
            return _fn(*a, **kw)
        setattr(svc, name, rec)
    try:
        svc.run_batch(queries)
    finally:
        for name in names:
            delattr(svc, name)
    return calls


def join_stage_ms(svcs: dict, calls, dev, rounds: int = 3) -> dict:
    """Each join technique's group calls alone (on a tree rung: the group
    pre-pass, the launch and the read-back), replayed on each service in
    turns (a b, b a, a b): ms by method and service.  Fails where the
    services' hits differ."""
    out = {}
    for method in sorted({m for m, _, _ in calls}):
        mine = [(a, kw) for m, a, kw in calls if m == method]
        hits, ms, order = {}, {name: [] for name in svcs}, list(svcs)

        def run(name):
            hits[name] = [getattr(svcs[name], method)(*a, **kw)
                          for a, kw in mine]
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                ms[name].append(host_ms(lambda n=name: run(n), dev))
        ref = hits[order[0]]
        for name in order[1:]:
            if any(a is None or b is None or not np.array_equal(a, b)
                   for a, b in zip(ref, hits[name])):
                raise SystemExit(f"{method}: {name}'s hits differ from "
                                 f"{order[0]}'s")
        out[method] = ms
    return out


def dml_steps(events, seed: int) -> list:
    """(name, apply) of phase 6's DML on events, in order, scaled to its
    P (at P = 1,048,576: 4,096 partitions appended, 1,024 dropped, 256
    rewritten): appended rows come from the events generator with ``ts``
    continuing past the table's, at the table's rows a partition."""
    from repro_torch.data.generator import make_events_table

    rng = np.random.default_rng(seed + 60)
    P = events.num_partitions
    rows = int(events.part_bounds[1] - events.part_bounds[0])
    n_app, n_drop, n_rew = P // 256, P // 1024, P // 4096

    def generated(n):
        t = make_events_table(rng, n_rows=n, rows_per_partition=rows,
                              ts_clustering=0.995, user_clustering=0.99999)
        return {c: t.decode(c, t.data[c]) for c in t.columns}

    def append():
        raw = generated(n_app * rows)
        span = n_app * rows * TS_MAX // events.num_rows
        raw["ts"] = TS_MAX + (np.asarray(raw["ts"], dtype=np.int64) * span
                              // TS_MAX)
        events.append_partitions(raw, rows_per_partition=rows)

    def drop():
        live = np.nonzero(events.live_mask)[0]
        events.drop_partitions(rng.choice(live, n_drop, replace=False))

    def update_score():
        events.update_column("score", rng.random(events.num_rows))

    def update_order_col():
        events.update_column(ORDER_COL, rng.integers(
            0, 100_000, events.num_rows).astype(np.int64))

    def rewrite():
        live = np.nonzero(events.live_mask)[0]
        ids = np.sort(rng.choice(live, n_rew, replace=False))
        n = int(np.diff(events.part_bounds)[ids].sum())
        events.rewrite_partitions(ids, generated(n))

    return [("append", append), ("drop", drop),
            ("update score", update_score),
            (f"update {ORDER_COL}", update_order_col), ("rewrite", rewrite)]


TREE_BATCHES = 3         # phase 6's timed batches (2-3 s each)


def phase_tree_ingest(ctx: dict, seed: int, n_batches: int, card: str,
                      dev) -> dict:
    """Phase 6: (a) phase 6's batch through ``PruningService(tree_fanout=
    256)`` (one warm-up, ``n_batches`` timed), held to the flat card
    service, the CPU service and, on int and dictionary predicates, the
    f64 host pipeline, with the tree path on the filter group and a tree
    launch of every technique; then phase 3's batch once through it, held
    to phase 3's reports.  (b) five DML steps on events, each replayed
    into the tree service's resident planes (each family timed beside a
    fresh stage of it), the planes byte-equal to the fresh stage, the
    batch's reports equal to a fresh card service's (and the CPU
    service's after the first and last step)."""
    import torch

    from repro_torch.core.flow import PruningPipeline
    from repro_torch.kernels import ops
    from repro_torch.serve.prune_service import PruningService

    events, flat = ctx["events"], ctx["svc"]
    queries = tree_traffic(ctx, seed)
    C = len(events.columns)
    log(f"[tree] {card}: {len(queries)} queries (64 selective filters, "
        f"16 ORDER BY {ORDER_COL}, 16 joins), events P="
        f"{events.num_partitions}, fanout {TREE_FANOUT}")

    t0 = time.perf_counter()
    cpu_reports = PruningService(device="cpu",
                                 verdict_cache=False).run_batch(queries)
    t_cpu = time.perf_counter() - t0
    bloom = {i for i, r in enumerate(cpu_reports)
             if "join" in r.per_scan.get("events", {})
             and r.per_scan["events"]["join"].detail["summary_kind"]
             == "bloom"}
    host = PruningPipeline(filter_mode="host")
    t0 = time.perf_counter()
    host_reports = {i: host.run(q) for i, q in enumerate(queries)
                    if i not in bloom}
    t_host = time.perf_counter() - t0
    log(f"[tree] {card} host: references: CPU service {t_cpu:.2f} s, f64 "
        f"host pipeline {t_host:.2f} s; Bloom joins {len(bloom)}")

    # (a) the tree path, full width
    kernel_of = {t: getattr(ops, n) for t, n in MAIN_KERNELS.items()}
    svc = PruningService(device=dev, tree_fanout=TREE_FANOUT,
                         verdict_cache=False)
    tree_ms, notes = [], None
    with TreeNotes() as rec:
        for fn in kernel_of.values():
            fn.launches = 0               # this path's count from here
        for b in range(n_batches + 1):
            sync(dev)
            t0 = time.perf_counter()
            reports = svc.run_batch(queries)
            sync(dev)
            dt = (time.perf_counter() - t0) * 1e3
            if b:
                tree_ms.append(dt)
            calls = rec.take()
            c = reports[0].counters
            problems = batch_problems(reports, cpu_reports, "the CPU run")
            for i, rh in host_reports.items():
                if integral_only(queries[i]) and not host_equal(reports[i],
                                                                rh):
                    problems.append(f"query {i}: differs from the host "
                                    f"pipeline")
                if not keeps_superset(reports[i], rh):
                    problems.append(f"query {i}: drops a partition the "
                                    f"host pipeline keeps")
            by_tech = {t: [n for tt, n in calls if tt == t]
                       for t in TREE_TECH.values()}
            if any(n["path"] != "tree" for n in by_tech["filter"]) \
                    or not by_tech["filter"]:
                problems.append(f"filter group paths {by_tech['filter']}")
            if any(not v for v in by_tech.values()):
                problems.append(f"no tree launch of "
                                f"{[t for t, v in by_tech.items() if not v]}")
            if c["tree_launches"] != len(calls):
                problems.append(f"tree launches {c['tree_launches']} != "
                                f"{len(calls)} tree wrapper calls")
            if problems:
                raise SystemExit(f"tree batch {b}: " + "; ".join(
                    problems[:10]))
            notes = by_tech
            log(f"[tree] {card}: batch {b}{' (warm-up)' if b == 0 else ''}"
                f": {dt:.2f} ms, tree launches {c['tree_launches']}, paths "
                f"{ {t: [n['path'] for n in v] for t, v in by_tech.items()} }"
                f", checks passed")
        launches = {t: fn.launches for t, fn in kernel_of.items()}
        if not all(launches.values()):
            raise SystemExit(f"tree path: kernel launches {launches}")
        flat_ms = []
        for b in range(n_batches + 1):
            sync(dev)
            t0 = time.perf_counter()
            flat_reports = flat.run_batch(queries)
            sync(dev)
            if b:
                flat_ms.append((time.perf_counter() - t0) * 1e3)
            problems = batch_problems(reports, flat_reports,
                                      "the flat card service")
            if problems:
                raise SystemExit(f"flat batch {b}: " + "; ".join(
                    problems[:10]))
        f_note = notes["filter"][0]
        cap = svc.cache.get(events).capacity
        med_tree = statistics.median(tree_ms)
        log(f"[tree] {card}: tree batch median {med_tree:.3f} ms "
            f"({[round(t, 3) for t in tree_ms]}) beside the flat "
            f"service's {statistics.median(flat_ms):.3f} ms "
            f"({[round(t, 3) for t in flat_ms]}) on the same traffic; "
            f"launches {launches}; filter group: coarse density "
            f"{f_note['coarse_density']:.4f}, fine density "
            f"{f_note['fine_density']:.4f}, {f_note['leaf_cols']} leaf "
            f"columns a query ({f_note['leaf_cols'] / cap:.4%} of the "
            f"capacity); join {notes['join']}, Bloom {notes['join_bloom']},"
            f" top-k {notes['topk']}")

        stage = {}
        for what, qs in (("phase 6", queries), ("phase 3", ctx["queries"])):
            stage[what] = filter_stage_ms({"tree": svc, "flat": flat}, qs,
                                          dev)
            log(f"[tree] {card}: {what}'s filter stage alone, tree / flat "
                f"service in turns: {[round(t, 3) for t in stage[what]['tree']]}"
                f" / {[round(t, 3) for t in stage[what]['flat']]} ms")
        # the join and Bloom tree rungs launch the flat kernels on the
        # dense plane: what their group pre-pass costs on the card
        join_stage = join_stage_ms({"tree": svc, "flat": flat},
                                   join_group_calls(svc, queries), dev)
        for method, ms in join_stage.items():
            log(f"[tree] {card}: phase 6's {method} group calls alone, "
                f"tree / flat service in turns: "
                f"{[round(t, 3) for t in ms['tree']]} / "
                f"{[round(t, 3) for t in ms['flat']]} ms")
        rec.take()

        # phase 3's own batch through the tree rung
        t0 = time.perf_counter()
        p3 = svc.run_batch(ctx["queries"])
        p3_ms = (time.perf_counter() - t0) * 1e3
        problems = batch_problems(p3, ctx["reports"], "phase 3's reports")
        if problems:
            raise SystemExit("phase 3's batch through the tree rung: "
                             + "; ".join(problems[:10]))
        p3_paths = rec.take()
        log(f"[tree] {card}: phase 3's batch through the tree rung "
            f"{p3_ms:.1f} ms, equal to phase 3's reports; groups "
            f"{p3_paths}")

    # (b) ingest at full width
    topk_keys = sorted(k[2:] for k in svc.cache.topk_planes
                       if k[:2] == (events.name, events.stats.uid))
    steps = []
    for si, (name, apply) in enumerate(dml_steps(events, seed)):
        P0 = events.num_partitions
        t0 = time.perf_counter()
        apply()
        dml_s = time.perf_counter() - t0
        replay = sync_families(svc, events, topk_keys, dev)
        sync(dev)
        t0 = time.perf_counter()
        reports = svc.run_batch(queries)
        sync(dev)
        batch_ms = (time.perf_counter() - t0) * 1e3
        fresh = PruningService(device=dev, tree_fanout=TREE_FANOUT,
                               verdict_cache=False)
        full = sync_families(fresh, events, topk_keys, dev)
        problems = planes_differ(resident_arrays(svc, events),
                                 resident_arrays(fresh, events))
        problems += batch_problems(reports, fresh.run_batch(queries),
                                   "a fresh card service")
        if si in (0, 4):
            problems += batch_problems(reports, PruningService(
                device="cpu", verdict_cache=False).run_batch(queries), "the CPU service")
        want_full = {0: set(), 1: set(), 2: set(), 3: {"block_topk"},
                     4: set(replay)}[si]
        for fam, r in replay.items():
            if bool(r["full_restages"]) != (fam in want_full):
                problems.append(f"{fam}: {r['full_restages']} full "
                                f"restages")
            if fam not in want_full and not r["delta_stages"] \
                    and (si < 2 or fam in ("stat", "tree_stat")):
                problems.append(f"{fam}: no delta replay")
        n_new = events.num_partitions - P0
        if si == 0 and replay["stat"]["staged_bytes"] != 3 * C * n_new * 4:
            problems.append(f"stat replay staged "
                            f"{replay['stat']['staged_bytes']} bytes, not "
                            f"3 * {C} * {n_new} * 4")
        if problems:
            raise SystemExit(f"DML step {si + 1} ({name}): "
                             + "; ".join(problems[:10]))
        steps.append(dict(step=name, dml_s=dml_s, batch_ms=batch_ms,
                          replay=replay, full_stage=full))
        log(f"[ingest] {card}: step {si + 1} ({name}, {dml_s:.2f} s on the "
            f"host): replay / full stage ms, staged bytes: " + "; ".join(
                f"{fam} {replay[fam]['ms']:.3f} / {full[fam]['ms']:.3f} ms, "
                f"{replay[fam]['staged_bytes']} / {full[fam]['staged_bytes']}"
                f" bytes" for fam in replay)
            + f"; batch {batch_ms:.1f} ms; planes equal a fresh stage, "
              f"reports equal a fresh card service"
            + (" and the CPU service" if si in (0, 4) else ""))
        del fresh
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(queries=len(queries), bloom_joins=len(bloom),
                cpu_ref_s=t_cpu, host_ref_s=t_host, tree_batch_ms=tree_ms,
                flat_batch_ms=flat_ms,
                median_tree_ms=statistics.median(tree_ms),
                median_flat_ms=statistics.median(flat_ms),
                notes=notes, filter_stage_ms=stage,
                join_stage_ms=join_stage, phase3_tree_ms=p3_ms,
                phase3_paths=p3_paths,
                launches=launches, steps=steps)


# ---------------------------------------------------------------------------
# Phase 7: the serving surface around run_batch at full width
# ---------------------------------------------------------------------------
# On phase 3's tables as phase 6 left them: (a) the verdict cache under a
# dashboard mix, with an append repaired in place; (b) a fleet under a
# byte budget, two services sharing one cache; (c) partition-sharded
# launches over a logical mesh of four shards on the card; (d) the
# threaded front-end.

POOL = 32            # dashboard panels: distinct filter predicates
ZIPF_S = 1.1         # panel popularity
DASH_BATCH = 128
FLEET_ROWS = 2 ** 21     # P = 131,072 a fleet table at 16 rows a partition
FLEET_TABLES = 11
FLEET_DATASETS = 2       # generated datasets the fleet tables are cut from
FLEET_RATIO = 0.25       # budget / the fleet's resident bytes
LOGICAL_SHARDS = 4


def dashboard_pool(ctx: dict) -> list:
    """(spelling 1, spelling 2) of each of the first POOL of phase 3's
    filter predicates that read int and dictionary columns only and are a
    conjunction or a comparison, distinct by canonical key: the conjuncts
    swapped, or the literal on the left with the comparison flipped — the
    same canonical key.  (An append's verdict repair evaluates the new
    partitions in f64 on the host, which equals the kernel's f32 verdicts
    on int and dictionary columns; on a float column a repaired slot can
    be FULL where the kernel's widened f32 bounds keep it PARTIAL.)"""
    from repro_torch.core import expr as E
    flip = {">": "<", ">=": "<=", "<": ">", "<=": ">="}
    pool, keys = [], set()
    for q in ctx["filter_queries"]:
        p = q.scans["events"].pred
        if not integral_only(q):
            continue
        if isinstance(p, E.And):
            alt = E.And(tuple(reversed(p.children)))
        elif isinstance(p, E.Cmp) and isinstance(p.lhs, E.Col) \
                and isinstance(p.rhs, E.Lit) and p.op in flip:
            alt = E.Cmp(flip[p.op], p.rhs, p.lhs)
        else:
            continue
        ck = E.canonical_key(p)
        if ck in keys or E.canonical_key(alt) != ck:
            continue
        keys.add(ck)
        pool.append((p, alt))
        if len(pool) == POOL:
            return pool
    raise SystemExit(f"traffic: {len(pool)} dashboard predicates, "
                     f"expected {POOL}")


def dashboard_batches(ctx: dict, pool: list, rng) -> list:
    """Five batches of DASH_BATCH filter queries on events, as (query,
    pool index) pairs: the dashboard's first load (every panel in both
    spellings, then Zipf draws), three refreshes and the batch after the
    append (each DASH_BATCH draws with replacement, Zipf s = ZIPF_S over
    the pool, a random spelling)."""
    from repro_torch.core.flow import Query, TableScanSpec
    events = ctx["events"]
    w = 1.0 / np.arange(1, POOL + 1) ** ZIPF_S
    w /= w.sum()

    def q(i, s):
        return Query(scans={"events": TableScanSpec(events, pool[i][s])}), i

    def draws(n):
        return [q(int(i), int(s)) for i, s in zip(
            rng.choice(POOL, n, p=w), rng.integers(0, 2, n))]

    first = [q(i, s) for i in range(POOL) for s in (0, 1)]
    first += draws(DASH_BATCH - len(first))
    first = [first[i] for i in rng.permutation(len(first))]
    return [first] + [draws(DASH_BATCH) for _ in range(4)]


class ShardRecorder:
    """Records every launch of the four batched kernels' wrappers (inputs
    and a copy of the output); the service looks them up on ``ops`` at
    each call, so wrapping them there sees every shard's launch."""

    NAMES = ("minmax_prune_batched", "join_overlap_batched",
             "bloom_probe_batched", "topk_init_batched")

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls, self._saved = ops, [], {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.ops, name)
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                self.calls.append((_name, a, kw, out.clone()))
                return out
            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)


def shard_vs_plain(calls) -> dict:
    """Each recorded shard launch against its kernel's plain version on
    the same inputs (on the card): calls and max abs err by kernel."""
    from repro_torch.kernels import ref
    out = {}
    for name, a, kw, got in calls:
        P = kw.get("num_partitions")
        if name == "minmax_prune_batched":
            c, lo, hi, m, x, d = a
            want = ref.minmax_prune_batched_ref(c, lo, hi, m[:, :P],
                                                x[:, :P], d[:, :P])
        elif name == "join_overlap_batched":
            want = ref.join_overlap_batched_ref(*a, num_partitions=P)
        elif name == "bloom_probe_batched":
            want = ref.bloom_probe_batched_ref(*a, num_partitions=P)
        else:
            want = ref.topk_init_batched_ref(*a)
        err = require_equal(name, got, want.to(got.device),
                            f"a shard launch of phase 7 (P = {P})")
        n, e = out.get(name, (0, 0.0))
        out[name] = (n + 1, max(e, err))
    return out


def fleet_traffic(tables: list, build, rng, n: int, warm: bool) -> list:
    """A fleet round: with ``warm`` one filter, one join and (on the
    fleet tables, not events) one ``ORDER BY num_sightings DESC LIMIT 10``
    a table; else ``n`` queries on tables drawn Zipf (s = 1.2, events the
    most popular), each a filter, a join or (fleet tables) a top-k."""
    from repro_torch.core import expr as E
    from repro_torch.core.flow import JoinSpec, Query, TableScanSpec

    def filt(t):
        return Query(scans={t.name: TableScanSpec(
            t, sample_filter_pred(rng, E))})

    def join(t):
        return Query(scans={
            "users": TableScanSpec(build, E.col("age") >= int(
                rng.integers(65, 85))),
            t.name: TableScanSpec(t)},
            join=JoinSpec("users", t.name, "id", "user_id"))

    def topk(t):
        return Query(scans={t.name: TableScanSpec(
            t, E.col("ts") >= TS_MAX * 0.9)}, limit=10,
            order_by=(t.name, ORDER_COL, True))

    if warm:
        out = []
        for i, t in enumerate(tables):
            out += [filt(t), join(t)] + ([topk(t)] if i else [])
        return out
    w = 1.0 / np.arange(1, len(tables) + 1) ** 1.2
    out = []
    for ti in rng.choice(len(tables), n, p=w / w.sum()):
        t = tables[int(ti)]
        kind = int(rng.integers(0, 3 if ti else 2))
        out.append((filt, join, topk)[kind](t))
    return out


def phase_serving(ctx: dict, seed: int, card: str, dev,
                  fleet_rows: int = FLEET_ROWS,
                  fleet_tables: int = FLEET_TABLES,
                  min_fleet_bytes: int = 1 << 30) -> dict:
    """Phase 7 (after phase 6, on its tables): (a) the verdict cache, (b)
    a budgeted fleet with a shared cache, (c) sharded launches over a
    logical mesh, (d) the threaded front-end; every gate raises."""
    import threading

    import torch

    from repro_torch.core import expr as E
    from repro_torch.core.flow import PruningPipeline
    from repro_torch.data.generator import make_events_table
    from repro_torch.data.table import Table
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_plane_mesh
    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.prune_service import PruningService

    events, flat, build = ctx["events"], ctx["svc"], ctx["build"]
    kernel_of = {t: getattr(ops, n) for t, n in MAIN_KERNELS.items()}
    for fn in kernel_of.values():
        fn.launches = 0                    # this phase's count from here
    out = {}

    # (a) the verdict cache under a dashboard mix
    pool = dashboard_pool(ctx)
    rng = np.random.default_rng(seed + 7)
    batches = dashboard_batches(ctx, pool, rng)
    cached = PruningService(device=dev, cache=flat.cache)   # cache on
    cpu = PruningService(device="cpu")
    keys = [E.canonical_key(p) for p, _ in pool]
    sightings = np.zeros(POOL, dtype=np.int64)
    rows = []
    log(f"[serving] {card}: (a) {len(batches)} batches of {DASH_BATCH} "
        f"filter queries over a pool of {POOL} predicates in two spellings "
        f"each (Zipf s = {ZIPF_S}); events P={events.num_partitions}")
    for b, batch in enumerate(batches):
        if b == len(batches) - 1:
            P0 = events.num_partitions
            dml_steps(events, seed + 7)[0][1]()          # the append
            log(f"[serving] {card}: appended "
                f"{events.num_partitions - P0} partitions (P="
                f"{events.num_partitions})")
        qs = [q for q, _ in batch]
        idx = np.array([i for _, i in batch])
        uniq = np.unique(idx)
        warm = bool((sightings[uniq] >= 2).all())
        ms, reps = {}, {}
        # the two services in turns, the cached one's launches counted
        for name in (("verdict", "off") if b % 2 == 0
                     else ("off", "verdict")):
            svc = cached if name == "verdict" else flat
            if name == "verdict":
                before = (kernel_of["filter"].launches,
                          cached.counters.technique.get("filter", {}).get(
                              "launches", 0),
                          cached.cache.integrity["verdict_repairs"])
            ms[name] = host_ms(lambda s=svc, n=name: reps.__setitem__(
                n, s.run_batch(qs)), dev)
            if name == "verdict":
                launched = kernel_of["filter"].launches - before[0]
                svc_launches = cached.counters.technique["filter"][
                    "launches"] - before[1]
                repairs = cached.cache.integrity["verdict_repairs"] \
                    - before[2]
        res = reps["verdict"][0].counters["resilience"]
        problems = batch_problems(reps["verdict"], reps["off"],
                                  "the cache-off card service")
        problems += batch_problems(reps["verdict"], cpu.run_batch(qs),
                                   "the CPU run")
        if res["verdict_deduped"] != len(qs) - len(uniq):
            problems.append(f"deduped {res['verdict_deduped']}, expected "
                            f"{len(qs) - len(uniq)}")
        if warm and (launched or svc_launches
                     or res["verdict_hits"] != len(uniq)):
            problems.append(f"a warm batch launched {launched} filter "
                            f"kernels, hits {res['verdict_hits']}")
        if b == len(batches) - 1:
            fresh = PruningService(device=dev, verdict_cache=False)
            problems += batch_problems(reps["verdict"], fresh.run_batch(qs),
                                       "a fresh card service")
            del fresh
            if not warm or repairs <= 0:
                problems.append(f"after the append: warm {warm}, "
                                f"{repairs} verdict repairs")
        if b > 0 and not warm:
            problems.append("a refresh batch is not warm")
        if problems:
            raise SystemExit(f"verdict batch {b}: " + "; ".join(
                problems[:10]))
        sightings += np.bincount(idx, minlength=POOL)
        stage = filter_stage_ms({"verdict": cached, "off": flat}, qs, dev)
        rows.append(dict(batch=b, unique=int(len(uniq)), warm=warm,
                         kernel_launches=launched, hits=res["verdict_hits"],
                         misses=res["verdict_misses"],
                         deduped=res["verdict_deduped"], repairs=repairs,
                         batch_ms=ms, filter_stage_ms=stage))
        log(f"[serving] {card}: (a) batch {b}"
            f"{' (after the append)' if b == len(batches) - 1 else ''}: "
            f"{len(uniq)} unique keys, deduped {res['verdict_deduped']}, "
            f"hits {res['verdict_hits']}, misses {res['verdict_misses']}, "
            f"repairs {repairs}, filter kernel launches {launched}; batch "
            f"ms verdict / off {ms['verdict']:.2f} / {ms['off']:.2f}; filter"
            f" stage alone in turns verdict "
            f"{[round(t, 3) for t in stage['verdict']]} / off "
            f"{[round(t, 3) for t in stage['off']]} ms; equal to the "
            f"cache-off service and the CPU run")
    out["verdict"] = rows
    del cpu

    # (b) a fleet under a byte budget, two services sharing one cache
    t0 = time.perf_counter()
    base = [make_events_table(np.random.default_rng(seed + 70 + i),
                              n_rows=fleet_rows, rows_per_partition=16,
                              ts_clustering=0.995, user_clustering=0.99999)
            for i in range(FLEET_DATASETS)]
    fleet = [events] + [Table.from_arrays(
        f"fleet{i}", base[i % FLEET_DATASETS].columns,
        base[i % FLEET_DATASETS].data, base[i % FLEET_DATASETS].nulls,
        base[i % FLEET_DATASETS].part_bounds) for i in range(fleet_tables)]
    gen_s = time.perf_counter() - t0
    frng = np.random.default_rng(seed + 71)
    rounds = [fleet_traffic(fleet, build, frng, 0, warm=True)] + [
        fleet_traffic(fleet, build, frng, 24, warm=False) for _ in range(2)]
    free = PruningService(device=dev)
    t0 = time.perf_counter()
    want = [free.run_batch(rounds[0])]
    ws = free.cache.resident_bytes
    budget = int(ws * FLEET_RATIO)
    if ws < min_fleet_bytes:
        raise SystemExit(f"fleet: resident planes {ws} bytes, under "
                         f"{min_fleet_bytes}")
    want += [free.run_batch(r) for r in rounds[1:]]
    free_s = time.perf_counter() - t0
    budgeted = PruningService(device=dev, budget_bytes=budget)
    twin = PruningService(device=dev, cache=budgeted.cache)
    try:
        PruningService(device=dev, cache=budgeted.cache,
                       budget_bytes=budget + 1)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise SystemExit("fleet: a shared cache was re-budgeted")
    if twin.cache is not budgeted.cache:
        raise SystemExit("fleet: the services do not share one cache")
    t0 = time.perf_counter()
    got = budgeted.run_fleet(rounds[:2]) + [twin.run_batch(rounds[2])]
    fleet_s = time.perf_counter() - t0
    problems = []
    for r, (g, w) in enumerate(zip(got, want)):
        problems += batch_problems(g, w, f"the unbudgeted service, round {r}")
    summary = budgeted.fleet_summary()
    mem = summary["memory"]
    if not mem["evictions"]:
        problems.append("no eviction under the budget")
    if mem["bytes_in_use"] != budgeted.cache.resident_bytes:
        problems.append("budget accounting differs from the stores")
    if problems:
        raise SystemExit("fleet: " + "; ".join(problems[:10]))
    out["fleet"] = dict(tables=len(fleet), resident_bytes=ws, budget=budget,
                        generate_s=gen_s, unbudgeted_s=free_s,
                        budgeted_s=fleet_s, refusal=refusal,
                        memory=mem, staging=summary["staging"],
                        plane_hit_rate=summary["plane_hit_rate"],
                        queries=[len(r) for r in rounds])
    log(f"[serving] {card}: (b) fleet of {len(fleet)} tables (events and "
        f"{fleet_tables} of P={fleet[1].num_partitions}, generated in "
        f"{gen_s:.1f} s), resident planes {ws} bytes, budget {budget} "
        f"({FLEET_RATIO:.0%}); rounds of {[len(r) for r in rounds]} queries: "
        f"budgeted {fleet_s:.1f} s, unbudgeted {free_s:.1f} s; re-budget "
        f"refused ({refusal}); equal to the unbudgeted service; "
        f"evictions {mem['evictions']}, restage storms "
        f"{mem['restage_storms']}, peak {mem['peak_bytes']} bytes, plane "
        f"hit rate {summary['plane_hit_rate']:.4f}")
    del free, budgeted, twin, fleet, base
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) partition-sharded launches over a logical mesh on the card
    mesh = make_plane_mesh([dev] * LOGICAL_SHARDS)
    sharded = PruningService(device=dev, cache=flat.cache, shard_mesh=mesh,
                             verdict_cache=False)
    qs = ctx["filter_queries"] + ctx["limit_queries"] + ctx["join_queries"]
    # the joins' ORDER BY is phase 3's host scan: top-k off on both sides
    pipes = {n: PruningPipeline(filter_mode="device", service=s,
                                enable_topk=False)
             for n, s in (("sharded", sharded), ("flat", flat))}
    scans = flat.prune_batch(ctx["topk_queries"])
    groups = {}
    for q, ss in zip(ctx["topk_queries"], scans):
        _, col, desc = q.order_by
        groups.setdefault((col, bool(desc)), []).append(
            (ss["events"], q.effective_k))
    # bring the shared planes current (phase 6's and (a)'s DML replay,
    # the top-k planes of phase 6's updated column rebuild) off the clock
    flat.run_batch(qs, pipes["flat"])
    for col, desc in groups:
        flat.cache.block_topk_plane(events, col, desc)
    before = {t: fn.launches for t, fn in kernel_of.items()}
    ms, reps, heaps = {"sharded": [], "flat": []}, {}, {}

    def run(n):
        s = sharded if n == "sharded" else flat
        reps[n] = s.run_batch(qs, pipes[n])
        heaps[n] = {g: s.topk_init_batch(events, g[0], g[1], jobs)
                    for g, jobs in groups.items()}

    with ShardRecorder() as rec:        # every shard launch, recorded
        run("sharded")
    calls = rec.calls
    for name in ("sharded", "flat", "flat", "sharded"):     # in turns
        ms[name].append(host_ms(lambda n=name: run(n), dev))
    launched = {t: fn.launches - before[t] for t, fn in kernel_of.items()}
    problems = batch_problems(reps["sharded"], reps["flat"],
                              "phase 3's unsharded service")
    if heaps["sharded"] != heaps["flat"]:
        problems.append("top-k boundaries differ from the unsharded ones")
    c = sharded.counters
    if c.sharded_launches != c.launches or not c.launches:
        problems.append(f"sharded launches {c.sharded_launches} of "
                        f"{c.launches}")
    if problems:
        raise SystemExit("sharded: " + "; ".join(problems[:10]))
    shard_check = shard_vs_plain(calls)
    del calls
    if set(shard_check) != set(ShardRecorder.NAMES):
        raise SystemExit(f"sharded: shard launches of {sorted(shard_check)}")
    host_mesh = make_plane_mesh() if dev.type == "cuda" else (dev,)
    default = PruningService(device=dev, cache=flat.cache, shard_mesh=True,
                             verdict_cache=False)
    default.run_batch(ctx["filter_queries"][:8])
    if (default.counters.sharded_launches > 0) != (len(host_mesh) > 1):
        raise SystemExit(f"default mesh of {len(host_mesh)}: sharded "
                         f"launches {default.counters.sharded_launches}")
    P, cap = events.num_partitions, flat.cache.get(events).capacity
    out["sharded"] = dict(shards=LOGICAL_SHARDS, batch_ms=ms,
                          live_shards=[s[2] for s in ops._shard_spans(
                              cap, LOGICAL_SHARDS, P)],
                          service_launches=c.launches,
                          kernel_launches=launched,
                          shard_vs_plain={k: dict(calls=n, max_abs_err=e)
                                          for k, (n, e) in
                                          shard_check.items()},
                          machine_mesh=len(host_mesh))
    log(f"[serving] {card}: (c) {LOGICAL_SHARDS} logical shards of "
        f"{cap // LOGICAL_SHARDS} partitions (live "
        f"{out['sharded']['live_shards']}): {len(qs)} queries, batch ms "
        f"sharded {[round(t, 2) for t in ms['sharded']]} / unsharded "
        f"{[round(t, 2) for t in ms['flat']]} in turns; top-k boundaries of "
        f"{sum(len(j) for j in groups.values())} queries; bit-identical to "
        f"the unsharded service; service launches {c.launches}, all "
        f"sharded; kernel launches {launched}; each shard launch equal to "
        f"its plain version: { {k: n for k, (n, _) in shard_check.items()} }"
        f"; make_plane_mesh() here: {len(host_mesh)} device(s), default "
        f"service sharded launches {default.counters.sharded_launches}")
    del sharded, default

    # (d) the threaded front-end
    fe_svc = PruningService(device=dev, cache=flat.cache)    # cache on
    qs = ctx["filter_queries"] + ctx["join_queries"]
    pipe = PruningPipeline(filter_mode="device", service=fe_svc,
                           enable_topk=False)
    direct = flat.run_batch(qs, PruningPipeline(
        filter_mode="device", service=flat, enable_topk=False))
    staged0 = fe_svc.cache.staging_snapshot()["prefetch_stages"]
    futs = [None] * len(qs)
    errs = []

    def client(k):
        try:
            for i in range(k, len(qs), 4):
                futs[i] = fe.submit(qs[i])
        except Exception as exc:        # reported below, never passed over
            errs.append(exc)

    t0 = time.perf_counter()
    with ServingFrontend(fe_svc, pipe, max_batch=32,
                         deadline_s=0.01) as fe:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        fe.drain()
    fe_s = time.perf_counter() - t0
    if errs:
        raise SystemExit(f"front-end: a client raised {errs[0]!r}")
    if not all(f is not None and f.done() for f in futs):
        raise SystemExit("front-end: a future was left unresolved")
    resps = [f.result() for f in futs]
    problems = [f"query {i}: differs from run_batch"
                for i, (r, w) in enumerate(zip(resps, direct))
                if not reports_equal(r.report, w)]
    if problems:
        raise SystemExit("front-end: " + "; ".join(problems[:10]))
    lat = fe_svc.fleet_summary()["latency"]
    prefetch = fe_svc.cache.staging_snapshot()["prefetch_stages"] - staged0
    out["frontend"] = dict(queries=len(qs), s=fe_s, latency=lat,
                           prefetch_stages=prefetch,
                           verdict_hits=fe_svc.resilience["verdict_hits"])
    log(f"[serving] {card}: (d) {len(qs)} queries from 4 threads, "
        f"max_batch 32, deadline 10 ms: {fe_s:.2f} s; {lat['batches']} "
        f"batches ({lat['size_fired']} size-fired, "
        f"{lat['deadline_fired']} deadline, {lat['flush_fired']} flush); "
        f"latency p50 {lat['p50_ms']:.1f} / p99 {lat['p99_ms']:.1f} / max "
        f"{lat['max_ms']:.1f} ms; prefetch stages {prefetch}; every "
        f"response equals run_batch")
    out["launches"] = {t: fn.launches for t, fn in kernel_of.items()}
    if not all(out["launches"].values()):
        raise SystemExit(f"phase 7: kernel launches {out['launches']}")
    out["shard_max_abs_err"] = {
        k: e for k, (_, e) in shard_check.items()}
    return out


# ---------------------------------------------------------------------------
# Phase 8: query answers, the adaptive tree, the top-k predicate cache,
# Iceberg two-level pruning and curation, and DML under the threaded
# front-end, on events as phase 7 leaves it
# ---------------------------------------------------------------------------
# Answers are held to an oracle over whole columns: the executor's own
# unpruned scan (``execute_query(q, None)``) runs once a kind, tying the
# two together.

ANSWER_MIN = 8          # (a) queries executed of each kind, at least
ANSWER_KIND_S = 4.0     # (a) time a kind may take past ANSWER_MIN queries
ADAPTIVE_WINDOWS = 16   # (b) phase 6's time windows (two leaves each) ...
ADAPTIVE_LEAVES = 4     # ... and recent-data scans (one leaf each)
ICE_FILES = 8           # (d) row groups a file
CORPUS_SHARDS = 65_536  # (d) the curation corpus
F1_ROUNDS = 20          # (e) DML rounds while the front-end serves
F1_CLIENTS = 4
F1_SHIFT = 5.0          # (e) version B's score is version A's + this


def live_rows(table) -> np.ndarray:
    """[rows] bool: the rows of the table's live partitions."""
    return np.repeat(table.live_mask, np.diff(table.part_bounds))


def rows_as_answer(table, rows, name: str):
    """The columns and null masks of ``rows``, named as the executor
    names them."""
    cols = {f"{name}.{c}": table.data[c][rows] for c in table.columns}
    nulls = {f"{name}.{c}": (table.nulls[c][rows] if c in table.nulls
                             else np.zeros(len(rows), dtype=bool))
             for c in table.columns}
    return cols, nulls


class Oracle:
    """Each query's answer over whole columns: one ``matches`` over every
    row of a table (live rows only), the joins by the executor's
    ``_join_indices`` over the whole key columns, top-k by a partial sort
    of the order column, NULLS LAST.  Row masks are kept by (table,
    version, canonical predicate)."""

    def __init__(self):
        self._masks = {}

    def mask(self, spec) -> np.ndarray:
        from repro_torch.core import expr as E
        from repro_torch.core.rowval import matches
        key = (id(spec.table), spec.table.version,
               E.canonical_key(spec.pred))
        m = self._masks.get(key)
        if m is None:
            m = live_rows(spec.table)
            if not isinstance(spec.pred, E.TruePred):
                m = m & matches(spec.pred, spec.table.global_ctx())
            self._masks[key] = m
        return m

    def answer(self, q):
        from repro_torch.data.scan import _join_indices
        if q.join is None:
            (name, spec), = q.scans.items()
            return rows_as_answer(
                spec.table, np.flatnonzero(self.mask(spec)), name)
        j = q.join
        bspec, pspec = q.scans[j.build], q.scans[j.probe]
        bcols, bnulls = rows_as_answer(
            bspec.table, np.flatnonzero(self.mask(bspec)), j.build)
        pcols, pnulls = rows_as_answer(
            pspec.table, np.flatnonzero(self.mask(pspec)), j.probe)
        pk, bk = f"{j.probe}.{j.probe_key}", f"{j.build}.{j.build_key}"
        pi, bi, _ = _join_indices(pcols[pk], pnulls[pk], bcols[bk],
                                  bnulls[bk], j.kind)
        cols = {c: v[pi] for c, v in pcols.items()}
        nulls = {c: v[pi] for c, v in pnulls.items()}
        pad = bi < 0
        safe = np.where(pad, 0, bi)
        for c, v in bcols.items():
            cols[c] = np.where(pad, np.nan, v[safe])
            nulls[c] = np.where(pad, True, bnulls[c][safe])
        return cols, nulls

    def topk(self, q):
        """(values, nulls) of a top-k query's order column in the answer's
        order: the best ``offset + limit`` non-null values, then nulls."""
        (_, spec), = q.scans.items()
        _, col, desc = q.order_by
        m = self.mask(spec)
        nm = spec.table.nulls.get(col)
        nm = np.zeros(len(m), dtype=bool) if nm is None else nm
        vals = np.asarray(spec.table.data[col][m & ~nm], dtype=np.float64)
        need = q.offset + q.limit
        keep = min(need, len(vals))
        if keep:
            part = np.partition(-vals if desc else vals, keep - 1)[:keep]
            top = -np.sort(part) if desc else np.sort(part)
        else:
            top = vals[:0]
        n_null = min(int((m & nm).sum()), need - keep)
        values = np.concatenate([top, np.zeros(n_null)])
        nulls = np.concatenate([np.zeros(keep, dtype=bool),
                                np.ones(n_null, dtype=bool)])
        cut = slice(q.offset, q.offset + q.limit)
        return values[cut], nulls[cut]

    def full_scan(self, q) -> tuple:
        """(partitions, bytes) the unpruned scan reads: every live
        partition of every scanned table, a plain LIMIT up to the first
        partition that completes its rows."""
        from repro_torch.data.scan import BYTES_PER_VALUE
        parts = nbytes = 0
        for spec in q.scans.values():
            t = spec.table
            bounds = np.asarray(t.part_bounds, dtype=np.int64)
            live = np.flatnonzero(t.live_mask)
            lens = (bounds[1:] - bounds[:-1])[live]
            n = len(live)
            if q.is_plain_limit and q.join is None:
                hits = np.concatenate([[0], np.cumsum(self.mask(spec))])
                counts = hits[bounds[1:]] - hits[bounds[:-1]]
                reached = np.flatnonzero(np.cumsum(counts[live])
                                         >= q.effective_k)
                n = int(reached[0]) + 1 if reached.size else n
            parts += n
            nbytes += int(lens[:n].sum()) * len(t.columns) * BYTES_PER_VALUE
        return parts, nbytes


def sorted_rows(cols, nulls) -> np.ndarray:
    """An answer's rows as a matrix in lexicographic order: two answers
    are equal multisets of rows when these are equal."""
    keys = sorted(cols)
    m = np.stack([np.asarray(cols[c], np.float64) for c in keys]
                 + [np.asarray(nulls[c], np.float64) for c in keys], axis=1)
    return m[np.lexsort(m.T[::-1])] if len(m) else m


def answer_problems(q, res, oracle: Oracle, kind: str) -> list:
    """How ``res`` (an ``execute_query`` result) differs from the oracle:
    filter and join answers as multisets of rows, top-k by its ordered
    order-column values and nulls (NULLS LAST), a plain LIMIT as
    min(k, matching) rows each satisfying the predicate."""
    from repro_torch.core.rowval import RowContext, matches
    if kind == "limit":
        (name, spec), = q.scans.items()
        matching = int(oracle.mask(spec).sum())
        want = min(q.limit, max(0, matching - q.offset))
        out = [] if res.num_rows == want else [
            f"{res.num_rows} rows, expected min(k, matching) = {want}"]
        ctx = RowContext(spec.table.columns,
                         {c: res.columns[f"{name}.{c}"]
                          for c in spec.table.columns},
                         {c: res.nulls[f"{name}.{c}"]
                          for c in spec.table.columns})
        if not matches(spec.pred, ctx).all():
            out.append("a row does not satisfy the predicate")
        return out
    if kind == "topk":
        (name, _), = q.scans.items()
        c = f"{name}.{q.order_by[1]}"
        wv, wn = oracle.topk(q)
        gn = res.nulls[c]
        if not (np.array_equal(gn, wn) and np.array_equal(
                res.columns[c][~gn], wv[~wn])):
            return ["top-k order values differ from the oracle's"]
        return []
    cols, nulls = oracle.answer(q)
    if res.num_rows != len(next(iter(cols.values()))):
        return [f"{res.num_rows} rows, the oracle "
                f"{len(next(iter(cols.values())))}"]
    if not np.array_equal(sorted_rows(res.columns, res.nulls),
                          sorted_rows(cols, nulls), equal_nan=True):
        return ["rows differ from the oracle's"]
    return []


def verdict_row(scan_set, P: int) -> np.ndarray:
    row = np.zeros(P, dtype=np.int8)
    row[scan_set.part_ids] = scan_set.match
    return row


def f1_scores(table) -> np.ndarray:
    """Version A of ``score`` for (e): partition p's rows spread evenly
    over [10p, 10p + 9] (integers, exact in f32, so a partition wholly
    inside a query's range is FULL)."""
    bounds = np.asarray(table.part_bounds, dtype=np.int64)
    n = np.diff(bounds)
    part = np.repeat(np.arange(len(n)), n)
    j = np.arange(bounds[-1]) - bounds[:-1][part]
    span = np.maximum(n[part] - 1, 1)
    return 10.0 * part + np.round(9.0 * j / span)


def phase_answers(ctx: dict, seed: int, card: str, dev,
                  corpus_shards: int = CORPUS_SHARDS,
                  f1_rounds: int = F1_ROUNDS) -> dict:
    """Phase 8 (after phase 7, on its tables): (a) answers of the card's
    reports against an oracle over whole columns, (b) the adaptive filter
    tree, (c) the top-k predicate cache across an append and an update,
    (d) Iceberg two-level pruning, curation and a resumed loader, (e)
    DML while the threaded front-end serves; every gate raises."""
    import threading

    from repro_torch.core import expr as E
    from repro_torch.core.flow import PruningPipeline, Query, TableScanSpec
    from repro_torch.core.metadata import (FULL_MATCH, NO_MATCH, ScanSet,
                                           mask_dead_partitions)
    from repro_torch.core.predicate_cache import (PredicateCache,
                                                  TableVersion, plan_key)
    from repro_torch.core.prune_tree import AdaptivePruner
    from repro_torch.data import scan as xs
    from repro_torch.data.iceberg import IcebergTable, two_level_prune
    from repro_torch.data.pipeline import (PrunedDataLoader, curate,
                                           make_corpus_metadata)
    from repro_torch.kernels import ops
    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.prune_service import PruningService

    events, flat = ctx["events"], ctx["svc"]
    kernel_of = {t: getattr(ops, n) for t, n in MAIN_KERNELS.items()}
    for fn in kernel_of.values():
        fn.launches = 0                    # this phase's count from here
    svc = PruningService(device=dev, cache=flat.cache, verdict_cache=False)
    out = {}

    # (a) answers, not only scan sets
    t_sub = time.perf_counter()
    p6 = tree_traffic(ctx, seed)[:64]
    filters = [q for q in p6 if not q.is_topk]
    joins = [q for q in ctx["join_queries"] if not q.is_topk]
    batch = (filters + [q for q in p6 if q.is_topk] + ctx["limit_queries"]
             + ctx["topk_queries"] + joins)
    box = []
    batch_ms = host_ms(lambda: box.append(svc.run_batch(batch)), dev)
    reports = box[0]
    problems = batch_problems(reports, reports, "itself")
    if problems:
        raise SystemExit("answers batch: " + "; ".join(problems[:10]))
    rep_of = {id(q): r for q, r in zip(batch, reports)}
    rng = np.random.default_rng(seed + 8)

    def kind_of_join(q):
        return rep_of[id(q)].per_scan["events"]["join"].detail[
            "summary_kind"]

    bloom = [q for q in joins if kind_of_join(q) == "bloom"]
    distinct = [q for q in joins if kind_of_join(q) != "bloom"]
    if not bloom or not distinct:
        raise SystemExit(f"answers: {len(distinct)} distinct and "
                         f"{len(bloom)} Bloom joins")
    mixed = [q for pair in zip(rng.permutation(len(distinct)),
                               rng.permutation(len(bloom)))
             for q in (distinct[pair[0]], bloom[pair[1]])]
    mixed += [q for q in distinct + bloom if q not in mixed]
    kinds = {"filter": [filters[i] for i in rng.permutation(len(filters))],
             "limit": [ctx["limit_queries"][i] for i in
                       rng.permutation(len(ctx["limit_queries"]))],
             "topk": [ctx["topk_queries"][i] for i in
                      rng.permutation(len(ctx["topk_queries"]))],
             "join": mixed}
    oracle = Oracle()
    answers = {}
    io = {"pruned": [0, 0], "unpruned": [0, 0]}
    for kind, qs in kinds.items():
        done, first_s = 0, None
        t0 = time.perf_counter()
        exec_s = 0.0
        for q in qs:
            if done >= ANSWER_MIN and \
                    time.perf_counter() - t0 > ANSWER_KIND_S:
                break
            t1 = time.perf_counter()
            res = xs.execute_query(q, rep_of[id(q)])
            exec_s += time.perf_counter() - t1
            bad = answer_problems(q, res, oracle, kind)
            if bad:
                raise SystemExit(f"answers, {kind} query {done}: "
                                 + "; ".join(bad))
            if first_s is None:
                first_s = time.perf_counter() - t1
            io["pruned"][0] += sum(m.partitions_scanned
                                   for m in res.metrics.values())
            io["pruned"][1] += res.total_bytes()
            parts, nbytes = oracle.full_scan(q)
            io["unpruned"][0] += parts
            io["unpruned"][1] += nbytes
            done += 1
        # one query of the kind through the executor's unpruned scan
        q = next((q for q in qs if not all(
            isinstance(s.pred, E.TruePred) for s in q.scans.values())),
            qs[0])
        t1 = time.perf_counter()
        res0 = xs.execute_query(q, None)
        none_s = time.perf_counter() - t1
        bad = answer_problems(q, res0, oracle, kind)
        parts, nbytes = oracle.full_scan(q)
        got_io = (sum(m.partitions_scanned for m in res0.metrics.values()),
                  res0.total_bytes())
        if got_io != (parts, nbytes):
            bad.append(f"unpruned scan read {got_io}, the oracle's count "
                       f"{(parts, nbytes)}")
        if bad:
            raise SystemExit(f"answers, {kind} query without pruning: "
                             + "; ".join(bad))
        answers[kind] = dict(queries=done, of=len(qs), first_s=first_s,
                             exec_s=exec_s,
                             s=time.perf_counter() - t0,
                             unpruned_s=none_s, unpruned_rows=res0.num_rows)
        log(f"[answers] {card}: (a) {kind}: {done} of {len(qs)} queries "
            f"(the first took {first_s:.2f} s; sized to {ANSWER_MIN} or "
            f"more within {ANSWER_KIND_S} s) equal to the oracle over whole "
            f"columns, executor {exec_s:.2f} s; one through execute_query("
            f"q, None) in {none_s:.2f} s ({res0.num_rows} rows, "
            f"{got_io[0]} partitions), equal too")
    out["answers"] = dict(batch_queries=len(batch), batch_ms=batch_ms,
                          kinds=answers, io=io,
                          distinct_joins=len(distinct),
                          bloom_joins=len(bloom),
                          s=time.perf_counter() - t_sub)
    log(f"[answers] {card}: (a) batch of {len(batch)} queries ({len(filters)}"
        f" filters and {len(p6) - len(filters)} top-k of phase 6, "
        f"{len(ctx['limit_queries'])} LIMIT, {len(ctx['topk_queries'])} "
        f"top-k and {len(joins)} joins of phase 3: {len(distinct)} distinct,"
        f" {len(bloom)} Bloom) in {batch_ms:.1f} ms; scanned with pruning "
        f"{io['pruned'][0]} partitions / {io['pruned'][1]} bytes, without "
        f"{io['unpruned'][0]} / {io['unpruned'][1]} "
        f"({1 - io['pruned'][1] / max(io['unpruned'][1], 1):.4%} of the "
        f"bytes saved); (a) took {out['answers']['s']:.1f} s")

    # (b) the adaptive filter tree
    t_sub = time.perf_counter()
    preds = ([q.scans["events"].pred for q in p6[32:]
              if not q.is_topk][:ADAPTIVE_WINDOWS]
             + [q.scans["events"].pred for q in p6[:32]
                if not q.is_topk][:ADAPTIVE_LEAVES])
    qs = [Query(scans={"events": TableScanSpec(events, p)}) for p in preds]
    exact = svc.run_batch(qs)
    apipe = PruningPipeline(adaptive=True, filter_mode="device", service=svc)
    before = {t: fn.launches for t, fn in kernel_of.items()}
    adapt_ms = host_ms(lambda: box.append(svc.run_batch(qs, apipe)), dev)
    adapt = box[-1]
    launched = {t: fn.launches - before[t] for t, fn in kernel_of.items()}
    c = adapt[0].counters
    problems = []
    if any(launched.values()) or c["launches"] or c["tree_launches"]:
        problems.append(f"kernel launches {launched}, counters "
                        f"{c['launches']} / {c['tree_launches']}")
    if any(v for t in c["technique"].values() for v in t.values()):
        problems.append(f"technique counters {c['technique']}")
    res = c["resilience"]
    if any(res["demotions"].values()) or res["passthroughs"]:
        problems.append(f"resilience {res}")
    for i, (a, e) in enumerate(zip(adapt, exact)):
        sa, se = a.scan_sets["events"], e.scan_sets["events"]
        if not np.isin(se.part_ids, sa.part_ids).all():
            problems.append(f"query {i}: drops a partition the card keeps")
        if not np.isin(sa.part_ids[sa.match == FULL_MATCH],
                       se.part_ids[se.match == FULL_MATCH]).all():
            problems.append(f"query {i}: FULL where the card is not")
        if i >= ADAPTIVE_WINDOWS and not scan_sets_equal(a, e):
            problems.append(f"single-leaf query {i}: differs from the card")
    if problems:
        raise SystemExit("adaptive: " + "; ".join(problems[:10]))
    card_stage = filter_stage_ms({"card": svc}, qs, dev)["card"]
    P = events.num_partitions
    leaf = AdaptivePruner(preds[0]).run(events.stats,
                                        batch_size=max(P // 8, 1)).leaf_report
    kept = [(len(a.scan_sets["events"]), len(e.scan_sets["events"]))
            for a, e in zip(adapt, exact)]
    out["adaptive"] = dict(queries=len(qs), adaptive_ms=adapt_ms,
                           card_filter_stage_ms=card_stage, kept=kept,
                           leaf_report=leaf, s=time.perf_counter() - t_sub)
    log(f"[answers] {card}: (b) {len(qs)} filters ({ADAPTIVE_WINDOWS} "
        f"windows of phase 6, {ADAPTIVE_LEAVES} single leaves) through "
        f"PruningPipeline(adaptive=True): no kernel launch, no demotion; "
        f"kept sets contain the card's, FULL within the card's, single "
        f"leaves equal to it; kept adaptive / card {kept[:4]}...; the "
        f"adaptive batch {adapt_ms:.1f} ms on the host beside the card's "
        f"filter stage {[round(t, 3) for t in card_stage]} ms; leaf report "
        f"of query 0: {leaf}; (b) took {out['adaptive']['s']:.1f} s")

    # (c) the top-k predicate cache across an append and an update
    t_sub = time.perf_counter()
    pc = PredicateCache()
    tv = TableVersion(events.num_partitions)
    topk_q = ctx["topk_queries"]

    def key_of(q):
        _, col, desc = q.order_by
        return plan_key(events.name, q.scans["events"].pred, col,
                        bool(desc), q.effective_k)

    for q in topk_q:
        pc.record(key_of(q), rep_of[id(q)].topk.contributing, tv,
                  pred=q.scans["events"].pred, table=events)
    n_keys = len(pc.entries)
    P0 = events.num_partitions
    dml_steps(events, seed + 8)[0][1]()                 # phase 6's append
    tv.insert_partitions(events.num_partitions - P0)
    fresh_ms = host_ms(lambda: box.append(svc.run_batch(topk_q)), dev)
    fresh = box[-1]
    problems, via_cache, via_boundary = [], 0, 0
    for i, (q, fr) in enumerate(zip(topk_q, fresh)):
        ids = pc.lookup(key_of(q), tv, table=events)
        if ids is None:
            problems.append(f"query {i}: missed after an append")
            continue
        _, col, desc = q.order_by
        pred = q.scans["events"].pred
        cols, nulls, m = xs.scan_partitions(
            events, ScanSet(ids),
            None if isinstance(pred, E.TruePred) else pred)
        vals = np.sort(cols[col][~nulls[col]])
        top = (vals[::-1] if desc else vals)[:q.effective_k]
        if not np.array_equal(top, fr.topk.values):
            problems.append(f"query {i}: top-k through the cache differs "
                            f"from a fresh run_batch")
        via_cache += m.partitions_scanned
        via_boundary += len(fr.topk.scanned)
    hit_rate = pc.hit_rate
    events.update_column(ORDER_COL, rng.integers(
        0, 100_000, events.num_rows).astype(np.int64))
    stale = sum(pc.lookup(key_of(q), tv, table=events) is not None
                for q in topk_q)
    if stale:
        problems.append(f"{stale} entries hit after an update of "
                        f"{ORDER_COL}")
    if problems:
        raise SystemExit("predicate cache: " + "; ".join(problems[:10]))
    out["predicate_cache"] = dict(
        queries=len(topk_q), entries=n_keys, appended=int(
            events.num_partitions - P0), fresh_batch_ms=fresh_ms,
        hit_rate_after_append=hit_rate, hit_rate=pc.hit_rate,
        scanned_via_cache=via_cache, scanned_via_boundary=via_boundary,
        s=time.perf_counter() - t_sub)
    log(f"[answers] {card}: (c) {len(topk_q)} top-k queries recorded "
        f"({n_keys} plan keys); after an append of "
        f"{events.num_partitions - P0} partitions every lookup hit (hit "
        f"rate {hit_rate:.3f}) and its scan gave the top-k of a fresh "
        f"run_batch ({fresh_ms:.1f} ms): {via_cache} partitions scanned "
        f"through the cache beside {via_boundary} by the boundary scan; "
        f"after an update of {ORDER_COL} every lookup missed (hit rate "
        f"{pc.hit_rate:.3f}); (c) took {out['predicate_cache']['s']:.1f} s")

    # (d) Iceberg two-level pruning, curation and a resumed loader
    t_sub = time.perf_counter()
    t0 = time.perf_counter()
    ice = IcebergTable.from_table(events, groups_per_file=ICE_FILES)
    from_s = time.perf_counter() - t0
    ipreds = ([q.scans["events"].pred for q in p6[:8] + p6[32:40]]
              + [p for p, _ in dashboard_pool(ctx)[:8]])
    qs = [Query(scans={"events": TableScanSpec(events, p)}) for p in ipreds]
    flat_sets = svc.prune_batch(qs)
    P = events.num_partitions
    t0 = time.perf_counter()
    two = [two_level_prune(p, ice) for p in ipreds]
    two_s = time.perf_counter() - t0
    problems = [f"predicate {i}: two-level verdicts differ from the card's"
                for i, (r, fs) in enumerate(zip(two, flat_sets))
                if not np.array_equal(mask_dead_partitions(r.group_tv, events),
                                      verdict_row(fs["events"], P))]
    meta = make_corpus_metadata(np.random.default_rng(seed + 80),
                                n_shards=corpus_shards)
    cpreds = [(E.col("ingest_ts") >= 6_000_000)
              & E.startswith(E.col("lang"), "en"),
              (E.col("ingest_ts") >= 2_000_000)
              & (E.col("ingest_ts") < 2_500_000),
              E.like(E.col("lang"), "zh-%")]
    curated = []
    for i, p in enumerate(cpreds):
        scan, crep = curate(meta, p)
        got = svc.run_batch([Query(scans={"c": TableScanSpec(meta, p)})])[0]
        cs = got.scan_sets["c"]
        if not (np.array_equal(scan.part_ids, cs.part_ids)
                and np.array_equal(scan.match, cs.match)):
            problems.append(f"curation {i}: differs from the card's scan "
                            f"set")
        curated.append((crep.shards_selected, crep.pruning_ratio))
    scan, _ = curate(meta, cpreds[0])
    kw = dict(worker=0, n_workers=2, batch_size=4, seq_len=512,
              vocab=151_552, tokens_per_shard=4096, seed=seed)
    loader = PrunedDataLoader(scan, **kw)
    it = iter(loader)
    for _ in range(5):
        next(it)
    state = loader.state()
    want = [next(it)["tokens"] for _ in range(8)]
    again = PrunedDataLoader(scan, **kw)
    again.restore(state)
    got = [b["tokens"] for b, _ in zip(again, range(8))]
    import torch
    if len(got) != len(want) or not all(torch.equal(a, b)
                                        for a, b in zip(got, want)):
        problems.append("the resumed loader's batches differ")
    if problems:
        raise SystemExit("iceberg / curation: " + "; ".join(problems[:10]))
    G = events.num_partitions
    out["iceberg"] = dict(
        groups=G, files=ice.num_files, from_table_s=from_s,
        two_level_s=two_s, predicates=len(ipreds),
        files_pruned=[r.files_pruned for r in two],
        group_meta_reads=[r.group_meta_reads for r in two],
        corpus_shards=meta.num_partitions, curated=curated,
        s=time.perf_counter() - t_sub)
    reads = [r.group_meta_reads / G for r in two]
    log(f"[answers] {card}: (d) IcebergTable.from_table(events, "
        f"{ICE_FILES} groups a file): {G} groups in {ice.num_files} files in "
        f"{from_s:.2f} s; {len(ipreds)} int and dictionary predicates "
        f"two-level in {two_s:.2f} s, each equal to the card's verdict "
        f"row; files pruned {[r.files_pruned for r in two]}, row-group "
        f"stats read / G {[round(x, 4) for x in reads]}; curation over "
        f"{meta.num_partitions} shards equal to the card's scan set "
        f"(selected, pruned share) {curated}; a loader resumed from "
        f"state() after 5 batches gave the next 8 again; (d) took "
        f"{out['iceberg']['s']:.1f} s")

    # (e) DML while the threaded front-end serves
    t_sub = time.perf_counter()
    score_a = f1_scores(events)
    score_b = score_a + F1_SHIFT
    events.update_column("score", score_a)
    P = events.num_partitions
    bases = [q.scans["events"].pred for q in filters[:16]]
    base_rows = [verdict_row(fs["events"], P) for fs in svc.prune_batch(
        [Query(scans={"events": TableScanSpec(events, p)}) for p in bases])]
    fpreds = []
    for p, row in zip(bases, base_rows):
        full = np.flatnonzero(row == FULL_MATCH)
        if len(full) < 4:
            continue
        pa, pb = int(full[len(full) // 4]), int(full[3 * len(full) // 4])
        fpreds.append(E.And((p, (E.col("score") >= 10.0 * pa + 5)
                             & (E.col("score") <= 10.0 * pb + 9))))
    if len(fpreds) < 8:
        raise SystemExit(f"F1: {len(fpreds)} predicates with a FULL run")
    fqs = [Query(scans={"events": TableScanSpec(events, p)}) for p in fpreds]
    truth = {}
    for name, vals in (("B", score_b), ("A", score_a)):
        events.update_column("score", vals)
        ref = PruningService(device=dev, verdict_cache=False)
        truth[name] = [verdict_row(r.scan_sets["events"], P)
                       for r in ref.run_batch(fqs)]
        del ref
    if any(np.array_equal(a, b) for a, b in zip(truth["A"], truth["B"])):
        raise SystemExit("F1: a query's verdicts are equal under A and B")
    stats0 = svc.cache.staging_snapshot()
    seen = {"A": 0, "B": 0}
    torn, errors = [], []
    served = threading.Condition()
    count = [0]
    stop = threading.Event()

    def client(k):
        try:
            i = k
            while not stop.is_set():
                qi = i % len(fqs)
                r = fe.submit(fqs[qi]).result()
                row = verdict_row(r.report.scan_sets["events"], P)
                with served:
                    name = next((n for n in ("A", "B")
                                 if np.array_equal(row, truth[n][qi])), None)
                    if name is None:
                        torn.append(qi)
                    else:
                        seen[name] += 1
                    count[0] += 1
                    served.notify_all()
                i += F1_CLIENTS
        except Exception as exc:        # reported below, never passed over
            errors.append(exc)

    def writer():
        try:
            for r in range(f1_rounds):
                with served:
                    mark = count[0]
                    served.wait_for(lambda: count[0] >= mark + 2
                                    or errors, timeout=60)
                # the host table's DML under the cache lock, as the
                # reference's own probe serialises host work: only the
                # launches' plane reads race the replays
                with svc.cache._lock:
                    events.update_column(
                        "score", score_b if r % 2 == 0 else score_a)
        except Exception as exc:
            errors.append(exc)
        finally:
            stop.set()

    t0 = time.perf_counter()
    with ServingFrontend(svc, max_batch=8, deadline_s=0.005,
                         threaded=True, prefetch=True) as fe:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(F1_CLIENTS)]
        threads.append(threading.Thread(target=writer))
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        fe.drain()
    f1_s = time.perf_counter() - t0
    stats1 = svc.cache.staging_snapshot()
    replays = stats1["delta_stages"] - stats0["delta_stages"]
    if errors:
        raise SystemExit(f"F1: a thread raised {errors[0]!r}")
    if torn or not replays or not (seen["A"] and seen["B"]):
        raise SystemExit(f"F1: {len(torn)} responses neither A's nor B's; "
                         f"A {seen['A']}, B {seen['B']}, replays {replays}")
    out["f1"] = dict(queries=len(fqs), rounds=f1_rounds, responses=dict(seen),
                     replays=replays, prefetch_stages=(
                         stats1["prefetch_stages"]
                         - stats0["prefetch_stages"]),
                     s=f1_s, latency=svc.fleet_summary()["latency"])
    log(f"[answers] {card}: (e) ServingFrontend(threaded, prefetch) fed "
        f"{len(fqs)} filters reading score from {F1_CLIENTS} threads while "
        f"a fifth alternated update_column('score', A / B) {f1_rounds} "
        f"times: {seen['A'] + seen['B']} responses, {seen['A']} equal to "
        f"version A's verdicts and {seen['B']} to B's, none torn; "
        f"{replays} replays, {out['f1']['prefetch_stages']} prefetch "
        f"stages, in {f1_s:.1f} s")
    out["launches"] = {t: fn.launches for t, fn in kernel_of.items()}
    if not all(out["launches"].values()):
        raise SystemExit(f"phase 8: kernel launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: LM serving at full width
# ---------------------------------------------------------------------------
# GLM-4-9B at its published widths, all 40 layers, bf16, random weights
# from --seed: the dense family's served path (prefill through the flash
# kernel, decode through the cache) under the Generator and the
# ContinuousBatcher.

LM_ARCH = "glm4-9b"
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate

# Agreement bounds of phase 5, each on max |a - b| / max |b| over every
# compared logit (b the reference side):
#  (b) the kernel against its plain version at each layer's q, k, v of the
#      served bf16 prefill: ``FLASH_TOL["bfloat16"]``, rtol and atol, the
#      JAX package's bound; only the f32 sums' order differs;
#  (c) served (bf16 weights, activations and cache, the kernel) against
#      the f32 forward from the same weights: 1e-1.  bf16 keeps 8
#      significant bits; the residual stream is rounded to it at each of
#      the 80 residual adds, where one bf16 step of the growing stream is
#      far above most of the update added to it, and the logits are
#      rounded once more.  Seed 0 leaves 4.5e-2 on an H100 (PERF.md);
#      serving in fp8 (e4m3, 4 significant bits) leaves ~0.5, and the
#      phase checks that its fp8 control (weights and residual stream in
#      e4m3) fails the bound;
#  (d), (e): the served path with the plain attention in place of the
#      kernel, and the batcher against the Generator fed the same tokens
#      (decode at B = 1 against the batcher's 4 slots), are two more bf16
#      serving runs, held to (c)'s bound.  Only attention's summation
#      order, or the decode batch, differs, but where that moves a bf16
#      value by a step the random 40-layer model grows the step as it
#      grows (c)'s roundings: (d) logs, layer by layer, how far its
#      prefill's q and attention output have moved from the kernel run's
#      (layer 0's q is the same in both, and is checked to be), and (b)
#      is the tight check of the kernel in the template that serves.
SERVE_VS_F32_TOL = 1e-1

def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f64."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def rms_err(got, want) -> float:
    """|got - want| / |want| in the 2-norm, in f64: how much of ``want``
    has moved, where ``rel_err`` is set by the one element that moved
    most."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def fp8_round(t):
    """``t`` rounded to fp8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), back in f32; vectors (the norms' weights)
    stay as they are."""
    import torch
    t = t.float()
    if t.dim() < 2:
        return t
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def reference_logits(params, cfg, tokens, first: int, weight, act=None,
                     routes=None, same=None):
    """f32 logits [B, T - first, V] at positions first .. T - 1 of
    ``tokens`` [B, T]: the full forward with no cache and no kernel, each
    layer's weights taken through ``weight`` one layer at a time, the
    residual stream through ``act`` after the embedding and each residual
    add (f32 and nothing, or the fp8 control: ``fp8_round`` for both),
    attention one sequence at a time (the plain version in f32 over
    [H, T, T] scores).  A MoE config's FFN is ``moe_reference`` on
    ``routes[i]``, layer i's served (idx, keep) [B, T, k]; with ``same`` a
    list, each layer appends the share of served routes its own router
    would choose too."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models.model import _unembed_matrix, layer_params
    from repro_torch.models.sharding import tree_map

    B, T = tokens.shape
    dev = tokens.device
    act = act or (lambda t: t)
    with torch.no_grad():
        x = act(weight(params["embed"])[tokens])
        positions = torch.arange(T, device=dev)[None, :]
        for i in range(cfg.n_layers):
            lp = tree_map(weight, layer_params(params, i))
            q, k, v = L.qkv_project(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                    positions)
            k = L._expand_kv(k, cfg.n_heads)
            v = L._expand_kv(v, cfg.n_heads)
            o = torch.empty_like(q)
            for b in range(B):
                hm = [t[b].transpose(0, 1).contiguous() for t in (q, k, v)]
                o[b] = ref.flash_attention_ref(*hm, causal=True).transpose(0, 1)
            x = act(x + L._mm("bshk,hkd->bsd", o, lp["attn"]["wo"]))
            xn = L.rmsnorm(x, lp["ln2"])
            if cfg.family == "moe":
                f = moe_reference(lp["ffn"], xn, *routes[i], cfg, same)
            else:
                f = L.mlp(lp["ffn"], xn, cfg)
            x = act(x + f)
            del lp, q, k, v, o, xn, f
        hidden = L.rmsnorm(x[:, first:], weight(params["final_norm"]))
        W = weight(_unembed_matrix(params))
        logits = L._mm("bsd,vd->bsv", hidden, W)
        if W.shape[0] > cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
    return logits


def moe_reference(p, x, idx, keep, cfg, same=None):
    """The MoE FFN on ``x`` [B, T, d] in its dtype (f32) with the served
    routes: each token's experts ``idx`` [B, T, k] and which of its slots
    the served dispatch kept (``keep``), the combine weights recomputed
    from this router's own probabilities at those experts and
    renormalised over all k, as the dispatch does; each expert's kept
    tokens in one product.  With ``same`` a list, appends the share of the
    served routes that this router's own top k holds."""
    import torch

    from repro_torch.models import layers
    B, T, d = x.shape
    k = cfg.experts_per_tok
    xt = x.reshape(B * T, d)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    idx, keep = idx.reshape(B * T, k), keep.reshape(B * T, k)
    w = probs.gather(1, idx)
    w = (w / w.sum(-1, keepdim=True)) * keep
    if same is not None:
        own = torch.topk(probs, k, dim=-1).indices
        same.append(float((idx[:, :, None] == own[:, None, :]).any(-1)
                          .float().mean()))
    flat_e = idx.reshape(-1)
    tok = torch.arange(B * T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    bounds = torch.searchsorted(flat_e[order], torch.arange(
        cfg.n_experts + 1, device=x.device)).tolist()
    act = layers.activation(cfg)
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        sl = order[bounds[e]:bounds[e + 1]]
        if len(sl):
            xe = xt[tok[sl]]
            h = act(xe @ p["wg"][e]) * (xe @ p["wu"][e])
            y.index_add_(0, tok[sl], (h @ p["wd"][e]) * w.reshape(-1)[sl, None])
    return y.view(B, T, d)


def recording(model, logits, forced=None):
    """``model`` with its prefill and decode steps appending the logits
    they return to the list ``logits``; with ``forced`` [B, steps], decode
    step i is fed ``forced[:, i]`` in place of the caller's token (teacher
    forcing)."""
    import torch
    fed = []

    def prefill(params, batch, max_seq):
        out, cache = model.prefill_fn(params, batch, max_seq)
        logits.append(out)
        return out, cache

    def decode(params, cache, tok, position):
        if forced is not None:
            tok = torch.as_tensor(np.asarray(forced)[:, len(fed):len(fed) + 1],
                                  device=tok.device)
            fed.append(tok)
        out, cache = model.decode_fn(params, cache, tok, position)
        logits.append(out)
        return out, cache

    return model._replace(prefill_fn=prefill, decode_fn=decode)


def recording_batcher(model, params, **kw):
    """A ``ContinuousBatcher`` and a dict that its model fills with, for
    each request id, the logits [V] that chose each of its tokens: the k-th
    prefill is request k (ids count up from 0 at submit and the queue is
    first in, first out), and row s of a decode step is the request that
    held slot s when the step ran."""
    from repro_torch.serve.batcher import ContinuousBatcher
    seen = {}

    def prefill(params, batch, max_seq):
        out, kv = model.prefill_fn(params, batch, max_seq)
        seen[len(seen)] = [out[0]]
        return out, kv

    def decode(params, cache, tok, position):
        out, cache = model.decode_fn(params, cache, tok, position)
        for slot, req in enumerate(batcher.slot_req):
            if req is not None:
                seen[req.rid].append(out[slot])
        return out, cache

    batcher = ContinuousBatcher(
        model._replace(prefill_fn=prefill, decode_fn=decode), params, **kw)
    return batcher, seen


class swapped:
    """``with swapped(module, name, fn):`` ``module.name`` is ``fn`` (code
    that looks it up at each call sees it)."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self.real

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def attention_as(fn) -> swapped:
    """``with attention_as(fn):`` the layers call ``fn`` in place of
    ``ops.flash_attention`` (they look it up on ``ops`` at each call)."""
    from repro_torch.kernels import ops
    return swapped(ops, "flash_attention", fn)


def teacher_forced_err(model, params, max_seq: int, finished, seen, rids,
                       reqs, V: int, dev) -> float:
    """Largest ``rel_err`` of a finished request's batcher logits
    (``seen``) against a ``Generator`` fed the same prompt and tokens (one
    request at a time)."""
    import torch

    from repro_torch.serve.serve_step import Generator
    err = 0.0
    for rid, p in zip(rids, reqs):
        out = finished[rid].out
        lg = []
        Generator(recording(model, lg, forced=np.asarray(out[:-1])[None, :]),
                  params, max_seq=max_seq, device=dev).generate(
            p[None, :], len(out) - 1)
        err = max(err, rel_err(torch.stack(seen[rid])[:, :V],
                               torch.stack(lg, dim=1)[0, :, :V]))
    return err


def flash_bound(BH: int, Sq: int, Sk: int, D: int, causal: bool,
                elem: int):
    """(bound_ms, bound_by) of one attention call: 4 D operations a live
    (query, key) pair on the bf16 tensor-core rate, against q, k, v and o
    read or written once."""
    if causal:
        live = sum(min(i, Sk - 1) + 1 for i in range(Sq))
    else:
        live = Sq * Sk
    ops_n = 4 * D * live * BH
    nbytes = elem * BH * D * (2 * Sq + 2 * Sk)
    tb, to = nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations"), ops_n


def phase_lm(seed: int, card: str, dev, cfg=None, B: int = 4, S: int = 2048,
             steps: int = 16, n_req: int = 8, req_len=(128, 1024),
             max_new: int = 16, n_slots: int = 4) -> dict:
    """Phase 5: GLM-4-9B served at full width (``cfg`` None) through the
    ``Generator`` (``B`` prompts of ``S`` tokens, ``steps`` greedy steps)
    and the ``ContinuousBatcher`` (``n_req`` prompts of ``req_len``
    tokens, ``max_new`` each, ``n_slots`` slots), with checks (a)-(e)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import template
    from repro_torch.models import build_model
    from repro_torch.models.sharding import init_params, tree_bytes
    from repro_torch.serve.serve_step import Generator

    # the f32 reference in full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(LM_ARCH)
    held_before = torch.cuda.memory_allocated(dev)      # earlier phases'
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(model.specs, gen, device=dev)
    sync(dev)
    weight_bytes = tree_bytes(params)
    n_params = weight_bytes // 2                          # bf16
    log(f"[lm] {card}: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, head dim "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
        f"{n_params:,} parameters, {weight_bytes:,} bytes in bf16, made "
        f"from seed {seed} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, S))
    seen = []              # the logits the Generator's model returns
    generator = Generator(recording(model, seen), params, max_seq=S + steps,
                          device=dev)
    generator.generate(prompts[:, :64], steps=2)          # warm-up
    fa = ops.flash_attention
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: the Generator's prefill and greedy decode, then the
    # batcher, each with the kernel's count set to 0 just before
    out = {}
    seen.clear()
    fa.launches = 0
    total_ms = host_ms(lambda: out.update(toks=generator.generate(
        prompts, steps)), dev)
    gen_launches = fa.launches
    toks = out.pop("toks")
    served = torch.stack(seen, dim=1)           # [B, steps + 1, V]
    seen.clear()
    peak_serving = torch.cuda.max_memory_allocated(dev) - held_before
    if gen_launches != cfg.n_layers:
        raise SystemExit(f"(a) the Generator's prefill launched "
                         f"flash_attention {gen_launches} times, expected "
                         f"{cfg.n_layers}")
    if tuple(served.shape) != (B, steps + 1, cfg.padded_vocab) or not bool(
            torch.isfinite(served[..., :cfg.vocab]).all()):
        raise SystemExit(f"served logits {tuple(served.shape)} not finite "
                         f"or not of the expected shape")

    lens = rng.integers(req_len[0], req_len[1] + 1, n_req)
    reqs = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    max_seq_b = -(-(req_len[1] + max_new + 1) // 64) * 64
    batcher, seen_b = recording_batcher(model, params, n_slots=n_slots,
                                        max_seq=max_seq_b)
    rids = [batcher.submit(p, max_new=max_new) for p in reqs]
    fa.launches = 0
    batch_ms = host_ms(batcher.run, dev)
    batch_launches = fa.launches
    if batch_launches != n_req * cfg.n_layers:
        raise SystemExit(f"(a) the batcher launched flash_attention "
                         f"{batch_launches} times for {n_req} prefills, "
                         f"expected {n_req * cfg.n_layers}")
    if any(len(batcher.finished[r].out) != max_new for r in rids):
        raise SystemExit("the batcher ended a request early")
    log(f"[lm] {card}: (a) flash_attention launched {gen_launches} times in "
        f"the Generator's prefill and {batch_launches} in the batcher's "
        f"{n_req} prefills ({cfg.n_layers} layers)")

    # prefill alone, for the split of the Generator's time
    fa.launches = 0
    prefill_ms = host_ms(lambda: generator.generate(prompts, 0), dev)
    seen.clear()
    if fa.launches != cfg.n_layers:
        raise SystemExit(f"(a) the prefill alone launched flash_attention "
                         f"{fa.launches} times")
    decode_ms = (total_ms - prefill_ms) / steps
    kv_bytes = sum(int(np.prod(c.shape)) * 2 for c in model.init_cache(
        B, S + steps).values())

    # (b) the kernel against its plain version at every layer's q, k, v of
    # the served prefill; the kernel's output goes on, so each layer sees
    # what serving gives it.  Each layer's q and output are kept for (d),
    # layer 0's k and v too, for the timing.
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    kept, err_b = [], []

    def checked(q, k, v, causal=True):
        o = fa(q, k, v, causal=causal)
        err_b.append(require_close(
            "flash_attention", o,
            ref.flash_attention_ref(q, k, v, causal=causal),
            FLASH_TOL["bfloat16"], f"layer {len(err_b)}'s served prefill"))
        kept.append((q, o, k, v) if not kept else (q, o))
        return o

    with attention_as(checked):
        generator.generate(prompts, 0)
    seen.clear()
    if len(err_b) != cfg.n_layers:
        raise SystemExit(f"(b) the served prefill called attention "
                         f"{len(err_b)} times, expected {cfg.n_layers}")
    with torch.no_grad():
        qh, _, kh, vh = kept[0]
        kept[0] = kept[0][:2]
        q4, k4, v4 = (t.view(B, H, S, Dh) for t in (qh, kh, vh))
        k_ms = cuda_ms(lambda: fa(qh, kh, vh, causal=True), 5)
        p_ms = cuda_ms(lambda: ref.flash_attention_ref(qh, kh, vh,
                                                       causal=True), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
        del qh, kh, vh, q4, k4, v4
    bms, bby, fl_ops = flash_bound(B * H, S, S, Dh, True, 2)
    used = template(torch.bfloat16, Dh)
    log(f"[lm] {card}: (b) flash_attention ({used}) at each of the "
        f"{cfg.n_layers} layers' q, k, v of the served prefill [BH={B * H}, "
        f"S={S}, D={Dh}] bf16 causal: kernel == plain version within "
        f"{FLASH_TOL['bfloat16']} (max abs err {max(err_b):.3g}, layer 0 "
        f"{err_b[0]:.3g}); at layer 0's: {k_ms:.3f} ms vs bound "
        f"{bms:.4f} ms ({bby}: {fl_ops:.3g} operations, "
        f"{fl_ops / (k_ms * 1e9):.2f} TFLOP/s), plain version {p_ms:.3f} ms, "
        f"SDPA {lib_ms:.3f} ms")

    # (c) served logits against the f32 forward, and the fp8 control
    seq = torch.cat([torch.as_tensor(prompts, device=dev),
                     torch.as_tensor(toks, device=dev)], dim=1)
    t0 = time.perf_counter()
    want = reference_logits(params, cfg, seq, S - 1, lambda w: w.float())
    ref_s = time.perf_counter() - t0
    err_c = rel_err(served[..., :cfg.vocab], want[..., :cfg.vocab])
    fp8 = reference_logits(params, cfg, seq, S - 1, fp8_round, fp8_round)
    err_fp8 = rel_err(fp8[..., :cfg.vocab], want[..., :cfg.vocab])
    del fp8
    per_pos = [rel_err(served[:, j, :cfg.vocab], want[:, j, :cfg.vocab])
               for j in range(steps + 1)]
    log(f"[lm] {card}: (c) served bf16 logits vs the f32 forward at "
        f"{B} x {steps + 1} positions: {err_c:.3e} of max |logit| "
        f"{float(want[..., :cfg.vocab].abs().max()):.3f} (bound "
        f"{SERVE_VS_F32_TOL}; prefill {per_pos[0]:.3e}, worst step "
        f"{max(per_pos[1:] or [0.0]):.3e}); fp8 control (e4m3 weights "
        f"and residual stream) {err_fp8:.3e}; "
        f"the f32 forward took {ref_s:.1f} s")
    del want

    # (d) the served path with the plain attention in place of the kernel,
    # fed the same tokens; at each layer of its prefill, how far q and the
    # attention output have moved from the kernel run's
    V = cfg.vocab
    drift = []

    def plain(q, k, v, causal=True):
        o = ref.flash_attention_ref(q, k, v, causal=causal)
        q0, o0 = kept[len(drift)]
        drift.append((rel_err(q, q0), rms_err(q, q0), rel_err(o, o0)))
        return o

    lg_d = []
    with attention_as(plain):
        Generator(recording(model, lg_d, forced=toks), params,
                  max_seq=S + steps, device=dev).generate(prompts, steps)
    del kept
    err_d = rel_err(torch.stack(lg_d, dim=1)[..., :V], served[..., :V])
    del lg_d
    if len(drift) != cfg.n_layers or drift[0][0] != 0.0:
        raise SystemExit(f"(d) the plain run's prefill called attention "
                         f"{len(drift)} times, and its layer 0 q differs "
                         f"from the kernel run's by {drift[0][0]:.3e}")
    # (e) each request's batcher logits against the Generator fed its
    # prompt and tokens
    err_e = teacher_forced_err(model, params, max_seq_b, batcher.finished,
                               seen_b, rids, reqs, V, dev)
    shown = sorted({1, 2, 4, 8, 16, 32, cfg.n_layers - 1} &
                   set(range(1, cfg.n_layers)))
    log(f"[lm] {card}: (d) plain attention in place of the kernel: "
        f"{err_d:.3e} of max |logit|; its prefill against the kernel "
        f"run's, q at layer " + ", ".join(
            f"{i} {drift[i][0]:.2e} / {drift[i][1]:.2e}" for i in shown) +
        f" (of max |q| / in the 2-norm); attention output at layer 0 "
        f"{drift[0][2]:.2e}, {cfg.n_layers - 1} {drift[-1][2]:.2e} of max "
        f"|o|; (e) "
        f"batcher vs teacher-forced Generator over {n_req} requests x "
        f"{max_new} tokens: {err_e:.3e} (bounds {SERVE_VS_F32_TOL})")

    gen_tok_s = B * steps / ((total_ms - prefill_ms) / 1e3)
    log(f"[lm] {card}: Generator B={B}: prefill {prefill_ms:.1f} ms "
        f"({B * S / (prefill_ms / 1e3):.0f} tokens/s), decode "
        f"{decode_ms:.2f} ms a step ({gen_tok_s:.1f} tokens/s), {steps} "
        f"steps in {total_ms:.1f} ms; batcher {n_req} requests "
        f"({int(lens.sum())} prompt tokens, {n_req * max_new} generated, "
        f"{n_slots} slots) in {batch_ms:.1f} ms, "
        f"{n_req / (batch_ms / 1e3):.2f} requests/s; weights "
        f"{weight_bytes:,} bytes, KV cache {kv_bytes:,} bytes, peak "
        f"allocated while serving {peak_serving:,} bytes (above the "
        f"{held_before:,} that earlier phases still held)")
    failed = [name for name, e in (("(c)", err_c), ("(d)", err_d),
                                   ("(e)", err_e))
              if not e <= SERVE_VS_F32_TOL]
    if not err_fp8 > SERVE_VS_F32_TOL:
        failed.append("(c) fp8 control inside the bound")
    if failed:
        raise SystemExit(f"phase 5 failed {failed}")
    return dict(
        arch=cfg.name, layers=cfg.n_layers, params=n_params,
        weight_bytes=weight_bytes, kv_cache_bytes=kv_bytes,
        peak_serving_bytes=peak_serving, prefill_ms=prefill_ms,
        prefill_tokens_per_s=B * S / (prefill_ms / 1e3),
        decode_ms_per_step=decode_ms, decode_tokens_per_s=gen_tok_s,
        generate_ms=total_ms, batcher_ms=batch_ms,
        requests_per_s=n_req / (batch_ms / 1e3),
        batcher_prompt_tokens=int(lens.sum()),
        err_served_vs_f32=err_c, err_fp8_control=err_fp8,
        err_served_by_position=per_pos, err_plain_vs_kernel=err_d,
        err_batcher_vs_generator=err_e, err_kernel_by_layer=err_b,
        drift_q_by_layer=[d[0] for d in drift],
        drift_q_rms_by_layer=[d[1] for d in drift],
        drift_o_by_layer=[d[2] for d in drift],
        reference_s=ref_s,
        launches=dict(generator=gen_launches, batcher=batch_launches),
        kernels={"flash_attention": dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bms,
            bound_by=bby, max_abs_err=max(err_b),
            launches=gen_launches + batch_launches, template=used,
            tflop_s=fl_ops / (k_ms * 1e9),
            shape=dict(BH=B * H, S=S, D=Dh, dtype="bfloat16", causal=True))})


# ---------------------------------------------------------------------------
# Phase 9: the MoE family at full width
# ---------------------------------------------------------------------------
# Qwen3-MoE-30B-A3B at the repo's widths, all 48 layers, bf16, random
# weights from --seed, served with phase 5's traffic.  Capacity is per
# dispatch (C = ceil(T * 8 * 1.25 / 128)): a prefill chunk of 4 x 256
# tokens keeps 80 slots an expert, a 4-slot decode step 1 (two slots that
# pick one expert: the later is dropped), a decode step at B = 1 drops
# nothing.  A run that dispatches other tokens together is another
# computation, so (c)-(e) hold the served run to references that route
# and drop as it did.

MOE_ARCH = "qwen3-moe-30b-a3b"

# Agreement bounds of phase 9, each on max |a - b| / max |b| (b the
# reference side):
#  (b) ``FLASH_TOL["bfloat16"]``, as phase 5;
#  (c) served bf16 logits against the f32 forward given the served routes
#      and keep mask (its combine weights from its own f32 router at those
#      experts): MOE_VS_F32_TOL = 5e-2.  With the routes fixed only bf16's
#      roundings differ, as in phase 5, over 96 residual adds of a narrower
#      stream (d_model 2,048): seed 0 leaves 1.38e-2 on an H100 (PERF.md),
#      3.6x below the bound, and the fp8 control (e4m3 weights and
#      residual stream, the same routes) 0.226, 4.5x above it, which the
#      phase checks;
#  (d) the served path with the plain attention in place of the kernel,
#      given the served routes: MOE_VS_F32_TOL, as (c) (only attention's
#      summation order differs, grown through 48 bf16 layers as (c)'s
#      roundings are; seed 0: 1.31e-2); its run with its own routes is
#      logged, not held (a route flipped by a bf16 step moves a token's
#      FFN output by a whole expert's share: 4.9e-2 at seed 0);
#  (e) the batcher against a replay of its own decode inputs (the same
#      [4, 1] tokens and positions, idle slots included, each slot's cache
#      prefilled by the replay itself): MOE_REPLAY_TOL = 0, the same
#      kernels on the same inputs in the same order, so any difference is
#      the batcher's slot bookkeeping.
MOE_VS_F32_TOL = 5e-2
MOE_REPLAY_TOL = 0.0


class RouteTape:
    """``with RouteTape() as tape:`` records the experts of every MoE
    dispatch the served path runs (``moe.route``'s idx, as [T, k]) in call
    order; with ``replay`` (such a list), call n routes to the n-th
    recorded idx instead, its weights from its own router at those experts,
    and ``flips()`` counts the slots its own top k would have put
    elsewhere."""

    def __init__(self, replay=None):
        self.replay = replay
        self.calls, self._flips = [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = moe.route

        def route(p, x, cfg):
            probs, w, idx = self.orig(p, x, cfg)
            if self.replay is not None:
                want = self.replay[len(self.calls)].view(idx.shape)
                self._flips.append(
                    (want[..., :, None] != idx[..., None, :]).all(-1).sum())
                w = probs.gather(-1, want)
                w, idx = (w / w.sum(-1, keepdim=True)).to(x.dtype), want
            self.calls.append(idx.reshape(-1, cfg.experts_per_tok))
            return probs, w, idx

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.orig

    def flips(self) -> int:
        return int(sum(int(f) for f in self._flips))


def dispatch_drops(calls, cfg) -> list:
    """Dropped slots of each recorded dispatch (idx [T, k], capacity from
    its T)."""
    from repro_torch.models import moe
    return [int((~moe.kept_slots(ix, moe.capacity(ix.shape[0], cfg))).sum())
            for ix in calls]


def served_routes(calls, cfg, B: int, S: int, steps: int):
    """Per layer, (idx, keep) [B, S + steps, k] of a ``Generator`` run
    (prefill of S tokens, then ``steps`` decode steps) from its tape: the
    prefill's dispatches are layer-major, chunk by chunk along S, then
    each decode step's one a layer."""
    import torch

    from repro_torch.models import moe
    L, k, c = cfg.n_layers, cfg.experts_per_tok, cfg.moe_seq_chunk
    nc = S // c if S > c and S % c == 0 else 1
    if len(calls) != L * (nc + steps):
        raise SystemExit(f"the served run made {len(calls)} MoE dispatches, "
                         f"expected {L * (nc + steps)}")
    keeps = [moe.kept_slots(ix, moe.capacity(ix.shape[0], cfg))
             for ix in calls]
    out = []
    for i in range(L):
        at = [i * nc + j for j in range(nc)]
        at += [L * nc + t * L + i for t in range(steps)]
        out.append(tuple(torch.cat([t[a].view(B, -1, k) for a in at], dim=1)
                         for t in (calls, keeps)))
    return out


def moe_batcher(model, params, **kw):
    """A ``ContinuousBatcher`` and the list its model fills with each
    decode step's inputs and output: (tokens [n_slots, 1], positions,
    the request id of each slot or None, logits)."""
    from repro_torch.serve.batcher import ContinuousBatcher
    tape = []

    def decode(params, cache, tok, position):
        out, cache = model.decode_fn(params, cache, tok, position)
        tape.append((tok, position, tuple(
            None if r is None else r.rid for r in batcher.slot_req), out))
        return out, cache

    batcher = ContinuousBatcher(model._replace(decode_fn=decode), params,
                                **kw)
    return batcher, tape


def batcher_replay(model, params, tape, prompts, n_slots: int, max_seq: int,
                   V: int, dev):
    """(largest ``rel_err`` of the batcher's decode logits against a replay
    of its decode inputs, problems): the replay prefills each request into
    its slot of a cache of its own when the tape first shows it there, and
    checks each step's inputs (an idle slot feeds token 0 at position 0, a
    new request the argmax of its prefill at its prompt's length, a held
    one the argmax of its previous step one position on)."""
    import torch

    from repro_torch.models.model import alloc_cache
    cache = alloc_cache(model.init_cache(n_slots, max_seq), dev)
    held, want = [None] * n_slots, [None] * n_slots
    err, problems = 0.0, []
    for j, (tok, pos, rids, logits) in enumerate(tape):
        tok_h, pos_h = tok[:, 0].tolist(), pos.tolist()
        for s, r in enumerate(rids):
            if r is None:
                exp = (0, 0)
            elif r != held[s]:
                lg, kv = model.prefill_fn(params, {"tokens": torch.as_tensor(
                    prompts[r][None, :], device=dev)}, max_seq)
                for name, c in cache.items():
                    c[:, s:s + 1] = kv[name]
                exp = (int(torch.argmax(lg[0, :V])), len(prompts[r]))
            else:
                exp = want[s]
            held[s] = r
            if (tok_h[s], pos_h[s]) != exp:
                problems.append(f"step {j} slot {s}: fed {tok_h[s]} at "
                                f"{pos_h[s]}, expected {exp}")
        out, cache = model.decode_fn(params, cache, tok, pos)
        active = [s for s, r in enumerate(rids) if r is not None]
        err = max(err, rel_err(out[active, :V], logits[active, :V]))
        nxt = torch.argmax(logits[:, :V], dim=-1).tolist()
        want = [(nxt[s], pos_h[s] + 1) for s in range(n_slots)]
    return err, problems


def phase_moe(seed: int, card: str, dev, cfg=None, B: int = 4, S: int = 2048,
              steps: int = 16, n_req: int = 8, req_len=(128, 1024),
              max_new: int = 16, n_slots: int = 4, solo=(128, 8)) -> dict:
    """Phase 9: Qwen3-MoE-30B-A3B served at full width (``cfg`` None) with
    phase 5's traffic (the ``Generator`` on ``B`` prompts of ``S`` tokens,
    ``steps`` greedy steps; the ``ContinuousBatcher`` on ``n_req`` prompts
    of ``req_len`` tokens, ``max_new`` each, ``n_slots`` slots), a ``B`` =
    1 ``Generator`` run (``solo``: prompt length, steps) whose decode drops
    nothing, and checks (a)-(e)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model, moe
    from repro_torch.models.sharding import init_params, tree_bytes
    from repro_torch.serve.serve_step import Generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(MOE_ARCH)
    t_phase = time.perf_counter()
    held_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(model.specs, gen, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(params)
    ffn = params["layers"]["ffn"]
    expert_bytes = sum(tree_bytes(ffn[n]) for n in ("wg", "wu", "wd"))
    log(f"[moe] {card}: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, head dim "
        f"{cfg.resolved_head_dim}), {cfg.n_experts} experts top-"
        f"{cfg.experts_per_tok}, expert d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
        f"param_count() {cfg.param_count():,} ({2 * cfg.param_count():,} "
        f"bytes in bf16); {weight_bytes:,} bytes of weights with the final "
        f"norm, {expert_bytes:,} of them experts, made from seed {seed} in "
        f"{init_s:.1f} s; {held_before:,} bytes allocated before the init, "
        f"{torch.cuda.memory_allocated(dev):,} after")

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, S))
    seen = []
    generator = Generator(recording(model, seen), params, max_seq=S + steps,
                          device=dev)
    generator.generate(prompts[:, :64], steps=2)          # warm-up
    seen.clear()
    fa = ops.flash_attention
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path, with the kernel's count set to 0 just before each run
    out = {}
    fa.launches = 0
    with RouteTape() as tape:
        total_ms = host_ms(lambda: out.update(toks=generator.generate(
            prompts, steps)), dev)
    gen_launches = fa.launches
    toks = out.pop("toks")
    served = torch.stack(seen, dim=1)
    seen.clear()
    peak_serving = torch.cuda.max_memory_allocated(dev) - held_before
    if gen_launches != cfg.n_layers:
        raise SystemExit(f"(a) the Generator's prefill launched "
                         f"flash_attention {gen_launches} times, expected "
                         f"{cfg.n_layers}")
    if tuple(served.shape) != (B, steps + 1, cfg.padded_vocab) or not bool(
            torch.isfinite(served[..., :cfg.vocab]).all()):
        raise SystemExit("served logits not finite or not of the expected "
                         "shape")
    routes = served_routes(tape.calls, cfg, B, S, steps)
    drops = dispatch_drops(tape.calls, cfg)
    L = cfg.n_layers
    nc = len(tape.calls) // L - steps
    chunk_drops = [sum(drops[i * nc + j] for i in range(L))
                   for j in range(nc)]
    step_drops = [sum(drops[L * nc + t * L:L * nc + (t + 1) * L])
                  for t in range(steps)]
    used = []              # experts with a kept slot, a decode step
    for t in range(steps):
        used.append(sum(int(torch.unique(routes[i][0][:, S + t][
            routes[i][1][:, S + t]]).numel()) for i in range(L)))

    lens = rng.integers(req_len[0], req_len[1] + 1, n_req)
    reqs = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    max_seq_b = -(-(req_len[1] + max_new + 1) // 64) * 64
    batcher, btape = moe_batcher(model, params, n_slots=n_slots,
                                 max_seq=max_seq_b)
    rids = [batcher.submit(p, max_new=max_new) for p in reqs]
    fa.launches = 0
    with RouteTape() as bt:
        batch_ms = host_ms(batcher.run, dev)
    batch_launches = fa.launches
    if batch_launches != n_req * L:
        raise SystemExit(f"(a) the batcher launched flash_attention "
                         f"{batch_launches} times for {n_req} prefills, "
                         f"expected {n_req * L}")
    if any(len(batcher.finished[r].out) != max_new for r in rids):
        raise SystemExit("the batcher ended a request early")
    bdrops = dispatch_drops(bt.calls, cfg)
    n_b = [ix.shape[0] for ix in bt.calls]
    b_step_drops = [sum(bdrops[a:a + L]) for a in range(0, len(bdrops), L)
                    if n_b[a] == n_slots]
    log(f"[moe] {card}: (a) flash_attention launched {gen_launches} times in "
        f"the Generator's prefill and {batch_launches} in the batcher's "
        f"{n_req} prefills ({L} layers)")

    fa.launches = 0
    prefill_ms = host_ms(lambda: generator.generate(prompts, 0), dev)
    seen.clear()
    if fa.launches != L:
        raise SystemExit(f"(a) the prefill alone launched flash_attention "
                         f"{fa.launches} times")
    decode_ms = (total_ms - prefill_ms) / steps

    # the same prompt alone: a decode step of one token drops no slot
    solo_lg = []
    with RouteTape() as st:
        Generator(recording(model, solo_lg), params, max_seq=solo[0] + solo[1],
                  device=dev).generate(prompts[:1, :solo[0]], solo[1])
    solo_drops = dispatch_drops(st.calls[L:], cfg)
    log(f"[moe] {card}: dropped slots: the Generator's prefill "
        f"{sum(chunk_drops):,} over {nc} chunks of {B} x {S // nc} tokens "
        f"(C = {moe.capacity(B * S // nc, cfg)}; by chunk {chunk_drops}), "
        f"its decode at B = {B} {sum(step_drops):,} over {steps} steps (C = "
        f"{moe.capacity(B, cfg)}; by step {step_drops}); the batcher's "
        f"{n_slots}-slot decode {sum(b_step_drops):,} over "
        f"{len(b_step_drops)} steps, its prefills {sum(bdrops) - sum(b_step_drops):,}; "
        f"B = 1 decode {sum(solo_drops)} over {solo[1]} steps")

    # (b) the kernel against its plain version at every layer's q, k, v
    err_b = []

    def checked(q, k, v, causal=True):
        o = fa(q, k, v, causal=causal)
        err_b.append(require_close(
            "flash_attention", o,
            ref.flash_attention_ref(q, k, v, causal=causal),
            FLASH_TOL["bfloat16"], f"layer {len(err_b)} of the MoE prefill"))
        return o

    with attention_as(checked), RouteTape(replay=tape.calls):
        generator.generate(prompts, 0)
    seen.clear()
    if len(err_b) != L:
        raise SystemExit(f"(b) the served prefill called attention "
                         f"{len(err_b)} times, expected {L}")
    log(f"[moe] {card}: (b) flash_attention at each of the {L} layers' q, "
        f"k, v of the served prefill [BH={B * cfg.n_heads}, S={S}, "
        f"D={cfg.resolved_head_dim}] bf16 causal: kernel == plain version "
        f"within {FLASH_TOL['bfloat16']} (max abs err {max(err_b):.3g})")

    # (c) served logits against the f32 forward on the served routes, and
    # the fp8 control on the same routes
    V = cfg.vocab
    seq = torch.cat([torch.as_tensor(prompts, device=dev),
                     torch.as_tensor(toks, device=dev)], dim=1)
    same = []
    t0 = time.perf_counter()
    want = reference_logits(params, cfg, seq, S - 1, lambda w: w.float(),
                            routes=routes, same=same)
    ref_s = time.perf_counter() - t0
    err_c = rel_err(served[..., :V], want[..., :V])
    per_pos = [rel_err(served[:, j, :V], want[:, j, :V])
               for j in range(steps + 1)]
    fp8 = reference_logits(params, cfg, seq, S - 1, fp8_round, fp8_round,
                           routes=routes)
    err_fp8 = rel_err(fp8[..., :V], want[..., :V])
    del fp8
    log(f"[moe] {card}: (c) served bf16 logits vs the f32 forward on the "
        f"served routes at {B} x {steps + 1} positions: {err_c:.3e} of max "
        f"|logit| {float(want[..., :V].abs().max()):.3f} (bound "
        f"{MOE_VS_F32_TOL}; prefill {per_pos[0]:.3e}, worst step "
        f"{max(per_pos[1:] or [0.0]):.3e}); fp8 control {err_fp8:.3e}; the "
        f"f32 router chooses {statistics.fmean(same):.4f} of the served "
        f"routes too (layer 0 {same[0]:.4f}, layer {L - 1} {same[-1]:.4f}); "
        f"the f32 forward took {ref_s:.1f} s")
    del want

    # (d) the plain attention in place of the kernel, on the served routes,
    # then with its own
    lg_d, lg_f = [], []
    with attention_as(ref.flash_attention_ref), \
            RouteTape(replay=tape.calls) as dt:
        Generator(recording(model, lg_d, forced=toks), params,
                  max_seq=S + steps, device=dev).generate(prompts, steps)
    err_d = rel_err(torch.stack(lg_d, dim=1)[..., :V], served[..., :V])
    del lg_d
    with attention_as(ref.flash_attention_ref):
        Generator(recording(model, lg_f, forced=toks), params,
                  max_seq=S + steps, device=dev).generate(prompts, steps)
    err_d_free = rel_err(torch.stack(lg_f, dim=1)[..., :V], served[..., :V])
    del lg_f

    # (e) the batcher against a replay of its own decode inputs
    err_e, problems = batcher_replay(model, params, btape, reqs, n_slots,
                                     max_seq_b, V, dev)
    log(f"[moe] {card}: (d) plain attention in place of the kernel on the "
        f"served routes: {err_d:.3e} of max |logit| (its own router would "
        f"move {dt.flips():,} of {sum(ix.numel() for ix in tape.calls):,} "
        f"slots); with its own routes {err_d_free:.3e} (logged, not held); "
        f"(e) the batcher's {len(btape)} decode steps against a replay of "
        f"their inputs: {err_e:.3e} (bound {MOE_REPLAY_TOL}), "
        f"{len(problems)} input problems")

    kv_bytes = sum(int(np.prod(c.shape)) * 2 for c in model.init_cache(
        B, S + steps).values())
    other = weight_bytes - expert_bytes - tree_bytes(params["embed"])
    kv_read = kv_bytes * (S + steps / 2) / (S + steps)
    per_expert = expert_bytes / (L * cfg.n_experts)
    dense_ms = (other + expert_bytes + kv_read) / HBM_BYTES_PER_S * 1e3
    used_ms = (other + statistics.fmean(used) * per_expert + kv_read) \
        / HBM_BYTES_PER_S * 1e3
    gen_tok_s = B * steps / ((total_ms - prefill_ms) / 1e3)
    phase_s = time.perf_counter() - t_phase
    log(f"[moe] {card}: Generator B={B}: prefill {prefill_ms:.1f} ms "
        f"({B * S / (prefill_ms / 1e3):.0f} tokens/s), decode "
        f"{decode_ms:.2f} ms a step ({gen_tok_s:.1f} tokens/s; bound "
        f"{dense_ms:.2f} ms reading every expert's weights, "
        f"{(other + expert_bytes) / 1e9:.2f} GB of weights a step, "
        f"{used_ms:.2f} ms reading the {statistics.fmean(used):.1f} experts "
        f"a step with a kept slot), {steps} steps in {total_ms:.1f} ms; "
        f"batcher {n_req} requests ({int(lens.sum())} prompt tokens, "
        f"{n_req * max_new} generated, {n_slots} slots) in {batch_ms:.1f} "
        f"ms, {n_req / (batch_ms / 1e3):.2f} requests/s; weights "
        f"{weight_bytes:,} bytes, KV cache {kv_bytes:,} bytes, peak allocated "
        f"while serving {peak_serving:,} bytes above the {held_before:,} "
        f"held before; phase 9 took {phase_s:.1f} s")

    failed = [name for name, e, tol in (
        ("(c)", err_c, MOE_VS_F32_TOL), ("(d)", err_d, MOE_VS_F32_TOL),
        ("(e)", err_e, MOE_REPLAY_TOL)) if not e <= tol]
    if not err_fp8 > MOE_VS_F32_TOL:
        failed.append("(c) fp8 control inside the bound")
    if problems:
        failed.append(f"(e) inputs: {problems[:4]}")
    if not sum(step_drops) > 0 or not sum(b_step_drops) > 0:
        failed.append("no slot dropped at 4 slots")
    if sum(solo_drops):
        failed.append(f"{sum(solo_drops)} slots dropped at B = 1")
    if failed:
        raise SystemExit(f"phase 9 failed {failed}")
    return dict(
        arch=cfg.name, layers=L, param_count=cfg.param_count(),
        weight_bytes=weight_bytes, expert_bytes=expert_bytes,
        held_before_bytes=held_before, init_s=init_s,
        kv_cache_bytes=kv_bytes, peak_serving_bytes=peak_serving,
        prefill_ms=prefill_ms,
        prefill_tokens_per_s=B * S / (prefill_ms / 1e3),
        decode_ms_per_step=decode_ms, decode_tokens_per_s=gen_tok_s,
        decode_bound_ms_all_experts=dense_ms,
        decode_bound_ms_used_experts=used_ms,
        used_experts_per_step=used, generate_ms=total_ms,
        batcher_ms=batch_ms, requests_per_s=n_req / (batch_ms / 1e3),
        drops=dict(prefill_chunks=chunk_drops, decode_steps=step_drops,
                   batcher_decode_steps=b_step_drops,
                   batcher_prefills=sum(bdrops) - sum(b_step_drops),
                   solo_decode=sum(solo_drops)),
        err_served_vs_f32=err_c, err_served_by_position=per_pos,
        err_fp8_control=err_fp8, f32_router_same_share=same,
        err_plain_vs_kernel=err_d, err_plain_free_routes=err_d_free,
        plain_route_flips=dt.flips(), err_batcher_vs_replay=err_e,
        err_kernel_by_layer=err_b, reference_s=ref_s, s=phase_s,
        launches=gen_launches + batch_launches,
        max_abs_err=max(err_b))


# ---------------------------------------------------------------------------
# Phase 10: the port's examples on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "fleet_serving", "resilient_serving",
            "streaming_ingest", "sublinear_pruning", "topk_serving",
            "pruned_pretraining")
# the examples run with a short argv (a fresh --ckpt-dir is added)
EXAMPLE_ARGV = {"pruned_pretraining": ["--steps", "4", "--batch", "2",
                                       "--seq", "32"]}
# left out of the comparison of an example's lines: wall times and
# speed-ups (the host clock), sampled tokens and training losses (the
# CPU's and the card's torch.Generator draw other numbers) and the
# checkpoint directory
EXAMPLE_NOT_COMPARED = (
    (r"flat\s+[\d.]+ ms\s+tree\s+[\d.]+ ms\s+\(\s*[\d.]+x,",
     "flat <ms> tree <ms> (<speed-up>,"),
    (r" in \d+ ms$", " in <ms>"),
    (r"sample: \[[\d, ]*\]", "sample: <tokens>"),
    (r"loss=[\d.]+ \([\d.]+s/step\)", "loss=<loss> (<s>/step)"),
    (r"first loss [\d.]+ -> last [\d.]+", "first loss <loss> -> last <loss>"),
    (r"checkpoint -> .*/step_", "checkpoint -> <dir>/step_"),
)


def example_lines(name: str, device: str):
    """(the lines example ``name`` prints on ``device``, with times,
    sampled tokens, losses and paths replaced by stand-ins; seconds it
    took)."""
    import contextlib
    import importlib.util
    import io
    import re
    import shutil
    import tempfile
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    tmp = tempfile.mkdtemp(prefix=f"{name}_")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            if name in EXAMPLE_ARGV:
                mod.main(EXAMPLE_ARGV[name] + ["--ckpt-dir", tmp],
                         device=device)
            else:
                mod.main(device=device)
    finally:
        shutil.rmtree(tmp)
    s = time.perf_counter() - t0
    lines = []
    for line in buf.getvalue().splitlines():
        for pat, stand_in in EXAMPLE_NOT_COMPARED:
            line = re.sub(pat, stand_in, line)
        lines.append(line)
    return lines, s


def phase_examples(card: str, dev) -> dict:
    """Phase 10: each of the port's seven examples run in process on the
    card (``main(device="cuda")``) and on the CPU; every printed count (
    partitions, bytes, hits, evictions, retries, curated shards,
    checkpoints, ...) must be the same."""
    out = {}
    for name in EXAMPLES:
        got, s_card = example_lines(name, dev.type)
        want, s_cpu = example_lines(name, "cpu")
        if got != want:
            diff = [(g, w) for g, w in zip(got, want) if g != w]
            raise SystemExit(f"phase 10: {name} on the card printed other "
                             f"counts than on the CPU ({len(got)} / "
                             f"{len(want)} lines): {diff[:3]}")
        log(f"[examples] {card}: {name}: {len(got)} lines, the same counts "
            f"on the card ({s_card:.1f} s) as on the CPU ({s_cpu:.1f} s)")
        out[name] = dict(lines=len(got), card_s=s_card, cpu_s=s_cpu)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the SSM, hybrid, encoder-decoder and VLM families at full width
# ---------------------------------------------------------------------------
# Four models at the repo's widths, every layer, bf16, random weights from
# --seed, each served through the Generator and freed before the next:
# Mamba2-1.3B (ssm), Zamba2-2.7B (hybrid), Whisper-small (encdec, 1,500
# frames: 30 s of audio) and LLaVA-NeXT-34B (vlm, 576 patch embeddings).
# The prefixes are standard normal f32, as the JAX tests draw them.

# arch: the Generator's traffic (B prompts of S tokens, ``steps`` greedy
# steps), Mamba2's long prompt (tokens, steps) at B = 1, and the rows of
# each pass of the f32 reference (LLaVA's 34B weights leave room for two)
FAMILY_TRAFFIC = {
    "mamba2-1.3b": dict(B=4, S=2048, steps=16, long=(32_768, 8)),
    "zamba2-2.7b": dict(B=4, S=2048, steps=16),
    "whisper-small": dict(B=4, S=64, steps=16),
    "llava-next-34b": dict(B=4, S=2048, steps=16, ref_rows=2),
}

# Agreement bounds of phase 11, on max |a - b| / max |b| (b the reference
# side), per model:
#  (b) ``FLASH_TOL["bfloat16"]`` at every launch of the served prefill;
#  (c) served bf16 logits against the f32 forward with no cache and no
#      kernel whose SSM layers run the step-by-step recurrence
#      (``mamba.ssd_recurrence``): FAMILY_VS_F32_TOL, for the reason of
#      phase 5's SERVE_VS_F32_TOL: bf16 rounds the residual stream at each
#      add and a random model grows each rounding, the more the deeper and
#      wider it is.  Set from run 1 (seed 0, an H100; PERF.md), each bound
#      about 2x its model's served error and below its fp8 control:
#      Mamba2 4.18e-2 (fp8 0.531) and Zamba2 4.97e-2 (fp8 0.623) keep phase
#      5's 1e-1; Whisper's 24 narrow layers 1.15e-2 (fp8 0.146) take 5e-2;
#      LLaVA-NeXT's 60 layers of d_model 7,168 (120 rounded adds, a bf16
#      score in every decode step) 0.171 (fp8 0.862) take 0.3;
#  (d) plain attention in place of the kernel, and (e) Mamba2's first
#      decode step after 32,768 tokens against a 32,769-token prefill: two
#      more bf16 runs, held to (c)'s bound;
#  (e) the chunked scan against the recurrence in f32 on layer 0's served
#      inputs: SCAN_VS_RECURRENCE_TOL, the JAX tests' bound
#      (``tests/test_mamba_ssd.py``).
FAMILY_VS_F32_TOL = {"mamba2-1.3b": 1e-1, "zamba2-2.7b": 1e-1,
                     "whisper-small": 5e-2, "llava-next-34b": 3e-1}
SCAN_VS_RECURRENCE_TOL = 2e-4
PLAIN_BLOCK = 1 << 28       # elements of plain attention's scores a block


def flash_per_prefill(cfg) -> int:
    """``flash_attention`` launches of one prefill: one a layer's
    attention, the hybrid's shared block once a group, an encdec's
    encoder, decoder self- and cross-attention."""
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
                cfg.family, cfg.n_layers)


def plain_attention(q, k, v, causal=True):
    """``ref.flash_attention_ref`` over blocks of the BH axis, so that a
    block's f32 scores hold at most PLAIN_BLOCK elements (LLaVA's whole
    [224, 2624, 2624] would take 6.2 GB beside 68.8 GB of weights)."""
    import torch

    from repro_torch.kernels import ref
    n = max(1, PLAIN_BLOCK // (q.shape[1] * k.shape[1]))
    return torch.cat([ref.flash_attention_ref(q[i:i + n], k[i:i + n],
                                              v[i:i + n], causal=causal)
                      for i in range(0, q.shape[0], n)])


def scan_as(fn) -> swapped:
    """``with scan_as(fn):`` the Mamba2 mixer calls ``fn(x, dt, A, B, C,
    chunk)`` in place of ``mamba.ssd_scan`` (looked up at each call)."""
    from repro_torch.models import mamba
    return swapped(mamba, "ssd_scan", fn)


def recurrence_scan(x, dt, A, B, C, chunk, s0=None):
    """``ssd_scan``'s arguments, the step-by-step recurrence's result."""
    from repro_torch.models import mamba
    return mamba.ssd_recurrence(x, dt, A, B, C, s0)


def family_reference_logits(params, cfg, tokens, first: int, weight,
                            act=None, prefix=None, rows=None):
    """f32 logits [B, T - first, V] at token positions first .. T - 1 of
    ``tokens`` [B, T] for an ssm, hybrid, encdec or vlm config: the full
    forward with no cache and no kernel (attention the plain version in
    f32, SSM layers the step-by-step recurrence), each layer's weights
    taken through ``weight`` when it runs, the residual stream through
    ``act`` after the embedding (and the prefix) and each residual add.
    ``prefix`` is what the served model was given; it goes in rounded to
    bf16 as the served model rounds it.  ``rows`` rows at a time (all by
    default): rows are independent, so this only bounds the memory."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import mamba
    from repro_torch.models.model import _unembed_matrix, layer_params
    from repro_torch.models.sharding import tree_map

    B, T = tokens.shape
    rows = rows or B
    if rows < B:
        return torch.cat([family_reference_logits(
            params, cfg, tokens[i:i + rows], first, weight, act,
            None if prefix is None else prefix[i:i + rows])
            for i in range(0, B, rows)])
    dev = tokens.device
    act = act or (lambda t: t)
    fam = cfg.family

    def attention(p, xn, positions, causal, memory=None):
        if memory is None:
            q, k, v = L.qkv_project(p, xn, cfg, positions)
        else:
            q = L._mm("bsd,dhk->bshk", xn, p["wq"])
            k = L._mm("btd,dhk->bthk", memory, p["wk"])
            v = L._mm("btd,dhk->bthk", memory, p["wv"])
        k, v = (L._expand_kv(t, cfg.n_heads) for t in (k, v))
        H, D = q.shape[2], q.shape[3]

        def hm(t):
            return t.transpose(1, 2).reshape(B * H, t.shape[1], D)

        o = plain_attention(hm(q), hm(k), hm(v), causal=causal)
        o = o.view(B, H, q.shape[1], D).transpose(1, 2)
        return L._mm("bshk,hkd->bsd", o, p["wo"])

    def block(lp, x, positions, causal=True, memory=None):
        x = act(x + attention(lp["attn"], L.rmsnorm(x, lp["ln1"]), positions,
                              causal))
        if memory is not None:
            x = act(x + attention(lp["xattn"], L.rmsnorm(x, lp["ln_x"]),
                                  None, False, memory))
        return act(x + L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg))

    def mixer(lp, x):
        return act(x + mamba.mamba_block(lp["mixer"], L.rmsnorm(x, lp["ln"]),
                                         cfg))

    with torch.no_grad(), scan_as(recurrence_scan):
        x = act(weight(params["embed"])[tokens])
        memory = None
        if fam == "vlm":
            x = torch.cat([act(prefix.to(torch.bfloat16).float()), x], dim=1)
            first += prefix.shape[1]
        elif fam == "encdec":
            m = act(prefix.to(torch.bfloat16).float())
            pos_m = torch.arange(m.shape[1], device=dev)[None, :]
            for i in range(cfg.n_enc_layers):
                m = block(tree_map(weight, layer_params(params, i,
                                                        "enc_layers")),
                          m, pos_m, causal=False)
            memory = L.rmsnorm(m, weight(params["enc_norm"]))
            del m
        positions = torch.arange(x.shape[1], device=dev)[None, :]
        if fam == "ssm":
            for i in range(cfg.n_layers):
                x = mixer(tree_map(weight, layer_params(params, i)), x)
        elif fam == "hybrid":
            shared = tree_map(weight, params["shared_attn"])
            for g in range(cfg.n_layers // cfg.attn_every):
                for i in range(cfg.attn_every):
                    x = mixer(tree_map(weight, layer_params(params, (g, i))),
                              x)
                x = block(shared, x, positions)
        else:
            key = "dec_layers" if fam == "encdec" else "layers"
            for i in range(cfg.n_layers):
                x = block(tree_map(weight, layer_params(params, i, key)), x,
                          positions, memory=memory)
        hidden = L.rmsnorm(x[:, first:], weight(params["final_norm"]))
        W = weight(_unembed_matrix(params))
        logits = L._mm("bsd,vd->bsv", hidden, W)
        if W.shape[0] > cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
    return logits


def decode_read_bytes(params, cfg, shapes, live: float) -> dict:
    """Bytes one decode step must read, by kind: the weights it uses (an
    untied embedding table only at the batch's rows, an encdec's encoder
    not at all), the SSM state and conv tail, the K/V of ``live``
    positions on average, and an encdec's cross K/V; ``shapes`` is the
    model's ``init_cache``."""
    import torch

    from repro_torch.models.sharding import tree_bytes

    def nbytes(*names):
        return sum(math.prod(shapes[n].shape)
                   * torch.empty(0, dtype=shapes[n].dtype).element_size()
                   for n in names)

    w = tree_bytes(params)
    if "unembed" in params:
        w -= tree_bytes(params["embed"])
    if cfg.family == "encdec":
        w -= tree_bytes(params["enc_layers"]) + tree_bytes(params["enc_norm"])
    out = dict(weights=w)
    if "s" in shapes:
        out["ssm_state"] = nbytes("s", "conv")
    if "k" in shapes:               # [L or groups, B, max_seq, KV, D]
        out["kv"] = int(nbytes("k", "v") / shapes["k"].shape[2] * live)
    if "xk" in shapes:
        out["cross_kv"] = nbytes("xk", "xv")
    return out


def serve_family(seed: int, card: str, dev, cfg, B: int, S: int, steps: int,
                 long=None, ref_rows=None) -> dict:
    """One model of phase 11: ``cfg`` served through the ``Generator`` on
    ``B`` prompts of ``S`` tokens (and ``cfg.n_prefix`` prefix rows for a
    vlm or encdec), ``steps`` greedy steps; for an SSM config, ``long``
    (tokens, steps) more at B = 1; checks (a)-(e), (c)'s bound
    ``FAMILY_VS_F32_TOL[cfg.name]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model, mamba
    from repro_torch.models.sharding import init_params, tree_bytes
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.serve_step import Generator

    tol = FAMILY_VS_F32_TOL[cfg.name]
    t_phase = time.perf_counter()
    held_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(model.specs, gen, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(params)
    fam, V = cfg.family, cfg.vocab
    tag = f"[families] {card}: {cfg.name}"
    width = (f"ssm state {cfg.ssm_state}, {cfg.ssm_heads} SSM heads of "
             f"{cfg.ssm_head_dim}" if fam in ("ssm", "hybrid") else "")
    if fam != "ssm":
        width += (f"{', ' if width else ''}{cfg.n_heads} heads (kv "
                  f"{cfg.n_kv_heads}, head dim {cfg.resolved_head_dim}), "
                  f"d_ff {cfg.d_ff}")
    log(f"{tag} ({fam}): {cfg.n_layers} layers"
        f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}"
        f", d_model {cfg.d_model}, {width}, vocab {V}: param_count() "
        f"{cfg.param_count():,}; {weight_bytes:,} bytes of weights, made "
        f"from seed {seed} in {init_s:.1f} s; {held_before:,} bytes "
        f"allocated before")
    try:
        ContinuousBatcher(model, params, n_slots=2, max_seq=64)
        raise SystemExit(f"{cfg.name}: the batcher admitted the {fam} family")
    except NotImplementedError:
        pass

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, V, (B, S))
    prefix = None
    if cfg.frontend != "none":
        prefix = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model), dtype=np.float32), device=dev)
    npf = cfg.n_prefix if fam == "vlm" else 0
    max_seq = npf + S + steps
    seen = []
    generator = Generator(recording(model, seen), params, max_seq=max_seq,
                          device=dev)
    generator.generate(prompts[:, :64], steps=2, prefix=prefix)   # warm-up
    seen.clear()
    fa = ops.flash_attention
    want_fa = flash_per_prefill(cfg)
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path, with the kernel's count set to 0 just before
    out = {}
    fa.launches = 0
    total_ms = host_ms(lambda: out.update(toks=generator.generate(
        prompts, steps, prefix=prefix)), dev)
    launches = fa.launches
    toks = out.pop("toks")
    served = torch.stack(seen, dim=1)           # [B, steps + 1, V]
    seen.clear()
    peak_serving = torch.cuda.max_memory_allocated(dev) - held_before
    if launches != want_fa:
        raise SystemExit(f"(a) {cfg.name}: the Generator's prefill launched "
                         f"flash_attention {launches} times, expected "
                         f"{want_fa}")
    if tuple(served.shape) != (B, steps + 1, cfg.padded_vocab) or not bool(
            torch.isfinite(served[..., :V]).all()):
        raise SystemExit(f"{cfg.name}: served logits "
                         f"{tuple(served.shape)} not finite or not of the "
                         f"expected shape")
    fa.launches = 0
    prefill_ms = host_ms(lambda: generator.generate(prompts, 0,
                                                    prefix=prefix), dev)
    seen.clear()
    if fa.launches != want_fa:
        raise SystemExit(f"(a) {cfg.name}: the prefill alone launched "
                         f"flash_attention {fa.launches} times")
    decode_ms = (total_ms - prefill_ms) / steps
    log(f"{tag}: (a) flash_attention launched {launches} times in the "
        f"Generator's prefill (expected {want_fa}); the batcher refuses the "
        f"{fam} family")

    # (b) the kernel against its plain version at every launch of the
    # served prefill; the first launch's inputs are kept for the timing,
    # and every launch's output for (d)
    err_b, kept, shapes = [], [], []

    def checked(q, k, v, causal=True):
        o = fa(q, k, v, causal=causal)
        err_b.append(require_close(
            "flash_attention", o, plain_attention(q, k, v, causal=causal),
            FLASH_TOL["bfloat16"], f"{cfg.name}'s launch {len(err_b)}"))
        key = (tuple(q.shape), int(k.shape[1]), bool(causal))
        if key not in shapes:
            shapes.append(key)
            kept.append((q, k, v, causal))
        return o

    # layer 0's inputs of the chunked scan, for (e)
    mamba_scan, scan_in = mamba.ssd_scan, []

    def recorded_scan(*a):
        if not scan_in:
            scan_in.extend(a)
        return mamba_scan(*a)

    with attention_as(checked), scan_as(recorded_scan):
        generator.generate(prompts, 0, prefix=prefix)
    seen.clear()
    if len(err_b) != want_fa:
        raise SystemExit(f"(b) {cfg.name}: the served prefill called "
                         f"attention {len(err_b)} times, expected {want_fa}")
    timed = []
    with torch.no_grad():
        for q, k, v, causal in kept:
            BH, Sq, D = q.shape
            Sk = k.shape[1]
            k_ms = cuda_ms(lambda: fa(q, k, v, causal=causal), 5)
            p_ms = cuda_ms(lambda: plain_attention(q, k, v, causal=causal), 2)
            q4, k4, v4 = (t.view(B, BH // B, t.shape[1], D)
                          for t in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), 5)
            bms, bby, _ = flash_bound(BH, Sq, Sk, D, causal, 2)
            timed.append(dict(BH=BH, Sq=Sq, Sk=Sk, D=D, causal=causal,
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=bms, bound_by=bby))
            del q4, k4, v4
    del kept
    if want_fa:
        log(f"{tag}: (b) flash_attention at each of its {want_fa} launches "
            f"of the served prefill, bf16: kernel == plain version within "
            f"{FLASH_TOL['bfloat16']} (max abs err {max(err_b):.3g}); one "
            f"launch a shape: " + "; ".join(
                f"[BH={t['BH']}, Sq={t['Sq']}, Sk={t['Sk']}, D={t['D']}"
                f"{', causal' if t['causal'] else ''}] {t['ms']:.3f} ms vs "
                f"bound {t['bound_ms']:.4f} ({t['bound_by']}), plain "
                f"{t['plain_ms']:.3f}, SDPA {t['library_ms']:.3f}"
                for t in timed))

    # (c) served logits against the f32 forward, and the fp8 control
    seq = torch.cat([torch.as_tensor(prompts, device=dev),
                     torch.as_tensor(toks, device=dev)], dim=1)
    t0 = time.perf_counter()
    want = family_reference_logits(params, cfg, seq, S - 1,
                                   lambda w: w.float(), prefix=prefix,
                                   rows=ref_rows)
    ref_s = time.perf_counter() - t0
    err_c = rel_err(served[..., :V], want[..., :V])
    per_pos = [rel_err(served[:, j, :V], want[:, j, :V])
               for j in range(steps + 1)]
    fp8 = family_reference_logits(params, cfg, seq, S - 1, fp8_round,
                                  fp8_round, prefix=prefix, rows=ref_rows)
    err_fp8 = rel_err(fp8[..., :V], want[..., :V])
    del fp8
    log(f"{tag}: (c) served bf16 logits vs the f32 forward (no cache, no "
        f"kernel{', SSM layers by the recurrence' if fam in ('ssm', 'hybrid') else ''}) "
        f"at {B} x {steps + 1} positions: {err_c:.3e} of max |logit| "
        f"{float(want[..., :V].abs().max()):.3f} (bound {tol}; prefill "
        f"{per_pos[0]:.3e}, worst step {max(per_pos[1:] or [0.0]):.3e}); "
        f"fp8 control (e4m3 weights and residual stream) {err_fp8:.3e}"
        f"{'' if err_fp8 > tol else ' -- INSIDE the bound'}; the f32 "
        f"forward took {ref_s:.1f} s"
        f"{f' ({ref_rows} rows a pass)' if ref_rows else ''}")
    del want

    # (d) the plain attention in place of the kernel, fed the same tokens
    err_d = None
    if want_fa:
        lg_d = []
        with attention_as(plain_attention):
            Generator(recording(model, lg_d, forced=toks), params,
                      max_seq=max_seq, device=dev).generate(
                prompts, steps, prefix=prefix)
        err_d = rel_err(torch.stack(lg_d, dim=1)[..., :V], served[..., :V])
        del lg_d
        log(f"{tag}: (d) plain attention in place of the kernel: "
            f"{err_d:.3e} of max |logit| (bound {tol})")

    # (e) the chunked scan against the recurrence at layer 0's inputs of
    # the served prefill; Mamba2's long prompt
    scan = {}
    if fam in ("ssm", "hybrid"):
        x, dt, A, Bm, Cm, chunk = scan_in
        y_s, s_s = mamba_scan(x, dt, A, Bm, Cm, chunk)
        y_r, s_r = mamba.ssd_recurrence(x, dt, A, Bm, Cm)
        scan = dict(y=rel_err(y_s, y_r), state=rel_err(s_s, s_r),
                    shape=list(x.shape), chunk=chunk)
        log(f"{tag}: (e) chunked scan (chunk {chunk}) vs the step-by-step "
            f"recurrence in f32 at layer 0's inputs {list(x.shape)} of the "
            f"served prefill: y {scan['y']:.3e}, final state "
            f"{scan['state']:.3e} of their largest magnitude (bound "
            f"{SCAN_VS_RECURRENCE_TOL})")
        del x, dt, A, Bm, Cm, y_s, s_s, y_r, s_r
    del scan_in
    long_run = {}
    if long:
        n_long, steps_long = long
        lp = rng.integers(0, V, (1, n_long))
        solo = []
        g1 = Generator(recording(model, solo), params,
                       max_seq=n_long + steps_long + 1, device=dev)
        # B = 1 at S: the decode step to set beside the long one
        short_total = host_ms(lambda: g1.generate(prompts[:1], steps_long),
                              dev)
        short_prefill = host_ms(lambda: g1.generate(prompts[:1], 0), dev)
        solo.clear()
        lt = {}
        long_total = host_ms(lambda: lt.update(t=g1.generate(
            lp, steps_long)), dev)
        long_logits = torch.stack(solo, dim=1)
        solo.clear()
        long_prefill = host_ms(lambda: g1.generate(lp, 0), dev)
        solo.clear()
        g1.generate(np.concatenate([lp, lt["t"][:, :1]], axis=1), 0)
        err_long = rel_err(long_logits[:, 1, :V], solo[0][:, :V])
        solo.clear()
        long_run = dict(
            tokens=n_long, steps=steps_long, prefill_ms=long_prefill,
            decode_ms_per_step=(long_total - long_prefill) / steps_long,
            short_prefill_ms=short_prefill,
            short_decode_ms_per_step=(short_total - short_prefill)
            / steps_long, err_first_step_vs_prefill=err_long)
        log(f"{tag}: (e) B = 1, {n_long:,}-token prompt: the first decode "
            f"step's logits vs a {n_long + 1:,}-token prefill's last: "
            f"{err_long:.3e} (bound {tol}); prefill {long_prefill:.1f} ms "
            f"({n_long / (long_prefill / 1e3):.0f} tokens/s), decode "
            f"{long_run['decode_ms_per_step']:.2f} ms a step against "
            f"{long_run['short_decode_ms_per_step']:.2f} after {S:,} tokens "
            f"(prefill {short_prefill:.1f} ms)")

    reads = decode_read_bytes(params, cfg, model.init_cache(B, max_seq),
                              live=npf + S + steps / 2)
    read_ms = sum(reads.values()) / HBM_BYTES_PER_S * 1e3
    gen_tok_s = B * steps / ((total_ms - prefill_ms) / 1e3)
    phase_s = time.perf_counter() - t_phase
    log(f"{tag}: Generator B={B}: prefill {prefill_ms:.1f} ms "
        f"({B * (npf + S) / (prefill_ms / 1e3):.0f} positions/s"
        f"{f', {npf} of them prefix' if npf else ''}"
        f"{f', plus {cfg.n_prefix} frames encoded' if fam == 'encdec' else ''}"
        f"), decode {decode_ms:.2f} ms a step ({gen_tok_s:.1f} tokens/s) "
        f"against a bound of {read_ms:.3f} ms reading " + ", ".join(
            f"{n} {b:,}" for n, b in reads.items()) + f" bytes; weights "
        f"{weight_bytes:,} bytes, peak allocated while serving "
        f"{peak_serving:,} bytes above the {held_before:,} held before; "
        f"{phase_s:.1f} s")

    failed = [name for name, e, t in (
        ("(c)", err_c, tol), ("(d)", err_d, tol),
        ("(e) scan y", scan.get("y"), SCAN_VS_RECURRENCE_TOL),
        ("(e) scan state", scan.get("state"), SCAN_VS_RECURRENCE_TOL),
        ("(e) long prompt", long_run.get("err_first_step_vs_prefill"), tol))
        if e is not None and not e <= t]
    if failed:
        raise SystemExit(f"phase 11 failed {failed} for {cfg.name}")
    del params, model, generator, served
    return dict(
        arch=cfg.name, family=fam, layers=cfg.n_layers,
        enc_layers=cfg.n_enc_layers, param_count=cfg.param_count(),
        weight_bytes=weight_bytes, held_before_bytes=held_before,
        init_s=init_s, peak_serving_bytes=peak_serving,
        traffic=dict(B=B, S=S, steps=steps, prefix=cfg.n_prefix
                     if prefix is not None else 0),
        prefill_ms=prefill_ms,
        prefill_positions_per_s=B * (npf + S) / (prefill_ms / 1e3),
        decode_ms_per_step=decode_ms, decode_tokens_per_s=gen_tok_s,
        decode_read_bytes=reads, decode_bound_ms=read_ms,
        generate_ms=total_ms, launches=launches, max_abs_err=max(err_b or
                                                                 [0.0]),
        err_kernel_by_launch=err_b, flash_by_shape=timed,
        err_served_vs_f32=err_c, err_served_by_position=per_pos,
        err_fp8_control=err_fp8, fp8_control_inside=not err_fp8 > tol,
        err_plain_vs_kernel=err_d, scan_vs_recurrence=scan,
        long_prompt=long_run, reference_s=ref_s, bound=tol, s=phase_s)


def phase_families(seed: int, card: str, dev, cfgs=None,
                   traffic=None) -> dict:
    """Phase 11: each of ``FAMILY_TRAFFIC``'s four models (or ``cfgs``, a
    rehearsal's, with ``traffic`` by name) served at full width by
    ``serve_family``, each freed before the next is drawn."""
    import torch

    from repro_torch.configs import get_config
    cfgs = cfgs or [get_config(a) for a in FAMILY_TRAFFIC]
    out = {}
    for cfg in cfgs:
        kw = (traffic or FAMILY_TRAFFIC)[cfg.name]
        out[cfg.name] = serve_family(seed, card, dev, cfg, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 12: Llama-3.2-3B training at full width
# ---------------------------------------------------------------------------
# get_config("llama3.2-3b"): every layer, bf16 parameters from --seed, f32
# AdamW moments.  Cut: the global batch is 4 sequences of 4,096 tokens
# (train_4k's 256), run as 2 microbatches of 2; the full-width checkpoint
# round trip is left out (36 GB of npz a save), the restart drill runs at
# the driver's default_config.

TRAIN_ARCH = "llama3.2-3b"
TRAIN_TRAFFIC = dict(B=4, S=4096, micro=2, steps=5)
TRAIN_LR = 1e-3
# Agreement bounds of phase 12, each |g - g32| / |g32| in the 2-norm of a
# leaf (g32 the reference side):
#  (b) one microbatch's bf16 gradients (the kernel's forward, the plain
#      backward) against the f32 gradients from an f32 copy of the
#      parameters with the plain attention in BH blocks and TF32 off:
#      TRAIN_VS_F32_TOL by leaf (the default under ""), for the reason of
#      phase 5's SERVE_VS_F32_TOL: bf16 rounds the residual stream at each
#      of the 56 adds and the activations' gradients at each product, and
#      28 random layers grow each rounding.  Its control, the same bf16
#      step with the kernel's output detached (F3's fault), must leave
#      wq, wk and wv at least TRAIN_CONTROL_MIN off (they get no
#      gradient: 1.0);
#  (c) the attention backward at layer 0 (BH = 48, S = 4,096, D = 128):
#      the Function's plain backward in f32 against torch.autograd.grad of
#      the plain forward within ATTN_BWD_TOL of max |.| (both f32 plain
#      code, sums in other orders), its bf16 gradients within a bf16 step
#      (2**-8) of max |.|, and the kernel's forward within
#      FLASH_TOL["bfloat16"] of its plain version;
#  (d) the loss falls by at least TRAIN_LOSS_DROP nat over the steps
#      (weight decay alone moves it by ~1e-4);
#  (e) the card's first AdamW update of layer 0's wq and of embed against
#      the same update on CPU copies: m and v within 1 f32 ulp, the
#      parameters within 1 bf16 ulp (pow and the global norm may round
#      the last place differently);
#  (f) the restart drill's restored state equal bit for bit to the saved
#      one, its resumed losses within DRILL_LOSS_TOL of an uninterrupted
#      run's (the card's embedding backward sums in no fixed order).
#      Set from run 1 (seed 0, an H100; PERF.md): every leaf 1.52e-2
#      (final_norm) to 4.95e-2 (wq), the embedding 4.59e-2 among them, so
#      one bound of about 2x the largest serves every leaf; the detached
#      control reads 1.0.
TRAIN_VS_F32_TOL = {"": 1e-1}
TRAIN_CONTROL_MIN = 0.99
ATTN_BWD_TOL = 1e-5
TRAIN_LOSS_DROP = 0.1
DRILL_ARGV = ["--steps", "10", "--ckpt-every", "5", "--batch", "2",
              "--seq", "32", "--log-every", "5"]
DRILL_FAIL_AT = 6
DRILL_LOSS_TOL = 1e-3


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) of a parameter tree in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}/{k}" if prefix
                                      else k)]
    return [(prefix, tree)]


def state_leaves(state) -> list:
    """(path, tensor) of every leaf of a TrainState."""
    out = [(f"params/{n}", t) for n, t in named_leaves(state.params)]
    out.append(("opt/step", state.opt.step))
    out += [(f"opt/m/{n}", t) for n, t in named_leaves(state.opt.m)]
    out += [(f"opt/v/{n}", t) for n, t in named_leaves(state.opt.v)]
    if state.error is not None:
        out += [(f"error/{n}", t) for n, t in named_leaves(state.error)]
    return out


def cpu_state(state):
    """A CPU copy of a TrainState."""
    from repro_torch.models.sharding import tree_map
    cp = lambda t: t.detach().to("cpu", copy=True)
    opt = type(state.opt)(cp(state.opt.step), tree_map(cp, state.opt.m),
                          tree_map(cp, state.opt.v))
    return type(state)(tree_map(cp, state.params), opt,
                       None if state.error is None
                       else tree_map(cp, state.error))


def same_bits(a, b) -> bool:
    """The same dtype, shape and bytes."""
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def grads_with_attention(model, params, batch, attention):
    """{leaf path: gradient} of ``model.loss_fn`` with ``attention`` in
    place of ``ops.flash_attention``; a leaf the loss reaches through no
    differentiable path gets zeros."""
    import torch

    from repro_torch.models.sharding import tree_leaves, tree_unflatten
    names = [n for n, _ in named_leaves(params)]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with attention_as(attention), torch.enable_grad():
        loss, _ = model.loss_fn(tree_unflatten(params, leaves), batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, leaves, gs)}


def within_ulp(got, want, bf16: bool) -> bool:
    """|got - want| <= one ulp (of f32, or of bf16) at their larger
    magnitude, elementwise, in f64."""
    import torch
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - (7 if bf16 else 23))
    return bool(((g - w).abs() <= ulp).all())


def split_step(model, opt, state, parts, dev):
    """One instrumented step: (host ms (between synchronisations) of the
    forward, the remat recompute, the plain attention backward, the rest
    of the backward and the optimizer update, over the microbatches
    ``parts``; the peak bytes allocated in the forward, the backward and
    the update)."""
    import torch

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models import model as M
    from repro_torch.models.sharding import tree_leaves, tree_unflatten
    ms = dict(forward=0.0, recompute=0.0, attention_backward=0.0,
              rest_of_backward=0.0, update=0.0)
    in_backward = [False]

    def timed(key, fn):
        # a recompute ends in an exception once the backward has what it
        # needs (the checkpoint's early stop): time it in ``finally``
        def run(*a):
            sync(dev)
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                sync(dev)
                if key != "recompute" or in_backward[0]:
                    ms[key] += (time.perf_counter() - t0) * 1e3
        return run

    peaks = dict(forward=0, backward=0, update=0)

    def peak(key):
        peaks[key] = max(peaks[key], torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    params = state.params
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    torch.cuda.reset_peak_memory_stats(dev)
    with swapped(M, "_decoder_layer", timed("recompute", M._decoder_layer)), \
            swapped(fa_mod, "flash_attention_bwd_ref",
                    timed("attention_backward",
                          fa_mod.flash_attention_bwd_ref)):
        for part in parts:
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            in_backward[0] = False
            with torch.enable_grad():
                sync(dev)
                t0 = time.perf_counter()
                loss, _ = model.loss_fn(tree_unflatten(params, leaves), part)
                sync(dev)
                ms["forward"] += (time.perf_counter() - t0) * 1e3
                peak("forward")
                in_backward[0] = True
                t0 = time.perf_counter()
                gs = torch.autograd.grad(loss, leaves)
                sync(dev)
                ms["rest_of_backward"] += (time.perf_counter() - t0) * 1e3
                peak("backward")
            for a, g in zip(acc, gs):
                a.add_(g)
            del gs, loss, leaves
    ms["rest_of_backward"] -= ms["recompute"] + ms["attention_backward"]
    for a in acc:
        a.div_(len(parts))
    ms["update"] = host_ms(lambda: opt.update(
        tree_unflatten(params, acc), state.opt, params), dev)
    peak("update")
    return ms, peaks


def phase_train(seed: int, card: str, dev, cfg=None, B: int = 4,
                S: int = 4096, micro: int = 2, steps: int = 5,
                drill=DRILL_ARGV) -> dict:
    """Phase 12: Llama-3.2-3B (or ``cfg``, a rehearsal's) trained at full
    width on the pruned-data loader's first batch (``B`` sequences of
    ``S`` tokens in ``micro`` microbatches, ``steps`` steps), with checks
    (a)-(f), then the restart drill of the port's driver at its
    default_config."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (PrunedDataLoader, curate,
                                           make_corpus_metadata)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as driver
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.model import layer_params
    from repro_torch.models.sharding import init_params, tree_bytes, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW, AdamWState, global_norm
    from repro_torch.train.train_step import (TrainState, loss_and_grads,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = cfg or get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(model.specs, gen, device=dev)
    sync(dev)
    n_params = cfg.param_count()
    weight_bytes = tree_bytes(params)
    log(f"[train] {card}: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, head dim "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"remat {cfg.remat}: {n_params:,} parameters, {weight_bytes:,} "
        f"bytes in bf16, made from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")

    # the traffic: the paper's engine curates the corpus, the loader hands
    # out its first batch
    meta = make_corpus_metadata(np.random.default_rng(seed), n_shards=512,
                                docs_per_shard=16)
    scan, report = curate(meta, driver.CURATION_PRED)
    loader = PrunedDataLoader(scan, worker=0, n_workers=1, batch_size=B,
                              seq_len=S, vocab=cfg.vocab, seed=seed)
    batch = next(iter(loader))
    mb0 = {k: v[:B // micro] for k, v in batch.items()}
    log(f"[train] {card}: curation kept {report.shards_selected} of "
        f"{report.shards_total} shards; batch {B} x {S} tokens in {micro} "
        f"microbatches")
    fa = ops.flash_attention
    per_mb = flash_per_prefill(cfg) * (2 if cfg.remat else 1)

    # (a), (b): one microbatch's bf16 gradients at step 0
    fa.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    loss0, _, g = loss_and_grads(model, params, mb0)
    sync(dev)
    mb_ms = (time.perf_counter() - t0) * 1e3
    if fa.launches != per_mb:
        raise SystemExit(f"phase 12 (a): flash_attention launched "
                         f"{fa.launches} times in a microbatch's forward and "
                         f"backward, not {per_mb}")
    g = dict(named_leaves(g))
    dead = [n for n, t in g.items() if not bool(torch.isfinite(t).all())
            or not bool(t.abs().max() > 0)]
    if dead:
        raise SystemExit(f"phase 12 (b): leaves with a non-finite or zero "
                         f"gradient: {dead}")
    attn_leaves = [n for n in g if n.split("/")[-1] in ("wq", "wk", "wv")]

    def detached(q, k, v, causal=True):
        with torch.no_grad():          # the kernel's output, no history
            return fa(q, k, v, causal=causal)

    ctl = grads_with_attention(model, params, mb0, detached)
    ctl = {n: ctl[n] for n in attn_leaves}
    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float(), params)
    g32 = grads_with_attention(model, p32, mb0, plain_attention)
    del p32
    sync(dev)
    ref_s = time.perf_counter() - t0
    errs = {n: rms_err(g[n], g32[n]) for n in g}
    ctl_errs = {n: rms_err(ctl[n], g32[n]) for n in attn_leaves}
    del g, g32, ctl
    gc.collect()
    for n, e in errs.items():
        log(f"[train] {card}: (b) {n}: bf16 vs f32 gradient {e:.4e} "
            f"(bound {TRAIN_VS_F32_TOL.get(n, TRAIN_VS_F32_TOL[''])})"
            + (f", kernel output detached {ctl_errs[n]:.4e}"
               if n in ctl_errs else ""))
    over = {n: e for n, e in errs.items()
            if not e <= TRAIN_VS_F32_TOL.get(n, TRAIN_VS_F32_TOL[""])}
    if over:
        raise SystemExit(f"phase 12 (b): gradients outside their bound: "
                         f"{over}")
    inside = {n: e for n, e in ctl_errs.items() if not e >= TRAIN_CONTROL_MIN}
    if inside:
        raise SystemExit(f"phase 12 (b): the detached control's attention "
                         f"gradients are not off: {inside}")
    torch.cuda.empty_cache()

    # (c) the attention backward at layer 0's q, k, v
    with torch.no_grad():
        lp = layer_params(params, 0)
        x = params["embed"][mb0["tokens"].to(dev).long()]
        positions = torch.arange(S, device=dev)[None, :]
        q, k, v = L.qkv_project(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                positions)
        k, v = (L._expand_kv(t, cfg.n_heads) for t in (k, v))
        q, k, v = (t.transpose(1, 2).contiguous().view(-1, S, t.shape[-1])
                   for t in (q, k, v))
        del x
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    fwd_err = require_close("flash_attention", fa(q, k, v, causal=True),
                            plain_attention(q, k, v), FLASH_TOL["bfloat16"],
                            f"phase 12 (c), {tuple(q.shape)}")
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa(*qkv, causal=True)
    sync(dev)
    t0 = time.perf_counter()
    got = torch.autograd.grad(o, qkv, do)
    sync(dev)
    attn_bwd_ms = (time.perf_counter() - t0) * 1e3
    del o, qkv
    f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(plain_attention(*f32), f32, do.float())
    plain = ref.flash_attention_bwd_ref(*(t.detach() for t in f32),
                                        do.float(), True)
    bwd_err = max(rel_err(p, w) for p, w in zip(plain, want))
    bwd_bf16_err = max(rel_err(a.float(), w) for a, w in zip(got, want))
    del f32, want, plain, got, q, k, v, do
    if not (bwd_err <= ATTN_BWD_TOL and bwd_bf16_err <= 2.0 ** -8):
        raise SystemExit(f"phase 12 (c): the attention backward is "
                         f"{bwd_err:.3e} (f32, bound {ATTN_BWD_TOL}) and "
                         f"{bwd_bf16_err:.3e} (bf16, bound 2**-8) from "
                         f"autograd of the plain attention")
    log(f"[train] {card}: (c) layer 0's attention at BH = "
        f"{B // micro * cfg.n_heads}, S = {S}: kernel forward within "
        f"{FLASH_TOL['bfloat16']} (max abs err {fwd_err:.3e}); plain "
        f"backward {attn_bwd_ms:.1f} ms, {bwd_err:.3e} (f32) and "
        f"{bwd_bf16_err:.3e} (bf16) from autograd of the plain attention")
    gc.collect()
    torch.cuda.empty_cache()

    # (d), (e): AdamW and the train step on the batch, ``steps`` steps
    opt = AdamW(lr=lambda s: TRAIN_LR)
    state = TrainState(params, opt.init(params))
    step_fn = make_train_step(model, opt, microbatches=micro)
    first = {}
    pick = {"layers/attn/wq[0]": lambda t: t["layers"]["attn"]["wq"][0],
            "embed": lambda t: t["embed"]}

    def spy(self, grads, st, prm):
        if not first:
            cp = lambda t: t.detach().to("cpu", copy=True)
            first["gnorm"] = cp(global_norm(grads))
            first["step"] = cp(st.step)
            for n, f in pick.items():
                first[n] = {"g": cp(f(grads)), "m": cp(f(st.m)),
                            "v": cp(f(st.v)), "p": cp(f(prm))}
            out = real_update(self, grads, st, prm)
            for n, f in pick.items():
                first[n].update(m1=cp(f(out[1].m)), v1=cp(f(out[1].v)),
                                p1=cp(f(out[0])))
            return out
        return real_update(self, grads, st, prm)

    torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    losses, step_ms = [], []
    with swapped(AdamW, "update", spy) as real_update:
        for _ in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            state, met = step_fn(state, batch)
            losses.append(float(met["loss"]))
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != steps * micro * per_mb:
        raise SystemExit(f"phase 12 (a): flash_attention launched {launches} "
                         f"times in {steps} steps, not "
                         f"{steps * micro * per_mb}")
    if not losses[0] - losses[-1] >= TRAIN_LOSS_DROP:
        raise SystemExit(f"phase 12 (d): the loss fell {losses[0]:.4f} -> "
                         f"{losses[-1]:.4f}, less than {TRAIN_LOSS_DROP}")
    scale = torch.clamp(opt.clip_norm / torch.clamp(first["gnorm"], min=1e-9),
                        max=1.0)
    cpu_opt = AdamW(lr=lambda s: TRAIN_LR, clip_norm=None)
    opt_ok = {}
    for n in pick:
        c = first[n]
        p = c["p"].clone()
        st = AdamWState(first["step"].clone(), {"x": c["m"].clone()},
                        {"x": c["v"].clone()})
        _, st1 = cpu_opt.update({"x": c["g"].float() * scale}, st, {"x": p})
        opt_ok[n] = (within_ulp(c["m1"], st1.m["x"], False)
                     and within_ulp(c["v1"], st1.v["x"], False)
                     and within_ulp(c["p1"], p, True))
    if not all(opt_ok.values()):
        raise SystemExit(f"phase 12 (e): the card's first AdamW update is "
                         f"not the CPU's within 1 ulp: {opt_ok}")
    timed = step_ms[1:] or step_ms
    step_s = statistics.median(timed) / 1e3
    tokens = B * S
    mfu = 6 * n_params * tokens / (step_s * BF16_OPS_PER_S)
    state_bytes = weight_bytes + 2 * 4 * (weight_bytes // 2)
    acc_bytes = 4 * (weight_bytes // 2)
    log(f"[train] {card}: (d) loss {' -> '.join(f'{x:.4f}' for x in losses)} "
        f"over {steps} steps of {tokens:,} tokens (lr {TRAIN_LR}); "
        f"(a) {launches} flash launches ({launches // steps} a step); (e) the "
        f"first AdamW update of {', '.join(pick)} equals the CPU's within "
        f"1 ulp")
    log(f"[train] {card}: step {step_s * 1e3:.1f} ms (median of "
        f"{len(timed)}; all: {', '.join(f'{x:.1f}' for x in step_ms)}), "
        f"{tokens / step_s:,.0f} tokens/s, 6ND share {mfu:.2%} of "
        f"{BF16_OPS_PER_S / 1e12:.1f} TFLOP/s; peak {peak:,} bytes beside "
        f"{state_bytes:,} of state and {acc_bytes:,} of f32 accumulators")

    parts = [{k: v[i * (B // micro):(i + 1) * (B // micro)]
              for k, v in batch.items()} for i in range(micro)]
    split, split_peaks = split_step(model, opt, state, parts, dev)
    log(f"[train] {card}: split of one step (host ms, synchronised): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + "; peak bytes in the " + ", ".join(f"{k} {v:,}" for k, v in
                                              split_peaks.items()))
    # the state and model stay for phase 13
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the restart drill of the port's driver at its default_config
    tmp = tempfile.mkdtemp(prefix="phase12_")
    saved, restored = {}, {}

    def spy_save(directory, step, state, extra=None):
        saved[(directory, step)] = cpu_state(state)
        return real_save(directory, step, state, extra)

    def spy_restore(directory, step, like, device=None):
        out = real_restore(directory, step, like, device)
        restored[(directory, step)] = cpu_state(out[0])
        return out

    def run(argv):
        buf = io.StringIO()
        code, losses_ = 0, None
        with contextlib.redirect_stdout(buf):
            try:
                losses_ = driver.main(argv + ["--device", dev.type])
            except SystemExit as e:
                code = e.code
        return code, losses_, buf.getvalue()

    t0 = time.perf_counter()
    try:
        d1, d2 = f"{tmp}/ck", f"{tmp}/whole"
        with swapped(ckpt, "save", spy_save) as real_save, \
                swapped(ckpt, "restore", spy_restore) as real_restore:
            code1, _, out1 = run(drill + ["--ckpt-dir", d1,
                                          "--simulate-failure",
                                          str(DRILL_FAIL_AT)])
            code2, resumed, out2 = run(drill + ["--ckpt-dir", d1])
            code3, whole, out3 = run(drill + ["--ckpt-dir", d2])
        at = ckpt.latest_step(d1)
        if code1 != 42 or code2 or code3 or "resumed from step" not in out2 \
                or "done:" not in out2:
            raise SystemExit(f"phase 12 (f): the drill exited {code1}, "
                             f"{code2}, {code3}: {out1[-300:]} {out2[-300:]}")
        resume_at = int(out2.split("resumed from step ")[1].split()[0])
        bits_ok = all(same_bits(a, b) for (_, a), (_, b) in zip(
            state_leaves(restored[(d1, resume_at)]),
            state_leaves(saved[(d1, resume_at)])))
        loss_err = max(abs(a - b) for a, b in zip(resumed,
                                                  whole[resume_at:]))
        on_cpu, _ = ckpt.restore(d1, at, saved[(d1, at)], device="cpu")
        cpu_ok = all(same_bits(a, b) for (_, a), (_, b) in zip(
            state_leaves(on_cpu), state_leaves(saved[(d1, at)])))
    finally:
        shutil.rmtree(tmp)
    drill_s = time.perf_counter() - t0
    if not (bits_ok and cpu_ok and loss_err <= DRILL_LOSS_TOL):
        raise SystemExit(f"phase 12 (f): restored state equal {bits_ok}, "
                         f"CPU restore equal {cpu_ok}, resumed losses "
                         f"{loss_err:.3e} from the whole run's (bound "
                         f"{DRILL_LOSS_TOL})")
    phase_s = time.perf_counter() - t_phase
    log(f"[train] {card}: (f) the driver stopped at step {DRILL_FAIL_AT} "
        f"(exit 42), resumed from step {resume_at} with its state restored "
        f"bit for bit, losses within {loss_err:.3e} of an uninterrupted "
        f"run's; step {at}'s checkpoint restored on the CPU bit for bit "
        f"({drill_s:.1f} s)")
    log(f"[train] {card}: phase 12 took {phase_s:.1f} s (f32 reference "
        f"{ref_s:.1f} s, one bf16 microbatch {mb_ms:.1f} ms)")
    return dict(
        arch=cfg.name, params=n_params, weight_bytes=weight_bytes,
        tokens_per_step=tokens, losses=losses, loss0=float(loss0),
        step_ms=step_ms, step_ms_median=step_s * 1e3,
        tokens_per_s=tokens / step_s, mfu_6nd=mfu, peak_bytes=peak,
        state_bytes=state_bytes, accumulator_bytes=acc_bytes, split=split,
        split_peak_bytes=split_peaks,
        grad_vs_f32=errs, control_vs_f32=ctl_errs, attn_bwd_ms=attn_bwd_ms,
        attn_bwd_err=bwd_err, attn_bwd_bf16_err=bwd_bf16_err,
        flash_fwd_err=fwd_err, drill_loss_err=loss_err, drill_s=drill_s,
        microbatch_ms=mb_ms, reference_s=ref_s, launches=launches,
        max_abs_err=fwd_err, s=phase_s,
        handoff=(state, model, batch, micro))


MESH_RANKS = 4           # (b), (c): gloo ranks spawned on the one card
MESH_SHARDED = dict(layers=2, B=2, S=1024)   # (c): 2 layers, 2 x 1,024
# (c)'s device.  The card's probe (``tools/gloo_cuda_probe.py``, 4 gloo
# ranks on one H100, torch 2.11.0+cu128) found every c10d collective
# taking CUDA tensors, but the functional all-gather that DTensor
# redistributes through (``_c10d_functional.all_gather_into_tensor``)
# killing its rank with SIGSEGV at any size; NCCL refuses two ranks on one
# device.  So the sharded step runs its 4 ranks on the CPU, at the smoke
# config (ROADMAP queue 2b item 15); (b)'s collectives stay on the card,
# and so does (e), whose expert-parallel MoE layer issues no all-gather
# (``MOE_MESH_DEVICE``).
SHARDED_STEP_DEVICE = "cpu"
PSUM_N = 1 << 22         # (b): elements a rank
# (d)'s smoke cells on the 8-rank mesh: (arch, shape, overrides)
DRYRUN_SMOKE = (("llama3.2-3b", "train_4k", None),
                ("kimi-k2-1t-a32b", "train_4k", None),
                ("kimi-k2-1t-a32b", "train_4k",
                 dict(moe_dispatch="grouped", moe_sharding="resident")),
                ("mamba2-1.3b", "long_500k", None),
                ("zamba2-2.7b", "decode_32k", None),
                ("whisper-small", "decode_32k", None),
                ("llava-next-34b", "prefill_32k", None))
DRYRUN_FULL = ("llama3.2-3b", "train_4k")
CARD_BYTES = 80e9        # the H100's device memory: a cell's bytes a device
DRYRUN_TIMEOUT_S = 600
# (e): one MoE layer of ``MOE_ARCH`` at full width on the 4 ranks as a
# 2x2 (data, model) mesh, each (dispatch, sharding) layout in turn: B rows
# of S positions in S / moe_seq_chunk dispatch chunks.  Its device: the
# card's probe (``tools/gloo_cuda_probe.py``, 4 gloo ranks on one H100,
# torch 2.11.0+cu128) found gloo's functional all-reduce and all-to-all
# (and the latter's autograd form) taking CUDA tensors, the functional
# all-gather killing its rank at int64 as at bf16; the expert-parallel
# dispatch issues no all-gather (``moe._gather_rows`` sums zero-padded
# blocks), so (e) runs on the card's tensors.  On the CPU (a rehearsal)
# the layer is cut to one chunk a row (``MOE_MESH_CPU``).
MOE_MESH_DEVICE = "cuda"
MOE_MESH = dict(B=4, S=2048, chunk=256)
MOE_MESH_CPU = dict(B=4, S=256, chunk=256)
MOE_MESH_LAYOUTS = (("scatter", "fsdp"), ("grouped", "resident"))
# (e)'s bound on max |mesh - one card| / max |one card| of y, given the
# one-card routes: bit for bit where the experts sit on ``model`` (each
# slot's output computed in the one-card buffer's row, the slot sums
# exact); ``MOE_VS_F32_TOL`` under ``"resident"``, whose d_ff shards'
# bf16 products are summed over ``model`` (one rounding more a slot).


def start_dryruns(out_dir: str, full: bool = True) -> list:
    """(d): the port's dry-run in subprocesses on the host CPU (fake
    process groups, fake tensors: the card is not touched), started at
    once after phase 3's tables so they run beside phase 2 and phase 3's
    references and are done before the timed phases begin: the
    ``DRYRUN_SMOKE`` cells (the six of the JAX package's
    ``tests/test_dryrun.py`` and Kimi's under the ``"resident"`` MoE
    layout) on the scaled 8-rank mesh in one, and ``DRYRUN_FULL`` at
    full width on 16x16 and on 2x16x16 (512 fake ranks) in one each.
    ``full=False`` (a CPU rehearsal) leaves the full-width ones out.
    Returns [(name, Popen, JSON paths)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    smoke_out = [f"{out_dir}/smoke{i}_{a}_{s}.json"
                 for i, (a, s, _) in enumerate(DRYRUN_SMOKE)]
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "dryrun.init_fake_group(8)\n"
            "for (a, s, over), out in zip(json.loads(sys.argv[1]), "
            "json.loads(sys.argv[2])):\n"
            "    rec = dryrun.run_cell(a, s, False, overrides=over, "
            "smoke=True)\n"
            "    rec['overrides'] = over\n"
            "    json.dump([rec], open(out, 'w'), indent=1)\n")
    smoke = subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(DRYRUN_SMOKE),
         json.dumps(smoke_out)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, REPRO_DRYRUN_DEVICES="8", REPRO_MESH_SCALE="8"))
    procs = [("smoke", smoke, smoke_out)]
    for mesh in (("16x16", []), ("2x16x16", ["--multi-pod"])) if full else ():
        out = f"{out_dir}/full_{mesh[0]}.json"
        procs.append((f"full {mesh[0]}", subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_FULL[0], "--shape", DRYRUN_FULL[1], "--out", out]
            + mesh[1], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(env, REPRO_DRYRUN_DEVICES="512")), [out]))
    return procs


def collect_dryruns(procs) -> dict:
    """Wait for (d)'s subprocesses and check every record: OK, peak bytes
    a device within the card's; returns the records by cell."""
    out = {}
    for name, p, paths in procs:
        try:
            text, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        if p.returncode != 0:
            raise SystemExit(f"phase 13 (d): the {name} dry-run exited "
                             f"{p.returncode}: {text[-2000:]}")
        for path in paths:
            for rec in json.loads(Path(path).read_text()):
                rec.pop("trace", None)
                over = rec.get("overrides")
                key = (f"{rec['arch']} {rec['shape']} {rec['mesh']}"
                       + (" smoke" if name == "smoke" else "")
                       + (" " + " ".join(f"{k}={v}" for k, v in
                                         over.items()) if over else ""))
                out[key] = rec
    for key, rec in out.items():
        if rec["status"] != "OK":
            raise SystemExit(f"phase 13 (d): {key}: {rec['status']} "
                             f"{rec.get('error', rec.get('reason'))}")
        peak = rec["peak_bytes_per_device"]
        if not peak <= CARD_BYTES:
            raise SystemExit(f"phase 13 (d): {key}: {peak:,} bytes a "
                             f"device, above the card's {CARD_BYTES:,.0f}")
    return out


def report_dryruns(records: dict, card: str) -> None:
    """(d)'s lines: each cell's peak bytes a device, its collective bytes
    by mesh axis and its roofline."""
    for key, rec in records.items():
        peak = rec["peak_bytes_per_device"]
        rl = rec["roofline"]
        by_axis = "; ".join(
            f"{a} ({rl['axis_links'].get(a)}): " + ", ".join(
                f"{k} {v:,.0f}" for k, v in kinds.items())
            for a, kinds in rl["coll_by_axis"].items())
        log(f"[mesh] {card}: (d) {key}: OK, peak {peak:,} bytes a device "
            f"(args {rec['argument_size_in_bytes']:,}, temp "
            f"{rec['temp_size_in_bytes']}), collective bytes a device by "
            f"axis: {by_axis}; roofline (derived, H100 peaks) compute "
            f"{rl['compute_s']:.4g} s, memory {rl['memory_s']:.4g} s, "
            f"collective {rl['collective_s']:.4g} s: {rl['bottleneck']}")


def mesh_rank(rank: int, world: int, store: str, out_dir: str,
              seed: int, dev_type: str) -> None:
    """One of (b)'s, (c)'s and (e)'s gloo ranks (spawned): (b) on
    ``dev_type`` (the card; "cpu" in a rehearsal), (c) on
    ``SHARDED_STEP_DEVICE`` at the smoke config, (e) on ``dev_type``
    where ``MOE_MESH_DEVICE`` is the card."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import (NamedSharding, P, init_params,
                                             mesh_shape, use_mesh)
    from repro_torch.train.compress import compressed_psum
    from repro_torch.train.elastic import place, reshard
    from repro_torch.train.train_step import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}
    try:
        # (b) compressed_psum over the 4 ranks' CUDA tensors
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1 + rank)
        x = torch.randn(PSUM_N, generator=gen, device=dev) * (rank + 1)
        pod = init_device_mesh(dev.type, (world,), mesh_dim_names=("pod",))
        got = compressed_psum(x, "pod", pod)
        if rank == 0:
            torch.save(got.cpu(), f"{out_dir}/psum.pt")

        # (c) the sharded dense step at the smoke config
        dev = torch.device(SHARDED_STEP_DEVICE)
        if dev.type == "cpu":      # the host's cores shared by the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // (2 * world)))
        gen = torch.Generator(device=dev)
        cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH),
                                  n_layers=MESH_SHARDED["layers"])
        model = build_model(cfg, device=dev)
        gen.manual_seed(seed)
        params = init_params(model.specs, gen, device=dev)
        rng = np.random.default_rng(seed)
        B, S = MESH_SHARDED["B"], MESH_SHARDED["S"]
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                                .astype(np.int32))
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        mesh = make_host_mesh(device=dev)
        res["mesh"] = mesh_shape(mesh)
        placed = reshard(params, model.specs, mesh)
        bsh = NamedSharding(mesh, P("data", None))
        dbatch = {k: place(v, bsh) for k, v in batch.items()}
        fa = ops.flash_attention
        bhs = []

        def recorder(q, k, v, causal=True):
            bhs.append(int(q.shape[0]))
            return fa(q, k, v, causal=causal)

        fa.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        with use_mesh(mesh), swapped(ops, "flash_attention", recorder):
            loss, _, grads = loss_and_grads(model, placed, dbatch)
        sync(dev)
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["launches"] = fa.launches
        res["calls"] = len(bhs)
        res["bh"] = sorted(set(bhs))
        res["loss"] = float(loss)
        full = {n: g.full_tensor() for n, g in named_leaves(grads)}
        if rank == 0:       # the one-rank step, after the timed one
            _, _, g1 = loss_and_grads(model, params, batch)
            res["errs"] = {n: rms_err(full[n], g)
                           for n, g in named_leaves(g1)}
        del model, params, placed, grads, full

        # (e) the expert-parallel MoE layer at full width
        dev = torch.device(dev_type if MOE_MESH_DEVICE == "cuda" else "cpu")
        res["moe"] = moe_mesh_layer(seed, dev)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def moe_mesh_layer(seed: int, dev) -> dict:
    """(e) on one of the 4 gloo ranks: one ``MOE_ARCH`` MoE layer at full
    width (bf16 weights and tokens from the seed) on a 2x2 (data, model)
    mesh of ``dev``'s tensors, for each ``MOE_MESH_LAYOUTS`` entry, given
    the one-card routes.  Every rank computes the one-card reference on
    the global batch (``route`` chunk by chunk, ``kept_slots``, and
    ``dispatch_scatter`` / ``dispatch_grouped`` given those routes); the
    mesh block's ``route`` is replaced by the reference's routes of this
    rank's tokens (the mesh's own are compared, not held).  Returns this
    rank's findings by layout: its kept slots equal to the reference's
    (``dest`` read from ``moe.mesh_routes``), the error of its block of y,
    the collective bytes counted by kind and axis, the block's seconds
    (a first call and a second), the expert-weight bytes it holds, and
    the slots whose route its own router would flip."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.sharding import (NamedSharding, P, init_params,
                                             mesh_shape, use_mesh)
    from repro_torch.train.elastic import place, reshard

    traffic = MOE_MESH if dev.type == "cuda" else MOE_MESH_CPU
    B, S, c = traffic["B"], traffic["S"], traffic["chunk"]
    base = dataclasses.replace(get_config(MOE_ARCH), moe_seq_chunk=c)
    E, k, d = base.n_experts, base.experts_per_tok, base.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    params = init_params(moe.moe_specs(base), gen, device=dev)
    x = torch.randn((B, S, d), generator=gen, device=dev).to(torch.bfloat16)
    mesh = make_host_mesh(device=dev)
    coord = mesh.get_coordinate()
    b = B // mesh.size(0)
    mine = slice(coord[0] * b, (coord[0] + 1) * b)
    out = {"mesh": mesh_shape(mesh), "device": str(dev), "traffic": traffic}
    for dispatch, sharding in MOE_MESH_LAYOUTS:
        cfg = dataclasses.replace(base, moe_dispatch=dispatch,
                                  moe_sharding=sharding)
        with torch.no_grad():
            # the one-card reference, chunk by chunk
            routes, want = [], []
            for i in range(S // c):
                xc = x[:, i * c:(i + 1) * c]
                if dispatch == "grouped":
                    _, w, idx = moe.route(params, xc, cfg)
                    want.append(moe.dispatch_grouped(params, xc, w, idx, cfg))
                    C = moe.capacity(c, cfg)
                    keep = torch.stack([moe.kept_slots(r, C) for r in idx])
                else:
                    _, w, idx = moe.route(params, xc.reshape(B * c, d), cfg)
                    want.append(moe.dispatch_scatter(
                        params, xc.reshape(B * c, d), w, idx,
                        cfg).view(B, c, d))
                    keep = moe.kept_slots(idx, moe.capacity(B * c, cfg))
                    w, idx, keep = (t.view(B, c, k) for t in (w, idx, keep))
                routes.append((w, idx, keep.view(B, c, k)))
            want = torch.cat(want, dim=1)[mine]
            sync(dev)
            specs = moe.moe_specs(cfg)
            dp = reshard(params, specs, mesh)
            dx = place(x, NamedSharding(mesh, P("data", None, None)))
            real_route, real_routes = moe.route, moe.mesh_routes
            calls, dests, flips = [], [], []

            def replay(p, xl, cfg_):
                # this rank's tokens of the current chunk: their one-card
                # (w, idx), the mesh's own route compared beside them
                probs, w_own, idx_own = real_route(p, xl, cfg_)
                w, idx, _ = routes[len(calls) % len(routes)]
                w, idx = w[mine], idx[mine]
                calls.append(1)
                idx = idx.reshape(idx_own.shape)
                flips.append(int((idx_own[..., :, None] != idx[..., None, :])
                                 .all(-1).sum()))
                return probs, w.reshape(w_own.shape), idx

            def recorded(p, xc, cfg_, lay=None):
                w, dest, aux = real_routes(p, xc, cfg_, lay)
                dests.append(dest.to_local())
                return w, dest, aux

            counter = CollectiveCounter(mesh)
            secs = []
            moe.route, moe.mesh_routes = replay, recorded
            try:
                with use_mesh(mesh):
                    for rep in range(2):
                        calls.clear()
                        dests.clear()
                        flips.clear()
                        sync(dev)
                        t0 = time.perf_counter()
                        if rep:
                            with counter:
                                y, aux = moe.moe_block(dp, dx, cfg)
                        else:
                            y, aux = moe.moe_block(dp, dx, cfg)
                        sync(dev)
                        secs.append(time.perf_counter() - t0)
            finally:
                moe.route, moe.mesh_routes = real_route, real_routes
        got = y.to_local()
        keep_ok = True
        for i, (dest, (_, _, keep)) in enumerate(zip(dests, routes)):
            C = moe.capacity(c if dispatch == "grouped" else B * c, cfg)
            want_keep = keep if dispatch == "scatter" else keep[mine]
            keep_ok = keep_ok and bool(torch.equal(dest < E * C, want_keep))
        held = sum(dp[n].to_local().numel() * dp[n].to_local().element_size()
                   for n in ("wg", "wu", "wd"))
        out[f"{dispatch}-{sharding}"] = dict(
            keep_ok=keep_ok, chunks=len(dests),
            kept=int(sum(int((t < E * moe.capacity(
                c if dispatch == "grouped" else B * c, cfg)).sum())
                for t in dests)),
            equal=bool(torch.equal(got, want)), err=rel_err(got, want),
            finite=bool(torch.isfinite(got.float()).all()),
            aux=float(aux.to_local()), counted=counter.counted,
            secs=secs, expert_bytes=held,
            whole_bytes=sum(params[n].numel() * params[n].element_size()
                            for n in ("wg", "wu", "wd")),
            flips=sum(flips), slots=b * S * k)
        del dp, dx, y, want, routes
    return out


def report_moe_mesh(res: list, card: str) -> dict:
    """(e)'s checks over the ranks' findings (``moe_mesh_layer``) and its
    lines: for each layout the kept slots, y against the one-card
    dispatch (bit for bit, or ``MOE_VS_F32_TOL`` under ``"resident"``),
    the collective bytes by kind and axis, the seconds and the
    expert-weight bytes a rank holds."""
    out = {}
    first = res[0]["moe"]
    traffic = first["traffic"]
    chunks = traffic["S"] // traffic["chunk"]
    where = (f"on the card's tensors ({first['device']})"
             if first["device"].startswith("cuda") else
             f"ON THE CPU, its tokens cut (the card's: {MOE_MESH['B']} x "
             f"{MOE_MESH['S']})")
    for dispatch, sharding in MOE_MESH_LAYOUTS:
        name = f"{dispatch}-{sharding}"
        rows = [r["moe"][name] for r in res]
        tol = MOE_VS_F32_TOL if sharding == "resident" else 0.0
        bad = [i for i, r in enumerate(rows)
               if not (r["keep_ok"] and r["finite"] and r["chunks"] == chunks
                       and (r["equal"] if tol == 0 else r["err"] <= tol))]
        if bad:
            raise SystemExit(
                f"phase 13 (e): {name}: ranks {bad} off the one-card "
                f"dispatch: kept slots equal "
                f"{[r['keep_ok'] for r in rows]}, y equal "
                f"{[r['equal'] for r in rows]}, errors "
                f"{[r['err'] for r in rows]} (bound {tol}), chunks "
                f"{[r['chunks'] for r in rows]} (want {chunks})")
        counted = rows[0]["counted"]
        by_axis = "; ".join(f"{a}: " + ", ".join(
            f"{kd} {v:,.0f}" for kd, v in kinds.items())
            for a, kinds in counted.items())
        secs = [max(r["secs"][i] for r in rows) for i in range(2)]
        held = [r["expert_bytes"] for r in rows]
        how = ("bit for bit" if tol == 0 else
               f"within {tol} (largest {max(r['err'] for r in rows):.3e})")
        log(f"[mesh] {card}: (e) {MOE_ARCH} one MoE layer at full width, "
            f"{name}, {where}, {traffic['B']} x {traffic['S']} tokens in "
            f"{chunks} dispatch chunks on a 2x2 (data, model) gloo mesh: "
            f"every rank's kept slots equal to the one-card kept_slots on "
            f"the global routes ({sum(r['kept'] for r in rows):,} kept "
            f"slots summed over the ranks' views), y {how} of the one-card "
            f"dispatch given those routes (the mesh's own router would "
            f"flip {sum(r['flips'] for r in rows)} of "
            f"{sum(r['slots'] for r in rows):,} slots: logged, not held); "
            f"collective bytes a rank counted by axis and kind: {by_axis}; "
            f"expert weights held a rank {min(held):,}-{max(held):,} bytes "
            f"of {rows[0]['whole_bytes']:,}; the layer {secs[1]:.3f} s "
            f"(slowest rank; its first call {secs[0]:.3f} s)")
        out[name] = dict(counted=counted, secs=secs, expert_bytes=held,
                         whole_bytes=rows[0]["whole_bytes"],
                         err=max(r["err"] for r in rows),
                         flips=sum(r["flips"] for r in rows),
                         device=first["device"], traffic=traffic)
    return out


def stop_dryruns(procs) -> None:
    """Kill and reap any of (d)'s subprocesses still running."""
    for _, p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_mesh(seed: int, card: str, dev, state, model, batch,
               micro: int, dry: dict) -> dict:
    """Phase 13: the mesh.  (a) a one-rank NCCL mesh at full width: phase
    12's live Llama-3.2-3B state resharded onto ``make_host_mesh()``'s
    (1, 1) (``plan_mesh()`` agrees), one step under ``use_mesh`` bit for
    bit the step without a mesh from the same state; (b)
    ``compressed_psum`` over that group and over 4 gloo ranks' CUDA
    tensors; (c) the sharded dense step on those 4 ranks as a 2x2 (data,
    model) mesh, on the CPU at the smoke config (``SHARDED_STEP_DEVICE``);
    (d) the dry-run: ``dry``, the records ``collect_dryruns`` read before
    phase 3 (the subprocesses ran beside phase 1), reported here; (e) one
    full-width MoE layer dispatched expert-parallel on the same 4 ranks
    after (c) (``moe_mesh_layer``, ``report_moe_mesh``).  (b)'s, (c)'s
    and (e)'s ranks start with the phase and run beside (a)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import mesh_shape, use_mesh
    from repro_torch.train.compress import _quantize, compressed_psum
    from repro_torch.train.elastic import plan_mesh, reshard
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase13_")
    # (b) on the card's tensors and (c) on the CPU, on 4 gloo ranks
    ranks = mp.spawn(mesh_rank, args=(MESH_RANKS, f"{tmp}/store", tmp, seed,
                                      dev.type),
                     nprocs=MESH_RANKS, join=False)
    try:
        # (a) the one-rank NCCL mesh at full width
        mesh = make_host_mesh(device=dev)
        planned = plan_mesh(device=dev)
        backend = dist.get_backend()
        shapes = (mesh_shape(mesh), mesh_shape(planned))
        if shapes != ({"data": 1, "model": 1},) * 2:
            raise SystemExit(f"phase 13 (a): host and planned meshes "
                             f"{shapes}, not (1, 1)")
        opt = AdamW(lr=lambda s: TRAIN_LR)
        step_fn = make_train_step(model, opt, microbatches=micro)
        fa = ops.flash_attention
        leaves = state_leaves(state)
        t0 = time.perf_counter()
        # the state's copies (the 36 GB state, four times) in page-locked
        # host memory: pageable copies took most of (a) on the card's host
        pin = dev.type == "cuda"
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                .copy_(t.detach()) for _, t in leaves]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fa.launches = 0
            sync(dev)
            t1 = time.perf_counter()
            state, met_a = step_fn(state, batch)
            sync(dev)
            step_a_ms = (time.perf_counter() - t1) * 1e3
            launches_a = fa.launches
            loss_a = met_a["loss"].detach().cpu()
            # the step's result to the host, the start state back on the card
            for i, (_, t) in enumerate(state_leaves(state)):
                start = host[i].to(t.device, copy=True)
                host[i].copy_(t.detach())
                t.copy_(start)
                del start
            state = reshard(state, model.specs, mesh)
            fa.launches = 0
            t1 = time.perf_counter()
            with use_mesh(mesh):
                state, met_b = step_fn(state, batch)
            sync(dev)
            step_b_ms = (time.perf_counter() - t1) * 1e3
            launches_b = fa.launches
            loss_b = met_b["loss"].detach().cpu()
        finally:
            torch.use_deterministic_algorithms(False)
        unequal = [n for (n, t), h in zip(state_leaves(state), host)
                   if not same_bits(t.detach(), h.to(t.device))]
        del host
        a_s = time.perf_counter() - t0
        if not same_bits(loss_a, loss_b) or unequal:
            raise SystemExit(f"phase 13 (a): the step under the (1, 1) mesh "
                             f"differs from the step without one: loss "
                             f"{float(loss_a)} vs {float(loss_b)}, leaves "
                             f"{unequal[:8]}")
        want_a = micro * flash_per_prefill(model.cfg) * (
            2 if model.cfg.remat else 1)
        if not launches_a == launches_b == want_a:
            raise SystemExit(f"phase 13 (a): flash_attention launched "
                             f"{launches_a} and {launches_b} times, not "
                             f"{want_a}")
        log(f"[mesh] {card}: (a) make_host_mesh() and plan_mesh() are "
            f"(data 1, model 1) on {backend}; phase 12's "
            f"{model.cfg.name} state resharded onto it: one step under "
            f"use_mesh equals the step without a mesh bit for bit (loss "
            f"{float(loss_b):.6f}, {len(leaves)} leaves: every parameter, m, "
            f"v and the step), {want_a} flash launches each (deterministic "
            f"algorithms on); steps {step_a_ms:.1f} ms without the mesh, "
            f"{step_b_ms:.1f} ms under it; (a) {a_s:.1f} s with the state's "
            f"copies through the host")
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        # (b) compressed_psum over the one-rank NCCL group
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        x = torch.randn(PSUM_N, generator=gen, device=dev)
        got = compressed_psum(x, "data", mesh)
        q, scale = _quantize(x)
        if not same_bits(got, q.to(torch.float32) * scale):
            raise SystemExit("phase 13 (b): compressed_psum over one NCCL "
                             "rank is not _quantize's dequantisation")
        dist.destroy_process_group()

        while not ranks.join():
            pass
        spawn_s = time.perf_counter() - t_phase
        xs = []
        for r in range(MESH_RANKS):
            gen.manual_seed(seed + 1 + r)
            xs.append(torch.randn(PSUM_N, generator=gen, device=dev)
                      * (r + 1))
        scale = max(torch.clamp(torch.max(torch.abs(t)), min=1e-12) / 127.0
                    for t in xs)
        total = sum(torch.clamp(torch.round(t / scale), -127, 127)
                    .to(torch.int8).to(torch.int32) for t in xs)
        want = total.to(torch.float32) * scale
        got4 = torch.load(f"{tmp}/psum.pt").to(dev)
        if not same_bits(got4, want):
            raise SystemExit("phase 13 (b): compressed_psum over 4 gloo "
                             "ranks is not the plain int8 sum")
        log(f"[mesh] {card}: (b) compressed_psum of {PSUM_N:,} f32 "
            f"elements: over the one-rank {backend} group bit for bit "
            f"_quantize's dequantisation; over {MESH_RANKS} gloo ranks' "
            f"{dev.type} tensors (gloo's c10d all-reduce takes CUDA tensors: "
            f"no host staging) bit for bit the plain int8 sum computed in "
            f"one process")
        res = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
               for r in range(MESH_RANKS)]
        cfg = get_smoke_config(TRAIN_ARCH)
        local_bh = (MESH_SHARDED["B"] // 2) * (cfg.n_heads // 2)
        per_rank = MESH_SHARDED["layers"] * (2 if cfg.remat else 1)
        bad = [r for r, x in enumerate(res)
               if x["calls"] != per_rank or x["bh"] != [local_bh]
               or x["mesh"] != {"data": 2, "model": 2}]
        if bad:
            raise SystemExit(f"phase 13 (c): ranks {bad} called flash "
                             f"{[x['calls'] for x in res]} times at BH "
                             f"{[x['bh'] for x in res]}, not {per_rank} at "
                             f"{local_bh}")
        errs = res[0]["errs"]
        bound = TRAIN_VS_F32_TOL[""]
        over = {n: e for n, e in errs.items() if not e <= bound}
        if over:
            raise SystemExit(f"phase 13 (c): sharded gradients off the "
                             f"one-rank step's: {over}")
        step_ms = max(x["step_ms"] for x in res)
        log(f"[mesh] {card}: (c) ON THE CPU at the smoke config "
            f"({cfg.name}: d_model {cfg.d_model}, {MESH_SHARDED['layers']} "
            f"layers), not on the card: gloo's functional all-gather of CUDA "
            f"tensors, which DTensor redistributes through, segfaults "
            f"(tools/gloo_cuda_probe.py); {MESH_SHARDED['B']} x "
            f"{MESH_SHARDED['S']} tokens on a 2x2 (data, model) gloo mesh of "
            f"{MESH_RANKS} ranks: every leaf's gradient within {bound} of the "
            f"one-rank step's in the 2-norm (largest "
            f"{max(errs.values()):.3e}, {max(errs, key=errs.get)}); flash's "
            f"plain version called {per_rank} times a rank on its local BH = "
            f"{local_bh}; loss {res[0]['loss']:.6f}; forward and backward "
            f"{step_ms:.1f} ms (slowest rank); the ranks done "
            f"{spawn_s:.1f} s into the phase")
        moe_mesh = report_moe_mesh(res, card)
        report_dryruns(dry, card)
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    log(f"[mesh] {card}: phase 13 took {phase_s:.1f} s")
    return dict(launches=launches_a + launches_b
                + sum(x["launches"] for x in res), a_s=a_s,
                step_a_ms=step_a_ms, step_b_ms=step_b_ms,
                loss_a=float(loss_a), sharded_grad_err=errs,
                sharded_step_ms=step_ms, spawn_s=spawn_s, dryrun=dry,
                moe_mesh=moe_mesh, s=phase_s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--json", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    # the kernels' build and phase 2 (each kernel against its plain
    # version) need the card and not the tables; phase 3's tables and its
    # host references need the host alone: they run side by side, the
    # first in a process of its own (no interpreter lock shared)
    tmp = tempfile.mkdtemp(prefix="smoke_")
    kv_out = f"{tmp}/kernel_vs_plain.json"
    child = multiprocessing.get_context("spawn").Process(
        target=kernel_vs_plain_child, args=(args.seed, kv_out))
    child.start()
    dryruns = []
    try:
        traffic = main_path_traffic(args.seed, card)
        # phase 13 (d) on the host's cores from here, beside phase 2 and
        # the references; waited for before phase 3, so that no timed
        # phase shares the host with it
        t_dry = time.perf_counter()
        dryruns = start_dryruns(tmp)
        main_refs = main_path_references(traffic[0])
        child.join(timeout=KERNEL_VS_PLAIN_TIMEOUT_S)
        if child.exitcode != 0:
            raise SystemExit(f"the kernels' build and phase 2 (each "
                             f"kernel against its plain version) exited "
                             f"{child.exitcode}")
        first = json.loads(Path(kv_out).read_text())
        dry = collect_dryruns(dryruns)
        log(f"[mesh] {card}: (d) the dry-run's {len(dry)} cells done "
            f"{time.perf_counter() - t_dry:.1f} s after their start, beside "
            f"phase 2 and phase 3's references; reported in phase 13")
    finally:
        if child.is_alive():
            child.terminate()
            child.join()
        stop_dryruns(dryruns)
        shutil.rmtree(tmp, ignore_errors=True)
    build_s, kv = first["build_s"], first["kv"]
    log(f"[env] {card}: {len(ops.KERNELS)} kernels built and loaded "
        f"in {build_s:.2f} s")
    ops.load_kernels()               # built above: loaded from the cache
    built = build_report(card)
    for name, r in kv.items():
        how = (f"within rtol = atol = {FLASH_TOL['float32']} (f32), "
               f"{FLASH_TOL['bfloat16']} (bf16) for D up to {r['max_p']}"
               if name == "flash_attention"
               else f"exactly up to P={r['max_p']}")
        log(f"[kernel] {card}: {name}: {r['cases']} cases, kernel == "
            f"plain version {how} (max abs err {r['max_abs_err']}) in "
            f"{r['s']:.1f} s")
    log(f"[main] {card}: the build and phase 2 beside phase 3's tables "
        f"and references: {time.perf_counter() - t_start:.1f} s")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    js = phase_join_summary(args.seed, card, dev)
    log(f"[summary] {card}: phase 14 took {time.perf_counter() - t0:.1f} s")
    ctx, mp = phase_main_path(args.seed, args.batches, card, dev,
                              traffic=traffic, refs=main_refs)
    del traffic, main_refs
    t0 = time.perf_counter()
    pq = phase_per_query(ctx, card, dev)
    log(f"[per-query] {card}: phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    it = phase_tree_ingest(ctx, args.seed, TREE_BATCHES, card, dev)
    log(f"[tree] {card}: phase 6 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sv = phase_serving(ctx, args.seed, card, dev)
    log(f"[serving] {card}: phase 7 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    an = phase_answers(ctx, args.seed, card, dev)
    an["s"] = time.perf_counter() - t0
    log(f"[answers] {card}: phase 8 took {an['s']:.1f} s")
    del ctx
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = phase_lm(args.seed, card, dev)
    log(f"[lm] {card}: phase 5 took {time.perf_counter() - t0:.1f} s")
    gc.collect()           # phase 5's batcher and its model hold a cycle
    torch.cuda.empty_cache()
    mo = phase_moe(args.seed, card, dev)
    log(f"[moe] {card}: phase 9 took {mo['s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ex = phase_examples(card, dev)
    log(f"[examples] {card}: phase 10 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fm = phase_families(args.seed, card, dev)
    log(f"[families] {card}: phase 11 took "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tr = phase_train(args.seed, card, dev)
    state, model, batch, micro = tr.pop("handoff")
    me = phase_mesh(args.seed, card, dev, state, model, batch, micro, dry)
    del state, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    fl = lm["kernels"]["flash_attention"]
    fl["launches"] += (mo["launches"] + tr["launches"] + me["launches"]
                       + sum(r["launches"] for r in fm.values()))
    fl["max_abs_err"] = max(fl["max_abs_err"], mo["max_abs_err"],
                            tr["max_abs_err"],
                            *(r["max_abs_err"] for r in fm.values()))
    found = {**mp["kernels"], **pq["kernels"], **lm["kernels"]}
    log(f"[done] {card}: {time.perf_counter() - t_start:.1f} s in all")

    rows = []
    for name, (path, _stage, replaces) in KERNELS.items():
        k = found[path if path in MAIN_KERNELS else name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces,
            launches=(k["launches"] + it["launches"].get(path, 0)
                      + sv["launches"].get(path, 0)
                      + an["launches"].get(path, 0)),
            max_abs_err=max(kv[name]["max_abs_err"], k["max_abs_err"],
                            sv["shard_max_abs_err"].get(name, 0.0)),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    kernels = {"kernels": rows}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, build_s=build_s,
                 build=built, kernel_vs_plain=kv, main_path=mp, per_query_path=pq,
                 ingest_tree=it, serving=sv, answers=an, lm_serving=lm,
                 moe_serving=mo, examples=ex, families=fm, training=tr,
                 mesh=me, join_summary=js, **kernels),
            indent=1))
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
