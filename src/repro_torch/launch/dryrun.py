"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
a fake process group, with nothing allocated.

The counterpart of the JAX package's ``launch/dryrun.py`` (same flags,
same record fields), which lowers and compiles each cell for 512 virtual
devices.  Here, for each cell:

  * the production mesh is built over a ``"fake"`` process group of
    ``REPRO_DRYRUN_DEVICES`` ranks (default 512; ``REPRO_MESH_SCALE``
    shrinks the mesh as in the JAX package), as rank 0 of it;
  * under ``FakeTensorMode`` the state (train) or the parameters, batch
    and cache (prefill, decode) are made at full size and placed on the
    production shardings by ``reshard`` / ``place``: DTensors whose local
    shards are fake, so a full-width cell allocates nothing;
  * the cell's step runs once under ``use_mesh``, and ``CollectiveCounter``
    (a ``TorchDispatchMode`` in the manner of DTensor's ``CommDebugMode``)
    adds the bytes of every c10d functional collective by kind and by mesh
    axis;
  * the record carries the argument, output and alias bytes a device
    (exact, from the local shard shapes), the temp bytes from
    ``MemTracker`` where it runs under fake mode (else null, never an
    estimate), ``peak_bytes_per_device`` and the roofline with H100 terms
    (``roofline.py``).  Every figure is derived, none measured.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import get_config, get_smoke_config, list_archs
from ..configs.base import SHAPES, shape_supported
from ..kernels import ops
from ..kernels.ref import flash_attention_bwd_ref
from ..models import build_model
from ..models import model as M
from ..models.sharding import (mesh_ranks, mesh_shape, tree_map,
                               tree_shardings, use_mesh)
from ..train.elastic import place, reshard
from ..train.optimizer import AdamW, cosine_schedule
from ..train.train_step import TrainState, make_train_step
from . import roofline as RL
from .mesh import make_production_mesh
from .specs import (arch_rules, decode_specs, prefill_batch_specs,
                    train_batch_specs)

_C10D = "_c10d_functional"


class CollectiveCounter(TorchDispatchMode):
    """Counts the bytes a device of every c10d functional collective issued
    under it, by kind and by mesh axis: ``counted[axis][kind]``.  A
    collective adds its largest tensor (the gathered output of an
    all-gather, the input of a reduce-scatter), as the JAX dry-run counts
    an HLO collective's largest shape.

    A collective's group is named by the mesh dims whose ranks it spans
    (``"model"``, or ``"data+model"`` for a group DTensor flattened over
    two dims), found from the group's ranks, so a group made by another
    mesh object of the same layout counts under the same axis; ``links``
    holds each axis's link class (``roofline.link_of``)."""

    KINDS = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce",
             "all_to_all_single": "all-to-all",
             "broadcast": "broadcast"}

    def __init__(self, mesh):
        super().__init__()
        ranks = mesh_ranks(mesh)
        here = [int(i[0]) for i in
                (ranks == torch.distributed.get_rank()).nonzero().T]
        names = mesh.mesh_dim_names
        # rank set -> axis label, for every non-empty set of mesh dims
        self.by_ranks = {}
        for n in range(len(names), 0, -1):
            for dims in itertools.combinations(range(len(names)), n):
                idx = tuple(slice(None) if d in dims else here[d]
                            for d in range(len(names)))
                key = frozenset(int(r) for r in ranks[idx].reshape(-1))
                self.by_ranks[key] = "+".join(names[d] for d in dims)
        self.counted: Dict[str, Dict[str, float]] = {}
        self.links: Dict[str, str] = {}
        self._axis = {}

    def axis(self, group_name: str) -> str:
        if group_name not in self._axis:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group, get_process_group_ranks)
            ranks = get_process_group_ranks(
                _resolve_process_group(group_name))
            label = self.by_ranks.get(frozenset(ranks), f"ranks{ranks}")
            self._axis[group_name] = label
            self.links[label] = RL.link_of(ranks)
        return self._axis[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == _C10D and name in self.KINDS:
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            axis = self.axis(group)
            nbytes = max(_nbytes(args[0]), _nbytes(out))
            kinds = self.counted.setdefault(axis, {})
            kind = self.KINDS[name]
            kinds[kind] = kinds.get(kind, 0.0) + float(nbytes)
        return out


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's tensors (dicts, named
    tuples, tuples; None holds none)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _tensors(tree):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _FlashFootprint(torch.autograd.Function):
    """The flash kernel as the card runs it, on fake tensors: the forward
    allocates the kernel's output and saves q, k and v (what
    ``FlashAttention`` does on the card; its CUDA launch cannot run on
    fake tensors, and the plain forward the CPU would run holds the whole
    [BH, Sq, Sk] f32 scores, which the kernel never does); the backward is
    the card's, the plain ``flash_attention_bwd_ref`` in BH blocks."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd_ref(q, k, v, do.contiguous(),
                                         ctx.causal), None)


def _flash_footprint(q, k, v, causal: bool = True):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFootprint.apply(q, k, v, bool(causal))
    return torch.empty_like(q)


def _cell_config(arch: str, shape_name: str, overrides, smoke: bool):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 128),
            global_batch=min(shape.global_batch, 16))
        if cfg.family == "vlm":
            shape = dataclasses.replace(
                shape, seq_len=max(shape.seq_len, cfg.n_prefix * 2))
    return cfg, shape


def _empty(t):
    """A fake tensor shaped like ``t`` (a meta tensor or a ParamSpec)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype)


def _place_tree(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings)


def _run_step(cfg, shape, mesh, rules, counter):
    """The cell's step on fake DTensors: (argument, output, alias bytes a
    device, temp bytes or None)."""
    model = build_model(cfg, device="cpu")
    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4),
                    state_dtype=getattr(torch, cfg.optimizer_state_dtype))
        params = tree_map(_empty, model.specs)
        state = reshard(TrainState(params, opt.init(params)), model.specs,
                        mesh, rules)
        batch, batch_sh = train_batch_specs(cfg, shape, mesh)
        batch = _place_tree(tree_map(_empty, batch), batch_sh)
        args = (state, batch)
        step = make_train_step(model, opt)
        run = lambda: step(state, batch)
        alias = state      # updated in place: the JAX step donates it
    else:
        params = _place_tree(tree_map(_empty, model.specs),
                             tree_shardings(model.specs, mesh, rules))
        if shape.kind == "prefill":
            batch, batch_sh = prefill_batch_specs(cfg, shape, mesh)
            batch = _place_tree(tree_map(_empty, batch), batch_sh)
            args = (params, batch)
            run = lambda: model.prefill_fn(params, batch, shape.seq_len)
            alias = None
        else:
            (cache, tokens, position), (cache_sh, tok_sh, pos_sh) = \
                decode_specs(cfg, shape, mesh, model)
            cache = _place_tree(tree_map(_empty, cache), cache_sh)
            tokens = place(_empty(tokens), tok_sh)
            position = place(_empty(position), pos_sh)
            args = (params, cache, tokens, position)
            run = lambda: model.decode_fn(params, cache, tokens, position)
            alias = cache  # written in place: the JAX step donates it
    real_flash, ops.flash_attention = ops.flash_attention, _flash_footprint
    # fake tensors give the MoE dispatch's kept slots a new unknown size
    # at each run, which remat's recompute metadata check cannot compare
    check, M.REMAT_DETERMINISM_CHECK = M.REMAT_DETERMINISM_CHECK, "none"
    try:
        with use_mesh(mesh, rules), counter:
            out, temp = _measure(run, _mem_tracker(cfg, mesh), args)
    finally:
        ops.flash_attention = real_flash
        M.REMAT_DETERMINISM_CHECK = check
    return (_local_bytes(args), _local_bytes(out), _local_bytes(alias),
            temp)


def _measure(run, tracker, args):
    """(the step's outputs, its temp bytes from MemTracker: the peak of
    the live tensors it saw, the arguments' bytes taken off; or None).

    DTensor derives each op's global output shape by running the op on
    global-shape fake tensors, which MemTracker would count as the step's
    (some releases tell them apart by their fake mode, some do not).  So
    while it tracks, that derivation runs with every dispatch mode set
    aside: in a fake mode of its own, seen by neither MemTracker nor the
    collective counter (it issues no collective)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    if tracker is None:
        return run(), None
    derive = ShardingPropagator._propagate_tensor_meta_non_cached

    def untracked(self, op_schema):
        with _disable_current_modes():
            return derive(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = untracked
    try:
        with tracker:
            out = run()
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = derive
    peak = tracker.get_tracker_snapshot("peak").get(torch.device("cpu"), {})
    return out, max(0, peak.get("Total", 0) - _local_bytes(args))


def _mem_tracker(cfg, mesh):
    """``MemTracker`` where it runs under fake mode, else None (the
    record's temp bytes are then null).  It does not run for the MoE
    family on a mesh of one rank: the one-card dispatch's kept slots
    (``nonzero``) have sizes that depend on the routing, which fake mode
    leaves unknown, and MemTracker cannot add up a tensor of unknown
    size.  On a larger mesh the expert-parallel dispatch's shapes are
    static (its ``"scatter"`` + ``"resident"`` exchange, whose splits
    depend on the routing, does not run under fake mode at all)."""
    if cfg.family == "moe" and mesh.size() == 1:
        return None
    from torch.distributed._tools.mem_tracker import MemTracker
    return MemTracker()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, smoke: bool = False) -> dict:
    """One cell's record (``status`` OK, SKIP or FAIL)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": 512 if multi_pod else 256}
    try:
        cfg, shape = _cell_config(arch, shape_name, overrides, smoke)
        skip = shape_supported(cfg, shape_name)
        if skip is not None:
            rec.update(status="SKIP", reason=skip)
            return rec
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rec["mesh_shape"] = mesh_shape(mesh)
        if mesh.size() > dist.get_world_size():
            raise ValueError(f"the mesh has {mesh.size()} ranks, the fake "
                             f"group {dist.get_world_size()}")
        rules = arch_rules(cfg, mesh, kind=shape.kind)
        counter = CollectiveCounter(mesh)
        # a shape environment lets the MoE dispatch's boolean-mask
        # indexing (``nonzero``) take data-dependent sizes
        with FakeTensorMode(allow_non_fake_inputs=True,
                            shape_env=ShapeEnv()):
            args, out, alias, temp = _run_step(cfg, shape, mesh, rules,
                                               counter)
        rec["status"] = "OK"
        rec["compile_s"] = round(time.time() - t0, 1)
        rec.update(argument_size_in_bytes=args, output_size_in_bytes=out,
                   temp_size_in_bytes=temp, alias_size_in_bytes=alias)
        rec["peak_bytes_per_device"] = args + out + (temp or 0) - alias
        rl = RL.derive(cfg, shape, counter.counted, rec["chips"],
                       counter.links)
        rec["roofline"] = rl.to_dict()
        return rec
    except Exception as e:  # noqa: BLE001 — a failed cell is a result
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        return rec


def init_fake_group(world: int) -> None:
    """Rank 0 of a ``"fake"`` process group of ``world`` ranks: collectives
    complete at once and move nothing (an internal torch test module,
    imported here only)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 mesh (default: single-pod 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs/shapes: validates the code path")
    ap.add_argument("--opt", action="store_true",
                    help="the JAX package's optimization overrides: "
                         "resident-MoE sharding, TP-resident decode "
                         "weights, vocab padding")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    opt_overrides = dict(moe_dispatch="grouped", moe_sharding="expert_only",
                         serve_resident=True,
                         pad_vocab_to=128) if args.opt else None

    init_fake_group(int(os.environ.get("REPRO_DRYRUN_DEVICES", "512")))
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch, shape, mp in cells:
        key = (arch, shape, "2x16x16" if mp else "16x16")
        if key in done:
            print(f"[dryrun] {key} cached", flush=True)
            continue
        print(f"[dryrun] {key} ...", flush=True)
        rec = run_cell(arch, shape, mp, overrides=opt_overrides,
                       smoke=args.smoke)
        extra = rec.get("reason") or rec.get("error") or ""
        peak = rec.get("peak_bytes_per_device")
        peak_s = f" peak={peak / 2**30:.2f}GiB" if peak else ""
        rl = rec.get("roofline") or {}
        bn = f" bottleneck={rl.get('bottleneck')}" if rl else ""
        print(f"[dryrun] {key} -> {rec['status']}{peak_s}{bn} {extra}",
              flush=True)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"[dryrun] total={len(results)} ok={n_ok} skip={n_skip} "
          f"fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
