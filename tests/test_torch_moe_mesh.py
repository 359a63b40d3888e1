"""The port's expert-parallel MoE block on a mesh against the one-card
``moe_block`` and the JAX package's, on the CPU.

The port's side runs once, in 4 gloo processes spawned on a ``FileStore``
under a temporary directory (no TCP port), as a 2x2 (data, model) mesh;
the JAX side runs in a subprocess with 4 host devices as a 2x2
``jax.sharding.Mesh`` (Auto axes, ROADMAP R3) under its ``use_mesh``.
The configs are the smoke configs of ``qwen3-moe-30b-a3b`` (E = 4) and
``kimi-k2-1t-a32b`` (E = 8) in f32, dispatched in chunks of 8 positions
(``moe_seq_chunk``), the inputs numpy-seeded.

Bounds (the dense sharded step's, ``tests/test_torch_mesh_train.py``):
* each rank's kept and dropped slots equal exactly those of the one-card
  ``kept_slots`` on the global routes, chunk by chunk;
* ``y`` within 1e-5 of its largest magnitude of the one-card
  ``moe_block`` on the global batch (the d_ff shards' sums and the aux
  loss's mean add in other orders) and of the JAX ``moe_block`` on its
  mesh; the aux loss within 1e-6 relative;
* a sharded MoE ``loss_and_grads``: the loss within 1e-5 relative of the
  unsharded port step, every gradient within 1e-5 of its leaf's largest
  magnitude;
* a prefill and two decode steps on the mesh: the logits within 1e-5 of
  the unsharded port's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, moe
from repro_torch.models.sharding import tree_map
from repro_torch.train.train_step import loss_and_grads

torch.set_num_threads(1)

WORLD = 4
TOL = 1e-5
AUX_TOL = 1e-6
B, S, CHUNK = 4, 16, 8
ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
LAYOUTS = [(dispatch, sharding) for dispatch in ("scatter", "grouped")
           for sharding in ("fsdp", "expert_only", "resident")]
# name -> (arch, overrides): every layout of both configs, and one whose
# 5 experts divide neither mesh axis (they replicate)
CASES = {f"{a.split('-')[0]}-{d}-{s}": (a, dict(moe_dispatch=d,
                                               moe_sharding=s))
         for a in ARCHS for d, s in LAYOUTS}
CASES["qwen3-scatter-fsdp-e5"] = (ARCHS[0], dict(n_experts=5))
CASES["qwen3-grouped-resident-e5"] = (ARCHS[0], dict(
    n_experts=5, moe_dispatch="grouped", moe_sharding="resident"))
STEP_LAYOUTS = {"scatter-fsdp": dict(),
                "grouped-resident": dict(moe_dispatch="grouped",
                                         moe_sharding="resident"),
                "scatter-resident": dict(moe_sharding="resident")}


def _cfg(arch, **overrides):
    return dataclasses.replace(get_smoke_config(arch), moe_seq_chunk=CHUNK,
                               **overrides)


def _block_inputs(cfg, seed):
    """f32 router and expert weights and x [B, S, d], numpy-seeded."""
    rng = np.random.default_rng(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(0, 0.3, (d, E)),
         "wg": rng.normal(0, 0.1, (E, d, f)),
         "wu": rng.normal(0, 0.1, (E, d, f)),
         "wd": rng.normal(0, 0.1, (E, f, d))}
    x = rng.normal(0, 1, (B, S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _tokens(vocab, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess with 4 host devices
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_smoke_config
    from repro.models import moe
    from repro.models.sharding import logical_to_pspec, use_mesh

    out_dir = sys.argv[1]
    cases = json.loads(sys.argv[2])
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"), **kw)
    out = {}
    for name, (arch, over, chunk) in cases.items():
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  moe_seq_chunk=chunk, **over)
        with np.load(f"{out_dir}/in_{name}.npz") as f:
            arrs = dict(f)
        specs = moe.moe_specs(cfg)
        p = {k: jax.device_put(jnp.asarray(arrs[k]), NamedSharding(
                 mesh, logical_to_pspec(specs[k].logical, specs[k].shape,
                                        mesh)))
             for k in specs}
        x = jax.device_put(jnp.asarray(arrs["x"]), NamedSharding(
            mesh, logical_to_pspec(("batch", "seq", "embed"),
                                   arrs["x"].shape, mesh)))
        with use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(p, x)
        out[name] = np.asarray(y)
    np.savez(f"{out_dir}/jax_y.npz", **out)
    print("JAX_SIDE_OK")
""")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs, the JAX side's outputs and the port's 4-rank run's
    outputs, all under one temporary directory."""
    d = tmp_path_factory.mktemp("moe_mesh")
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        p, x = _block_inputs(_cfg(arch, **over), seed=i)
        np.savez(d / f"in_{name}.npz", x=x, **p)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_cases = {n: (a, o, CHUNK) for n, (a, o) in CASES.items()}
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d),
                        json.dumps(jax_cases)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert "JAX_SIDE_OK" in r.stdout, r.stderr[-3000:]
    mp.spawn(_port_worker, args=(WORLD, str(d / "store"), str(d)),
             nprocs=WORLD, join=True)
    return d


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------

def _port_worker(rank, world, store, out_dir):
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(device="cpu")
        res = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
               "groups": _groups(mesh)}
        ys = {}
        for name, (arch, over) in CASES.items():
            res[name], ys[name] = _block_case(mesh, _cfg(arch, **over),
                                              f"{out_dir}/in_{name}.npz")
        for name, over in STEP_LAYOUTS.items():
            res[f"step-{name}"] = _step_case(mesh, over)
        res["serve"] = _serve_err(mesh)
        if rank == 0:
            np.savez(f"{out_dir}/port_y.npz", **ys)
        with open(f"{out_dir}/res{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _groups(mesh):
    """``axis_group`` of the logical axes the dispatch reads, as the mesh
    dim each names (None: replicated), under the default rules and with
    ``"experts"`` moved to ``data``."""
    from repro_torch.models.sharding import axis_group, use_mesh

    def dim(g):
        return None if g is None else [g[0] is mesh, g[1]]

    out = {}
    for name, rules in (("default", None), ("moved", {"experts": "data"})):
        with use_mesh(mesh, rules):
            out[name] = {f"{ax}/{n}": dim(axis_group(ax, n)) for ax, n in (
                ("batch", 4), ("batch", 3), ("experts", 8), ("experts", 5),
                ("experts_resident", 8), ("moe_ff", 32))}
    return out


def _block_case(mesh, cfg, path):
    """moe_block on the mesh against the one-card block on the global
    batch: (this rank's findings, y whole)."""
    from repro_torch.models.sharding import (NamedSharding, P, tree_shardings,
                                             use_mesh)
    from repro_torch.train.elastic import place

    with np.load(path) as f:
        arrs = {k: torch.from_numpy(v) for k, v in f.items()}
    x = arrs.pop("x")
    specs = moe.moe_specs(cfg)
    want_y, want_aux = moe.moe_block(arrs, x, cfg)
    shapes = []
    real = moe._experts

    def recorder(p, xe, cfg):
        shapes.append([list(p[n].shape) for n in ("wg", "wu", "wd")])
        return real(p, xe, cfg)

    with use_mesh(mesh):
        sh = tree_shardings(specs, mesh)
        dp = {k: place(v, sh[k]) for k, v in arrs.items()}
        dx = place(x, NamedSharding(mesh, P("data", None, None)))
        moe._experts = recorder
        try:
            y, aux = moe.moe_block(dp, dx, cfg)
        finally:
            moe._experts = real
        # each chunk's kept slots on this rank against the one-card ones
        keep_ok = True
        for i in range(S // CHUNK):
            sl = slice(i * CHUNK, (i + 1) * CHUNK)
            w, dest, _ = moe.mesh_routes(dp, dx[:, sl], cfg)
            _, _, idx = moe.route(arrs, x[:, sl], cfg)
            if cfg.moe_dispatch == "grouped":
                C = moe.capacity(CHUNK, cfg)
                want = torch.stack([moe.kept_slots(r.reshape(-1, cfg.
                                    experts_per_tok), C) for r in idx])
                got = dest.to_local() < cfg.n_experts * C
                lo = mesh.get_coordinate()[0] * got.shape[0]
                want = want[lo:lo + got.shape[0]].view(got.shape)
            else:
                C = moe.capacity(B * CHUNK, cfg)
                want = moe.kept_slots(idx.reshape(-1, cfg.experts_per_tok), C)
                got = dest.to_local() < cfg.n_experts * C
                want = want.view(got.shape)
            keep_ok = keep_ok and bool(torch.equal(got, want))
        y_full = y.full_tensor()
    local = {n: list(dp[n].to_local().shape) for n in ("wg", "wu", "wd")}
    return dict(
        keep_ok=keep_ok,
        y_err=float((y_full - want_y).abs().max() / want_y.abs().max()),
        aux=float(aux.full_tensor()), want_aux=float(want_aux),
        shapes=shapes, local=local), y_full.numpy()


def _step_case(mesh, over):
    """A sharded MoE loss_and_grads on the smoke model against the
    unsharded port step: (loss rel err, largest grad err / leaf max)."""
    from repro_torch.models.sharding import (NamedSharding, P, init_params,
                                             use_mesh)
    from repro_torch.train.elastic import place, reshard

    cfg = _cfg(ARCHS[0], **over)
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda t: t.float(), init_params(
        model.specs, torch.Generator().manual_seed(5), device="cpu"))
    toks = _tokens(cfg.vocab, 6, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    loss1, _, g1 = loss_and_grads(model, params, batch)
    dp = reshard(params, model.specs, mesh)
    bsh = NamedSharding(mesh, P("data", None))
    dbatch = {k: place(v, bsh) for k, v in batch.items()}
    with use_mesh(mesh):
        loss, _, grads = loss_and_grads(model, dp, dbatch)
    errs = []
    for gm, g in zip(_leaves(grads), _leaves(g1)):
        gm = gm.full_tensor() if hasattr(gm, "full_tensor") else gm
        errs.append(float((gm - g).abs().max() / g.abs().max()))
    return dict(loss_err=abs(float(loss) - float(loss1)) / abs(float(loss1)),
                grad_err=max(errs))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _serve_err(mesh):
    """The largest |sharded - unsharded| / max |unsharded| over the f32
    logits of a prefill of 4 x 12 tokens into a cache of 16 positions and
    two decode steps, the MoE smoke model on the mesh."""
    from repro_torch.launch.specs import arch_rules
    from repro_torch.models.sharding import (NamedSharding, P, init_params,
                                             use_mesh)
    from repro_torch.train.elastic import place, reshard

    cfg = _cfg(ARCHS[1])
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda t: t.float(), init_params(
        model.specs, torch.Generator().manual_seed(3), device="cpu"))
    prompt = torch.from_numpy(_tokens(cfg.vocab, 4, (4, 12)))
    steps = torch.from_numpy(_tokens(cfg.vocab, 7, (2, 4, 1)))
    want = []
    logits, cache = model.prefill_fn(params, {"tokens": prompt}, 16)
    want.append(logits)
    for i in range(2):
        logits, cache = model.decode_fn(params, cache, steps[i],
                                        torch.full((4,), 12 + i))
        want.append(logits)
    rules = arch_rules(cfg, mesh, "decode")
    dp = reshard(params, model.specs, mesh, rules)
    bsh = NamedSharding(mesh, P("data", None))
    got = []
    with use_mesh(mesh, rules):
        logits, cache = model.prefill_fn(dp, {"tokens": place(prompt, bsh)},
                                         16)
        got.append(logits.full_tensor())
        for i in range(2):
            logits, cache = model.decode_fn(
                dp, cache, place(steps[i], bsh),
                place(torch.full((4,), 12 + i),
                      NamedSharding(mesh, P("data"))))
            got.append(logits.full_tensor())
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _results(d):
    return [json.loads((d / f"res{r}.json").read_text())
            for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_the_ranks_form_a_2x2_data_model_mesh(work):
    for res in _results(work):
        assert res["mesh"] == [["data", "model"], [2, 2]]


def test_axis_group_follows_the_rules_and_divisibility(work):
    """The group of a logical axis is its mesh dim on the active mesh
    under the active rules, None where the dim does not divide."""
    want = {"batch/4": [True, 0], "batch/3": None, "experts/8": [True, 1],
            "experts/5": None, "experts_resident/8": [True, 0],
            "moe_ff/32": [True, 1]}
    for res in _results(work):
        assert res["groups"]["default"] == want
        assert res["groups"]["moved"] == dict(want, **{
            "experts/8": [True, 0]})


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_slots_equal_the_one_card_dispatch(case, work):
    for r, res in enumerate(_results(work)):
        assert res[case]["keep_ok"], (case, r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_y_and_aux_match_the_one_card_block(case, work):
    for r, res in enumerate(_results(work)):
        c = res[case]
        assert c["y_err"] <= TOL, (case, r, c["y_err"])
        assert abs(c["aux"] - c["want_aux"]) <= AUX_TOL * abs(c["want_aux"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_y_matches_the_jax_block_on_a_jax_mesh(case, work):
    with np.load(work / "jax_y.npz") as f:
        want = f[case]
    with np.load(work / "port_y.npz") as f:
        got = f[case]
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), case


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_weights_keep_their_local_shards(case, work):
    """Inside the block each rank's wg / wu / wd have the local shapes of
    their shards (the experts never gathered): E / 2 experts where they
    divide their axis, d_ff / 2 under ``"resident"``."""
    arch, over = CASES[case]
    cfg = _cfg(arch, **over)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    e = E // 2 if E % 2 == 0 else E
    ff = f // 2 if cfg.moe_sharding == "resident" else f
    want = [[e, d, ff], [e, d, ff], [e, ff, d]]
    for res in _results(work):
        c = res[case]
        assert [c["local"][n] for n in ("wg", "wu", "wd")] == want
        assert c["shapes"] and all(s == want for s in c["shapes"])


@pytest.mark.parametrize("layout", sorted(STEP_LAYOUTS))
def test_sharded_moe_step_matches_unsharded(layout, work):
    for r, res in enumerate(_results(work)):
        c = res[f"step-{layout}"]
        assert c["loss_err"] <= TOL, (r, c)
        assert c["grad_err"] <= TOL, (r, c)


def test_sharded_moe_prefill_and_decode_match_unsharded(work):
    for r, res in enumerate(_results(work)):
        assert res["serve"] <= TOL, (r, res["serve"])


def test_one_card_block_unchanged_off_the_mesh():
    """Without a mesh ``moe_block`` is the one-card dispatch chunk by
    chunk, bit for bit."""
    cfg = _cfg(ARCHS[0])
    p, x = _block_inputs(cfg, seed=11)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x)
    y, aux = moe.moe_block(p, x, cfg)
    want = torch.cat([moe._moe_dispatch(p, x[:, i:i + CHUNK], cfg)[0]
                      for i in range(0, S, CHUNK)], dim=1)
    assert torch.equal(y, want)
