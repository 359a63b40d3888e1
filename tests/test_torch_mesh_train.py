"""The port's mesh-side training pieces against the JAX package's, on the
CPU: ``compressed_psum``, ``plan_mesh``, the elastic drill
(``checkpoint.restore(shardings=)`` + ``reshard``), the sharded train
step and AdamW on DTensors.

The port's multi-rank side runs once, in 4 gloo processes spawned on a
``FileStore`` under a temporary directory (no TCP port); the JAX side
runs in a subprocess with 16 host devices (meshes built with
``jax.sharding.Mesh``, as ``plan_mesh`` does).  The model is the JAX
train tests' tiny one (``default_config(vocab=128)`` cut to 2 layers of
width 64), its parameters from the JAX ``init_state(PRNGKey(0))`` cast to
f32, the batch numpy-seeded.

Bounds:
* ``compressed_psum``: bit for bit the JAX ``shard_map`` result on the
  same per-rank inputs, and within 2/127 of the plain sum, as the JAX
  test asserts of its one-device case;
* ``plan_mesh``: the same (data, model) shape as JAX's for 1-16 ranks;
* the elastic drill: every rank's shard of every leaf bit for bit the
  JAX shard on the device at the same mesh coordinate;
* the sharded step on a 2x2 (data, model) mesh: the loss within 1e-5
  relative of the unsharded port step's and of JAX's ``loss_fn``, every
  gradient within 1e-5 of its leaf's largest magnitude (the shards sum in
  other orders);
* AdamW on DTensors, fed the same gradients: every parameter, m and v
  within 1 ulp of the unsharded update (the global norm sums its shards
  in another order);
* a prefill and two decode steps on the 2x2 mesh, with the KV cache's
  heads sharded and with its sequence sharded: the logits within 1e-5
  of the unsharded port's.
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

import jax
import jax.numpy as jnp

from repro.launch.train import default_config as r_default_config
from repro.models import build_model as r_build
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch.launch.train import default_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.sharding import (NamedSharding, P, tree_leaves,
                                         tree_map, tree_shardings, use_mesh)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compress import compressed_psum
from repro_torch.train.elastic import plan_mesh, reshard
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.train_step import (TrainState, abstract_state,
                                          loss_and_grads)

torch.set_num_threads(1)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
WORLD = 4
LR = 1e-3
GRAD_TOL = 1e-5


def _cfg():
    return dataclasses.replace(default_config(vocab=128), **TINY)


def _batch(vocab=128, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _psum_inputs():
    """One row a rank, in [-1, 1], the ranks' scales unequal."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(WORLD, 64)).astype(np.float32)
    x[1] *= 0.3
    return x


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}" if prefix
                                    else k).items()}
    return {prefix: tree}


def _state_sh(model, mesh):
    """The NamedSharding tree of a TrainState: params, m and v on the
    param shardings, the step replicated."""
    sh = tree_shardings(model.specs, mesh)
    return TrainState(sh, AdamWState(NamedSharding(mesh, P()), sh, sh), None)


def _grads_np(params, seed=9):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: rng.normal(size=tuple(p.shape))
                    .astype(np.float32), params)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess with 16 host devices
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.launch.train import default_config
    from repro.models import build_model
    from repro.train import checkpoint as ckpt
    from repro.train.compress import compressed_psum
    from repro.train.elastic import plan_mesh, reshard
    from repro.train.optimizer import AdamW
    from repro.train.train_step import init_state

    out_dir = sys.argv[1]
    devs = jax.devices()
    # compressed_psum over 4 devices, one row of the inputs each
    x = np.load(out_dir + "/psum_in.npy")
    mesh = Mesh(np.array(devs[:4]), ("pod",))
    f = shard_map(lambda v: compressed_psum(v, "pod"), mesh=mesh,
                  in_specs=P("pod"), out_specs=P("pod"))
    np.save(out_dir + "/psum_jax.npy", np.asarray(f(jnp.asarray(x))))
    # plan_mesh shapes
    shapes = {}
    for mp in (1, 2, 4, 8, 16):
        for n in range(1, 17):
            m = plan_mesh(devs[:n], model_parallel=mp)
            shapes[f"{n},{mp}"] = [m.shape["data"], m.shape["model"]]
    json.dump(shapes, open(out_dir + "/plan_jax.json", "w"))
    # the elastic drill: save, plan on 4 survivors, restore, reshard
    TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    cfg = dataclasses.replace(default_config(vocab=128), **TINY)
    model = build_model(cfg)
    opt = AdamW(lr=lambda s: 1e-3)
    state = init_state(model, opt, jax.random.PRNGKey(0))
    ckpt.save(out_dir + "/elastic_ck", 3, state)
    mesh = plan_mesh(devs[:4], model_parallel=2)
    restored, _ = ckpt.restore(out_dir + "/elastic_ck", 3, state)
    resharded = reshard(restored, model.specs, mesh)
    shards = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(resharded)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx",
                       getattr(p, "name", p)))) for p in path)
        for s in leaf.addressable_shards:
            a = np.asarray(s.data)
            if a.dtype == jnp.bfloat16:
                a = a.view(np.uint16)
            shards[f"{key}@{s.device.id}"] = a
    np.savez(out_dir + "/shards_jax.npz", **shards)
    print("JAX_SIDE_OK")
""")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Inputs shared by both sides, the JAX side's outputs, and the port's
    4-rank run's outputs, all under one temporary directory."""
    d = tmp_path_factory.mktemp("mesh_train")
    np.save(d / "psum_in.npy", _psum_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert "JAX_SIDE_OK" in r.stdout, r.stderr[-3000:]
    # the JAX parameters (f32) and the batch for the sharded step
    rcfg = dataclasses.replace(r_default_config(vocab=128), **TINY)
    rmodel = r_build(rcfg)
    opt = RO.AdamW(lr=lambda s: LR)
    rstate = RT.init_state(rmodel, opt, jax.random.PRNGKey(0))
    rparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           rstate.params)
    np.savez(d / "params.npz", **_flat(rparams))
    mp.spawn(_port_worker, args=(WORLD, str(d / "store"), str(d)),
             nprocs=WORLD, join=True)
    return d, rmodel, rparams


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------

def _port_worker(rank, world, store, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.elastic import place

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}
    try:
        # compressed_psum over a 4-rank "pod" axis
        x = torch.from_numpy(np.load(f"{out_dir}/psum_in.npy")[rank])
        pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        with use_mesh(pod):
            got = compressed_psum(x, "pod")
        np.save(f"{out_dir}/psum_port{rank}.npy", got.numpy())

        # the elastic drill: restore the JAX checkpoint onto the shardings
        # of the planned 2x2 mesh, then reshard onto it again
        cfg = _cfg()
        model = build_model(cfg, device="cpu")
        opt = AdamW(lr=lambda s: LR)
        mesh = plan_mesh(list(range(world)), model_parallel=2, device="cpu")
        res["plan"] = list(mesh.shape)
        like = abstract_state(model, opt)
        restored, _ = ckpt.restore(f"{out_dir}/elastic_ck", 3, like,
                                   shardings=_state_sh(model, mesh))
        again = reshard(restored, model.specs, mesh)
        local = {}
        for name, t in _flat({"params": again.params,
                              "opt": {"step": again.opt.step,
                                      "m": again.opt.m,
                                      "v": again.opt.v}}).items():
            t = t.to_local() if isinstance(t, DTensor) else t
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            local[f"{name}@{rank}"] = t.numpy()
        np.savez(f"{out_dir}/shards_port{rank}.npz", **local)

        # the sharded step on the host mesh (2x2 for 4 ranks)
        hmesh = make_host_mesh(device="cpu")
        res["host_mesh"] = dict(zip(hmesh.mesh_dim_names, hmesh.shape))
        with np.load(f"{out_dir}/params.npz") as f:
            params = params_from_numpy(_unflat(dict(f)), "cpu")
        batch = _batch()
        bsh = NamedSharding(hmesh, P("data", None))
        dbatch = {k: place(torch.from_numpy(v), bsh)
                  for k, v in batch.items()}
        state = reshard(TrainState(params, opt.init(params)), model.specs,
                        hmesh)
        with use_mesh(hmesh):
            loss, _, grads = loss_and_grads(model, state.params, dbatch)
        full = {k: v.full_tensor() for k, v in _flat(grads).items()}
        res["loss"] = float(loss)
        res["grads_placed"] = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(tree_leaves(grads), tree_leaves(state.params)))
        # AdamW on DTensors, fed fixed gradients
        g_np = _grads_np(params)
        dg = reshard(tree_map(torch.from_numpy, g_np), model.specs, hmesh)
        with use_mesh(hmesh):
            new_p, new_s = opt.update(dg, state.opt, state.params)
        after = {f"p/{k}": v.full_tensor() for k, v in _flat(new_p).items()}
        after.update({f"m/{k}": v.full_tensor()
                      for k, v in _flat(new_s.m).items()})
        after.update({f"v/{k}": v.full_tensor()
                      for k, v in _flat(new_s.v).items()})
        res["serve_err"] = {f"kv{kv}": _serve_err(hmesh, kv, place)
                            for kv in (2, 1)}
        if rank == 0:
            np.savez(f"{out_dir}/grads_port.npz",
                     **{k: v.numpy() for k, v in full.items()})
            np.savez(f"{out_dir}/adamw_port.npz",
                     **{k: v.numpy() for k, v in after.items()})
        with open(f"{out_dir}/res{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _serve_err(mesh, n_kv_heads, place):
    """The largest |sharded - unsharded| / max |unsharded| over the f32
    logits of a prefill of 4 x 12 tokens into a cache of 16 positions and
    two decode steps, the tiny model with ``n_kv_heads`` KV heads on the
    2x2 mesh under the decode rules: 2 KV heads shard the cache's heads
    over ``model``, 1 shards its sequence (context parallelism)."""
    from repro_torch.launch.specs import arch_rules
    from repro_torch.models.sharding import init_params

    cfg = dataclasses.replace(_cfg(), n_kv_heads=n_kv_heads)
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda t: t.float(), init_params(
        model.specs, torch.Generator().manual_seed(3), device="cpu"))
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, 128, (4, 12)).astype(np.int32))
    steps = torch.from_numpy(rng.integers(0, 128, (2, 4, 1)).astype(np.int32))
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
                place(torch.full((4,), 12 + i), NamedSharding(mesh, P("data"))))
            got.append(logits.full_tensor())
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_jax_bit_for_bit(work):
    d, _, _ = work
    want = np.load(d / "psum_jax.npy")
    for r in range(WORLD):
        got = np.load(d / f"psum_port{r}.npy")
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want[r].view(np.uint32))


def test_compressed_psum_within_2_over_127_of_psum(work):
    """The JAX test's bound: each rank's rounding is at most half the
    shared scale (max |x| / 127 <= 1 / 127), four ranks at most 2/127."""
    d, _, _ = work
    x = np.load(d / "psum_in.npy")
    for r in range(WORLD):
        np.testing.assert_allclose(np.load(d / f"psum_port{r}.npy"),
                                   x.sum(0), rtol=0, atol=2 / 127)


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 8, 16])
def test_plan_mesh_matches_jax(model_parallel, work, tmp_path):
    d, _, _ = work
    want = json.loads((d / "plan_jax.json").read_text())
    code = textwrap.dedent(f"""
        import json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.train.elastic import plan_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=16)
        out = {{}}
        for n in range(1, 17):
            m = plan_mesh(list(range(n)), model_parallel={model_parallel},
                          device="cpu")
            out[str(n)] = [m.shape[0], m.shape[1]]
            assert m.mesh_dim_names == ("data", "model")
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for n in range(1, 17):
        assert got[str(n)] == want[f"{n},{model_parallel}"], n


def test_host_and_planned_meshes_on_four_ranks(work):
    d, _, _ = work
    for r in range(WORLD):
        res = json.loads((d / f"res{r}.json").read_text())
        assert res["plan"] == [2, 2]
        assert res["host_mesh"] == {"data": 2, "model": 2}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "refusal where no card is present")
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_on_the_card_unless_asked(multi_pod):
    # the card by default: without one it raises before any process
    # group is read; only the dry-run asks for the CPU
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh(multi_pod=multi_pod)


def test_elastic_restore_and_reshard_match_jax_shards(work):
    d, _, _ = work
    with np.load(d / "shards_jax.npz") as f:
        want = dict(f)
    n = 0
    for r in range(WORLD):
        with np.load(d / f"shards_port{r}.npz") as f:
            for key, got in f.items():
                w = want[key]
                assert got.shape == w.shape, key
                assert np.array_equal(got.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8)), key
                n += 1
    assert n == len(want)


def test_sharded_step_matches_unsharded_and_jax(work):
    d, rmodel, rparams = work
    batch = _batch()
    res = json.loads((d / "res0.json").read_text())
    assert res["grads_placed"]
    # the unsharded port step and JAX's loss_fn on the same weights
    model = build_model(_cfg(), device="cpu")
    params = params_from_numpy(rparams, "cpu")
    loss, _, grads = loss_and_grads(model, params, batch)
    rloss, _ = rmodel.loss_fn(
        jax.tree.map(jnp.asarray, rparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(res["loss"] - float(loss)) <= GRAD_TOL * abs(float(loss))
    assert abs(res["loss"] - float(rloss)) <= GRAD_TOL * abs(float(rloss))
    with np.load(d / "grads_port.npz") as f:
        got = dict(f)
    want = {k: v.numpy() for k, v in _flat(grads).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * scale, k


def _within_ulp(got, want):
    g, w = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(g), np.abs(w)).clip(min=2.0 ** -126)
    return bool((np.abs(g - w) <= np.exp2(np.floor(np.log2(mag)) - 23)).all())


def test_adamw_on_dtensors_within_one_ulp(work):
    d, _, rparams = work
    params = params_from_numpy(rparams, "cpu")
    opt = AdamW(lr=lambda s: LR)
    g = tree_map(torch.from_numpy, _grads_np(params))
    new_p, new_s = opt.update(g, opt.init(params), params)
    want = {f"p/{k}": v for k, v in _flat(new_p).items()}
    want.update({f"m/{k}": v for k, v in _flat(new_s.m).items()})
    want.update({f"v/{k}": v for k, v in _flat(new_s.v).items()})
    with np.load(d / "adamw_port.npz") as f:
        got = dict(f)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _within_ulp(got[k], w.numpy()), k


@pytest.mark.parametrize("kv", ["kv2", "kv1"])
def test_sharded_prefill_and_decode_match_unsharded(kv, work):
    """Prefill and two decode steps on the 2x2 mesh, heads-sharded (kv2)
    and sequence-sharded (kv1, context-parallel) caches: the logits within
    1e-5 of the unsharded port's (f32; the softmax over sequence shards
    sums in another order)."""
    d, _, _ = work
    for r in range(WORLD):
        res = json.loads((d / f"res{r}.json").read_text())
        assert res["serve_err"][kv] <= GRAD_TOL, (r, res["serve_err"])
