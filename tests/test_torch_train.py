"""The port's training substrate (``repro_torch.train``) against the JAX
package's ``repro.train``, on the CPU.

The model is the JAX train tests' tiny one (``default_config(vocab=128)``
cut to 2 layers of width 64); its parameters come from the JAX
``init_state(PRNGKey(0))`` through ``convert.params_from_numpy``, and the
batches are numpy-seeded.

Bounds:
* ``AdamW.update`` on the JAX step's own gradients, f32 and bf16 state:
  every parameter, m and v within 1 ulp of its dtype (the packages'
  ``pow`` of the bias corrections and their f32 sums of the global norm
  may round differently in the last place).
* ``cosine_schedule``: within 1 f32 ulp.  ``compress_grads`` and
  ``init_error``: equal bit for bit (both round half to even).
* ``make_train_step`` over 3 steps, with the parameters cast to f32 in
  both packages (in bf16 the two backwards round at other places, ~5e-3
  a leaf, ``tests/test_torch_losses.py``): the metrics within 1e-5 of
  their magnitude; the parameters within 2 lr, because the first update
  is lr * sign(g) wherever |g| >> eps, and a g near 0 may take either
  sign in the two packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch.train import default_config as r_default_config
from repro.models import build_model as r_build
from repro.train import compress as RC
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro.train.elastic import scale_batch as r_scale_batch

from repro_torch.launch.train import default_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.train import compress as TC
from repro_torch.train import elastic as TE
from repro_torch.train.optimizer import AdamW, AdamWState, cosine_schedule
from repro_torch.train.train_step import (TrainState, abstract_state,
                                          init_state, loss_and_grads,
                                          make_train_step)

torch.set_num_threads(1)

METRIC_TOL = 1e-5
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
STATE_DTYPES = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models():
    rcfg = dataclasses.replace(r_default_config(vocab=128), **TINY)
    cfg = dataclasses.replace(default_config(vocab=128), **TINY)
    return r_build(rcfg), build_model(cfg, device="cpu")


def _batch(vocab, B=8, S=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _port_state(rstate):
    """The port's TrainState holding the values of a JAX one."""
    opt = AdamWState(step=torch.tensor(int(rstate.opt.step),
                                       dtype=torch.int32),
                     m=_to_port(rstate.opt.m), v=_to_port(rstate.opt.v))
    error = None if rstate.error is None else _to_port(rstate.error)
    return TrainState(_to_port(rstate.params), opt, error)


def _f32(a) -> np.ndarray:
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _assert_within_ulp(got, want, dtype, what):
    """|got - want| <= one ulp of ``dtype`` at their larger magnitude."""
    g, w = _f32(got), _f32(want)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)))
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16                  # 7 mantissa bits, not 23
    bad = np.abs(g - w) > ulp
    assert not bad.any(), (what, g[bad][:5], w[bad][:5])


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_jax(state_dtype, clip):
    """Two updates, on the JAX loss's gradients of two batches: the second
    starts from non-zero moments and a non-zero step."""
    jdt, tdt = STATE_DTYPES[state_dtype]
    rmodel, _ = _models()
    sched = dict(peak=1e-2, warmup=1, total=10)
    ropt = RO.AdamW(lr=RO.cosine_schedule(**sched), clip_norm=clip,
                    state_dtype=jdt)
    topt = AdamW(lr=cosine_schedule(**sched), clip_norm=clip,
                 state_dtype=tdt)
    rstate = RT.init_state(rmodel, ropt, jax.random.PRNGKey(0))
    state = _port_state(rstate)
    params, opt = state.params, state.opt
    grad_fn = jax.jit(jax.grad(lambda p, b: rmodel.loss_fn(p, b)[0]))
    rparams, ropt_state = rstate.params, rstate.opt
    for seed in (1, 2):
        rgrads = grad_fn(rparams, _jax_batch(_batch(128, seed=seed)))
        rparams, ropt_state = ropt.update(rgrads, ropt_state, rparams)
        params, opt = topt.update(_to_port(rgrads), opt, params)
        assert int(opt.step) == int(ropt_state.step) == seed
        for name, g, w, dt in (("params", params, rparams, torch.bfloat16),
                               ("m", opt.m, ropt_state.m, tdt),
                               ("v", opt.v, ropt_state.v, tdt)):
            for a, b in zip(tree_leaves(g), jax.tree.leaves(w)):
                assert a.dtype == dt
                _assert_within_ulp(a, b, dt, name)


def test_adamw_update_writes_in_place():
    opt = AdamW(lr=lambda s: 0.1)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    m = state.m["w"]
    new_params, new_state = opt.update({"w": torch.full((4,), 0.5)}, state,
                                       params)
    assert new_params["w"] is params["w"] and new_state.m["w"] is m
    assert (params["w"] < 1).all() and (m > 0).all()
    assert int(new_state.step) == 1 and int(state.step) == 0


def test_adamw_update_in_chunks_changes_no_value(monkeypatch):
    """The update is elementwise: chunks of a flattened leaf give the
    whole leaf's values bit for bit."""
    from repro_torch.train import optimizer as TO
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.normal(size=(100, 7)).astype(
        np.float32)).bfloat16(), "b": torch.from_numpy(
        rng.normal(size=(13,)).astype(np.float32))}
    grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in params.items()}
    out = []
    for chunk in (TO.UPDATE_CHUNK, 64):
        monkeypatch.setattr(TO, "UPDATE_CHUNK", chunk)
        opt = AdamW(lr=cosine_schedule(1e-2, warmup=1, total=10))
        p = tree_map(torch.clone, params)
        st = opt.init(p)
        for _ in range(3):
            p, st = opt.update(grads, st, p)
        out.append(tree_leaves(p) + tree_leaves(st.m) + tree_leaves(st.v))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 20, 50, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    want = RO.cosine_schedule(3e-4, warmup=20, total=100)(
        jnp.asarray(step, jnp.int32))
    got = cosine_schedule(3e-4, warmup=20, total=100)(
        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    _assert_within_ulp(got, want, torch.float32, f"lr({step})")


def test_bf16_optimizer_state():
    _, model = _models()
    opt = AdamW(lr=lambda s: 1e-3, state_dtype=torch.bfloat16)
    state = init_state(model, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(state.opt.m))
    state, m = make_train_step(model, opt)(state, _batch(128))
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compress_grads_and_init_error_equal_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(64, 33)).astype(np.float32),
             "b": {"c": (rng.normal(size=(200,)) * 1e-3).astype(np.float32),
                   "d": np.full((7,), 0.5, np.float32)}}   # ties at .5
    error = {"a": rng.normal(size=(64, 33)).astype(np.float32) * 1e-2,
             "b": {"c": np.zeros(200, np.float32),
                   "d": np.zeros(7, np.float32)}}
    for dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        rg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), grads)
        re = jax.tree.map(jnp.asarray, error)
        want_g, want_e = RC.compress_grads(rg, re)
        got_g, got_e = TC.compress_grads(_to_port(rg), _to_port(re))
        for a, b in zip(tree_leaves(got_g), jax.tree.leaves(want_g)):
            assert a.dtype == dtype
            np.testing.assert_array_equal(_f32(a), _f32(b))
        for a, b in zip(tree_leaves(got_e), jax.tree.leaves(want_e)):
            np.testing.assert_array_equal(_f32(a), _f32(b))
    zeros = TC.init_error(_to_port(rg))
    for a, b in zip(tree_leaves(zeros), jax.tree.leaves(RC.init_error(rg))):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert not a.any()


def test_quantization_error_bounded_and_feedback_reinjects():
    g = {"w": torch.linspace(-3, 3, 1000)}
    gq, _ = TC.compress_grads(g, TC.init_error(g))
    assert float((gq["w"] - g["w"]).abs().max()) <= 3 / 127 + 1e-6
    g = {"w": torch.full((100,), 1e-4)}     # below one quantization step
    e = TC.init_error(g)
    total = torch.zeros(100)
    for _ in range(50):
        gq, e = TC.compress_grads(g, e)
        total += gq["w"]
    np.testing.assert_allclose((total / 50).numpy(), 1e-4, rtol=0.3)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax_over_three_steps(microbatches, compress):
    lr = 1e-3
    rmodel, model = _models()
    ropt = RO.AdamW(lr=lambda s: lr)
    opt = AdamW(lr=lambda s: lr)
    rstate = RT.init_state(rmodel, ropt, jax.random.PRNGKey(0),
                           compress=compress)
    rstate = rstate._replace(params=jax.tree.map(
        lambda a: a.astype(jnp.float32), rstate.params))
    state = _port_state(rstate)
    rstep = jax.jit(RT.make_train_step(rmodel, ropt, microbatches, compress))
    step = make_train_step(model, opt, microbatches, compress)
    for seed in (1, 2, 3):
        batch = _batch(128, seed=seed)
        rstate, rmet = rstep(rstate, _jax_batch(batch))
        state, met = step(state, batch)
        assert set(met) == set(rmet)
        for k in rmet:
            want = float(rmet[k])
            assert abs(float(met[k]) - want) <= METRIC_TOL * max(abs(want),
                                                                1e-30), k
    assert int(state.opt.step) == 3
    for a, b in zip(tree_leaves(state.params),
                    jax.tree.leaves(rstate.params)):
        assert a.dtype == torch.float32
        assert np.abs(_f32(a) - _f32(b)).max() <= 2 * lr
    if compress:
        for a, b in zip(tree_leaves(state.error),
                        jax.tree.leaves(rstate.error)):
            assert np.abs(_f32(a) - _f32(b)).max() <= 2 * lr


def test_loss_decreases():
    _, model = _models()
    opt = AdamW(lr=cosine_schedule(1e-2, warmup=5, total=100))
    step = make_train_step(model, opt)
    state = init_state(model, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    batch = _batch(128, B=4)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)       # overfit one batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_microbatching_matches_full_batch():
    _, model = _models()
    opt = AdamW(lr=lambda s: 1e-3, clip_norm=None)
    s1 = make_train_step(model, opt, microbatches=1)
    s4 = make_train_step(model, opt, microbatches=4)
    st = init_state(model, opt, torch.Generator().manual_seed(0),
                    device="cpu")
    clone = lambda s: TrainState(tree_map(torch.clone, s.params),
                                 opt.init(s.params), None)
    batch = _batch(128, B=8)
    st1, m1 = s1(clone(st), batch)
    st4, m4 = s4(clone(st), batch)
    # losses agree to f32 rounding; params may differ by one bf16 ulp
    # where the f32 update rounds either way
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(st1.params), tree_leaves(st4.params)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=5e-2, atol=2.5e-3)


def test_microbatches_must_divide_the_batch():
    _, model = _models()
    opt = AdamW(lr=lambda s: 1e-3)
    st = init_state(model, opt, torch.Generator().manual_seed(0),
                    device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt, microbatches=3)(st, _batch(128, B=8))


def test_loss_and_grads_leaves_the_parameters_alone():
    _, model = _models()
    params = init_state(model, AdamW(lr=lambda s: 1e-3),
                        torch.Generator().manual_seed(0),
                        device="cpu").params
    _, _, grads = loss_and_grads(model, params, _batch(128))
    assert all(not p.requires_grad and p.grad is None
               for p in tree_leaves(params))
    assert all(g.dtype == p.dtype and g.shape == p.shape for g, p in
               zip(tree_leaves(grads), tree_leaves(params)))


def test_a_step_leaves_no_gradient_for_the_garbage_collector():
    """A step's gradients and f32 accumulators are freed when it returns,
    by reference counts alone: held by a reference cycle until the
    collector ran, they added 21.7 GB to the card's peak at Llama-3.2-3B's
    width (``tree_unflatten``'s recursive closure)."""
    import gc
    import weakref
    from repro_torch.models.sharding import tree_unflatten
    _, model = _models()
    opt = AdamW(lr=lambda s: 1e-3)
    state = init_state(model, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    step = make_train_step(model, opt, microbatches=2)
    state, _ = step(state, _batch(128))          # one-time imports
    seen = []
    real = torch.autograd.grad

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.extend(weakref.ref(g) for g in out)
        return out

    gc.collect()
    gc.disable()
    try:
        torch.autograd.grad = spy
        state, _ = step(state, _batch(128))
        leaves = [torch.zeros(3)]
        ref = weakref.ref(leaves[0])
        tree = tree_unflatten({"a": 0}, leaves)
        del leaves, tree
        assert ref() is None
    finally:
        torch.autograd.grad = real
        gc.enable()
    assert seen and all(r() is None for r in seen)


# ---------------------------------------------------------------------------
# elastic bookkeeping and the abstract state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(256, 32, 16, 1), (250, 32, 16, 1),
                                  (256, 16, 16, 2), (64, 8, 3, 2),
                                  (7, 4, 8, 1)])
def test_scale_batch_matches_jax(args):
    assert TE.scale_batch(*args) == r_scale_batch(*args)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_abstract_state_matches_jax(compress, state_dtype):
    jdt, tdt = STATE_DTYPES[state_dtype]
    rmodel, model = _models()
    want = RT.abstract_state(rmodel, RO.AdamW(lr=lambda s: 1e-3,
                                              state_dtype=jdt), compress)
    got = abstract_state(model, AdamW(lr=lambda s: 1e-3, state_dtype=tdt),
                         compress)
    assert (got.error is None) == (want.error is None)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int32: "int32"}
    got_leaves = (tree_leaves(got.params) + [got.opt.step]
                  + tree_leaves(got.opt.m) + tree_leaves(got.opt.v)
                  + (tree_leaves(got.error) if compress else []))
    want_leaves = (jax.tree.leaves(want.params) + [want.opt.step]
                   + jax.tree.leaves(want.opt.m) + jax.tree.leaves(want.opt.v)
                   + (jax.tree.leaves(want.error) if compress else []))
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert names[a.dtype] == str(b.dtype)
