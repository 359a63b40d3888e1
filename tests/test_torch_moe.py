"""The port's MoE block against the JAX package's, on the CPU.

The JAX package's ``init_params(PRNGKey(0))`` of a smoke config's layer-0
FFN is carried over with ``convert.params_from_numpy`` and both packages'
``moe_block`` run on the same numpy-seeded input, in f32, in both dispatch
modes.  Bounds: the routes (``idx``) are equal, ``y`` is within 1e-5 of
max |y| and the aux loss within 1e-6 (the packages differ only in the
order of f32 sums).  A slot's rank within its expert decides whether it
is dropped, so the cases below also run at a capacity factor low enough
that the JAX package's own ranks drop slots, and on inputs with repeated
token rows, whose slots tie in the sort: only a stable sort drops the
JAX package's slots there.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.models import moe as RM
from repro.models.sharding import init_params as r_init

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
DISPATCH = ["scatter", "grouped"]
Y_TOL = 1e-5          # of max |y|
AUX_TOL = 1e-6


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfgs(arch, **kw):
    return (dataclasses.replace(r_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _ffn_params(arch, seed=0):
    """Layer 0's FFN parameters of the JAX smoke model, in f32, in both
    packages."""
    rcfg = r_smoke(arch)
    rp = r_init(r_build(rcfg).specs, jax.random.PRNGKey(seed))
    rp = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      rp["layers"]["ffn"])
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _x(rng, B, S, d, repeat=0):
    """[B, S, d] f32 normal rows; with ``repeat`` > 0, only ``repeat``
    distinct rows, each tiled over the batch."""
    if repeat:
        rows = rng.normal(size=(repeat, d)).astype(np.float32)
        x = rows[rng.integers(0, repeat, B * S)].reshape(B, S, d)
    else:
        x = rng.normal(size=(B, S, d)).astype(np.float32)
    return x


def _jax_routes(rp, x, cfg):
    """The JAX package's router on ``x`` [..., d]: (w, idx)."""
    logits = jnp.einsum("...d,de->...e", jnp.asarray(x, jnp.float32),
                        rp["router"].astype(jnp.float32))
    w, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                           cfg.experts_per_tok)
    return np.asarray(w / w.sum(-1, keepdims=True)), np.asarray(idx)


def _jax_drops(idx, C) -> int:
    """Slots the JAX package's rank rule drops from one dispatch of ``idx``
    [T, k] at capacity C (``_moe_dispatch``'s arithmetic)."""
    flat_e = jnp.asarray(idx).reshape(-1)
    sorted_e = flat_e[jnp.argsort(flat_e)]
    rank = jnp.arange(flat_e.size) - jnp.searchsorted(sorted_e, sorted_e,
                                                      side="left")
    return int((rank >= C).sum())


def _check(arch, dispatch, B, S, seed, repeat=0, **kw):
    rcfg, tcfg = _cfgs(arch, moe_dispatch=dispatch, **kw)
    rp, tp = _ffn_params(arch)
    x = _x(np.random.default_rng(seed), B, S, tcfg.d_model, repeat)
    ry, raux = RM.moe_block(rp, jnp.asarray(x), rcfg)
    ty, taux = TM.moe_block(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (B, S, tcfg.d_model)
    assert _rel_err(ty, ry) <= Y_TOL
    assert abs(float(taux) - float(raux)) <= AUX_TOL
    return rcfg, tcfg, rp, tp, x


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_jax(arch, dispatch):
    _check(arch, dispatch, B=2, S=12, seed=0)


@pytest.mark.parametrize("arch", MOE)
def test_routes_match_jax(arch):
    rcfg, tcfg = _cfgs(arch)
    rp, tp = _ffn_params(arch)
    x = _x(np.random.default_rng(1), 3, 10, tcfg.d_model)
    rw, ridx = _jax_routes(rp, x, rcfg)
    probs, tw, tidx = TM.route(tp, torch.from_numpy(x), tcfg)
    assert probs.dtype == torch.float32 and tidx.dtype == torch.int64
    np.testing.assert_array_equal(tidx.numpy(), ridx)
    assert _rel_err(tw, rw) <= Y_TOL
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("S", [16, 18])
def test_chunked_and_unchunked_lengths(dispatch, S):
    # S = 16 is four chunks of 4; S = 18 is not a multiple of the chunk and
    # runs as one dispatch, as in the JAX package
    rcfg, tcfg, rp, tp, x = _check("qwen3-moe-30b-a3b", dispatch, B=2, S=S,
                                   seed=2, moe_seq_chunk=4)
    # the chunked path is a dispatch per chunk: y equals each chunk alone
    if S % 4 == 0:
        c0, _ = TM.moe_block(tp, torch.from_numpy(x[:, :4]), tcfg)
        got, _ = TM.moe_block(tp, torch.from_numpy(x), tcfg)
        torch.testing.assert_close(got[:, :4], c0, rtol=0, atol=0)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE)
def test_low_capacity_drops_the_jax_packages_slots(arch, dispatch):
    B, S, cf = 2, 24, 0.5
    rcfg, tcfg, rp, tp, x = _check(arch, dispatch, B=B, S=S, seed=3,
                                   capacity_factor=cf)
    _, ridx = _jax_routes(rp, x, rcfg)
    if dispatch == "scatter":
        groups = [ridx.reshape(B * S, -1)]
    else:
        groups = [ridx[b] for b in range(B)]
    drops = 0
    for g in groups:
        C = TM.capacity(len(g), tcfg)
        kept = TM.kept_slots(torch.tensor(g, dtype=torch.int64), C)
        assert int((~kept).sum()) == _jax_drops(g, C)
        drops += _jax_drops(g, C)
    assert drops > 0


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE)
def test_repeated_rows_tie_and_keep_the_stable_order(arch, dispatch):
    # 3 distinct rows over 2 x 20 tokens: every expert's slots tie many
    # ways, and the capacity drops most of them
    B, S = 2, 20
    rcfg, tcfg, rp, tp, x = _check(arch, dispatch, B=B, S=S, seed=4,
                                   repeat=3, capacity_factor=0.5)
    _, ridx = _jax_routes(rp, x, rcfg)
    flat = ridx.reshape(B * S, -1)
    C = TM.capacity(B * S, tcfg)
    kept = TM.kept_slots(torch.tensor(flat, dtype=torch.int64), C)
    assert int((~kept).sum()) == _jax_drops(flat, C) > 0
    # the first C slots of each expert, in slot order, are the kept ones
    for e in np.unique(flat):
        slots = np.flatnonzero(flat.reshape(-1) == e)
        want = np.zeros(flat.size, bool)
        want[slots[:C]] = True
        np.testing.assert_array_equal(kept.reshape(-1).numpy()[slots],
                                      want[slots])


def test_capacity_and_kept_slots_at_the_served_shapes():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b")
    assert (TM.capacity(1024, cfg), TM.capacity(4, cfg),
            TM.capacity(1, cfg)) == (80, 1, 1)
    # one token's k experts are distinct: a lone token never drops a slot
    idx = torch.randperm(cfg.n_experts, generator=torch.Generator().manual_seed(0))
    idx = idx[:cfg.experts_per_tok][None, :]
    assert bool(TM.kept_slots(idx, 1).all())
    # two tokens on one expert at C = 1: the first keeps it
    idx = torch.tensor([[5, 9], [7, 5]])
    assert TM.kept_slots(idx, 1).tolist() == [[True, True], [True, False]]


@pytest.mark.parametrize("block", [4, 8, 256])
def test_router_boundary_stats_match_jax(block):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(64, 16)).astype(np.float32)
    want = float(RM.router_boundary_stats(jnp.asarray(logits), 4, block))
    got = float(TM.router_boundary_stats(torch.from_numpy(logits), 4, block))
    if np.isnan(want):
        assert np.isnan(got)                  # fewer tokens than one block
    else:
        assert got == want


def test_moe_specs_match_jax():
    for arch in MOE:
        rs = RM.moe_specs(r_smoke(arch))
        ts = TM.moe_specs(get_smoke_config(arch))
        assert {k: v.shape for k, v in ts.items()} == {
            k: v.shape for k, v in rs.items()}
        assert ts["router"].scale == rs["router"].scale
