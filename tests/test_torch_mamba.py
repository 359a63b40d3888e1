"""The port's Mamba2 mixer (``models/mamba.py``) against the JAX package's,
on the CPU.

Inputs are numpy-seeded; parameters of a mixer are the JAX smoke model's
``init_params(PRNGKey(0))`` layer 0, carried over with
``convert.params_from_numpy``.  Bounds:

* ``ssd_scan`` against the JAX ``ssd_scan``, the port's step-by-step
  ``ssd_recurrence`` and the JAX tests' ``naive_ssd`` (numpy f64): 2e-4,
  rtol and atol, the bound of ``tests/test_mamba_ssd.py``.  An ``atol`` is
  needed: ``exp(cum)`` over a chunk underflows into denormals, which XLA
  on the CPU flushes to zero and torch keeps.
* the mixer, its conv and its decode step in f32: 1e-4 of the largest
  magnitude (only the order of f32 sums differs); in bf16: 2e-2, as the
  model tests (``test_torch_models.py``).  The conv adds its taps one at a
  time in the input's dtype in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.models import mamba as RM
from repro.models.sharding import init_params as r_init

from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba as TM
from repro_torch.models.convert import params_from_numpy

from test_mamba_ssd import naive_ssd

torch.set_num_threads(1)

SCAN_TOL = 2e-4
TOL = {"f32": 1e-4, "bf16": 2e-2}         # of the largest magnitude
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SCAN_CASES = [(8, 4), (16, 4), (12, 5), (7, 16)]


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scan_inputs(rng, s, b=2, h=3, p=4, n=5, dt=(0.01, 0.5)):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(*dt, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=SCAN_TOL, atol=SCAN_TOL, err_msg=what)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_ssd_scan_matches_jax_and_the_recurrence(s, chunk, with_s0):
    rng = np.random.default_rng(s * 31 + chunk)
    args = _scan_inputs(rng, s)
    s0 = (rng.normal(size=(2, 3, 4, 5)).astype(np.float32) if with_s0
          else None)
    t_args = [torch.from_numpy(a) for a in args]
    t_s0 = None if s0 is None else torch.from_numpy(s0)
    y, st = TM.ssd_scan(*t_args, chunk, s0=t_s0)
    assert y.shape == (2, s, 3, 4) and st.shape == (2, 3, 4, 5)
    y_j, st_j = RM.ssd_scan(*(jnp.asarray(a) for a in args), chunk,
                            s0=None if s0 is None else jnp.asarray(s0))
    _close(y, y_j, "y vs JAX")
    _close(st, st_j, "state vs JAX")
    y_r, st_r = TM.ssd_recurrence(*t_args, s0=t_s0)
    _close(y, y_r, "y vs the recurrence")
    _close(st, st_r, "state vs the recurrence")
    if s0 is None:          # the port's recurrence against the JAX tests'
        y_n, st_n = naive_ssd(*args)
        _close(y_r, y_n, "recurrence vs naive_ssd")
        _close(st_r, st_n, "recurrence state vs naive_ssd")


def test_ssd_scan_masks_the_decay_before_its_exp():
    """With dt ~ 5-20 over a chunk of 64, cum_i - cum_j above the diagonal
    reaches hundreds: exp overflows there, and exp * mask would give inf *
    0 = NaN.  The scan masks first: finite, and equal to the recurrence."""
    rng = np.random.default_rng(5)
    args = _scan_inputs(rng, 128, dt=(5.0, 20.0))
    x, dt, A, B, C = (torch.from_numpy(a) for a in args)
    cum = torch.cumsum(dt * A, dim=1)[:, :64]
    assert bool(torch.isinf(torch.exp(cum[:, :, None] - cum[:, None, :]))
                .any())                       # an unmasked exp overflows
    y, st = TM.ssd_scan(x, dt, A, B, C, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    y_r, st_r = TM.ssd_recurrence(x, dt, A, B, C)
    _close(y, y_r, "y vs the recurrence")
    _close(st, st_r, "state vs the recurrence")


def test_ssd_scan_padding_keeps_the_last_real_state():
    """A prompt that is not a multiple of the chunk: the final state is the
    state after the last real step (padded steps have dt = 0), equal to a
    scan of the real steps alone at a chunk that divides them."""
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in _scan_inputs(rng, 11)]
    y_pad, st_pad = TM.ssd_scan(*args, 16)
    y_one, st_one = TM.ssd_scan(*args, 11)
    _close(y_pad, y_one, "y")
    _close(st_pad, st_one, "state")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    got = TM._causal_conv(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt))
    want = RM._causal_conv(jnp.asarray(x).astype(jdt),
                           jnp.asarray(w).astype(jdt))
    assert got.dtype == tdt
    assert _rel_err(got.float(), want.astype(jnp.float32)) <= TOL[dtype]
    # the first output sees only the first input: zeros pad the left
    np.testing.assert_allclose(got[:, 0].float().numpy(),
                               (torch.from_numpy(x[:, 0]).to(tdt)
                                * torch.from_numpy(w[3]).to(tdt)).float()
                               .numpy(), rtol=1e-6)


def _mixer(arch, dtype):
    """(cfg, JAX mixer params, port mixer params) of layer 0 of the smoke
    model, in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    rcfg = r_smoke(arch)
    rp = r_init(r_build(rcfg).specs, jax.random.PRNGKey(0))["layers"]["mixer"]
    first = (lambda a: a[0, 0]) if rcfg.family == "hybrid" else (
        lambda a: a[0])
    rp = jax.tree.map(lambda a: first(a).astype(jdt), rp)
    return rcfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu",
                                       dtype=tdt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,S", [("mamba2-1.3b", 2),     # S < K - 1
                                    ("mamba2-1.3b", 11),    # padded chunk
                                    ("mamba2-1.3b", 40),    # 3 chunks
                                    ("zamba2-2.7b", 21)])
def test_mamba_block_with_state(arch, S, dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, tp = _mixer(arch, dtype)
    cfg = get_smoke_config(arch)
    assert S < cfg.conv_kernel - 1 or S > cfg.conv_kernel
    x = np.random.default_rng(S).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    out_j, st_j = RM.mamba_block(rp, jnp.asarray(x).astype(jdt), rcfg,
                                 return_state=True)
    out, st = TM.mamba_block(tp, torch.from_numpy(x).to(tdt), cfg,
                             return_state=True)
    assert out.dtype == tdt
    assert st.s.dtype == st.conv.dtype == torch.float32
    assert tuple(st.conv.shape) == (2, cfg.conv_kernel - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state)
    assert _rel_err(out.float(), out_j.astype(jnp.float32)) <= TOL[dtype]
    assert _rel_err(st.s, st_j.s) <= TOL[dtype]
    assert _rel_err(st.conv, st_j.conv) <= TOL[dtype]
    if S < cfg.conv_kernel - 1:             # the tail's left is zeros
        assert bool((st.conv[:, :cfg.conv_kernel - 1 - S] == 0).all())
    # without return_state, the same output alone
    torch.testing.assert_close(TM.mamba_block(tp, torch.from_numpy(x).to(tdt),
                                              cfg), out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_mamba_decode_step(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, tp = _mixer(arch, dtype)
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    init = TM.mamba_init_state(cfg, 3)
    assert tuple(init.s.shape) == (3, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)
    s = rng.normal(size=tuple(init.s.shape)).astype(np.float32)
    conv = rng.normal(size=tuple(init.conv.shape)).astype(np.float32)
    out_j, st_j = RM.mamba_decode_step(
        rp, jnp.asarray(x).astype(jdt),
        RM.SSMState(jnp.asarray(s), jnp.asarray(conv)), rcfg)
    state = TM.SSMState(torch.from_numpy(s), torch.from_numpy(conv))
    out, st = TM.mamba_decode_step(tp, torch.from_numpy(x).to(tdt), state,
                                   cfg)
    assert out.dtype == tdt and tuple(out.shape) == (3, 1, cfg.d_model)
    assert st.s.dtype == st.conv.dtype == torch.float32
    assert _rel_err(out.float(), out_j.astype(jnp.float32)) <= TOL[dtype]
    assert _rel_err(st.s, st_j.s) <= TOL[dtype]
    assert _rel_err(st.conv, st_j.conv) <= TOL[dtype]
    # the caller's state is not written
    np.testing.assert_array_equal(state.s.numpy(), s)
    np.testing.assert_array_equal(state.conv.numpy(), conv)
