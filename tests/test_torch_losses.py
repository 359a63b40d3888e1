"""The port's losses and their gradients against the JAX package's, on the
CPU: every family, the attention Function's backward and the SSD scan's.

The JAX package's ``init_params(PRNGKey(0))`` is carried over with
``convert.params_from_numpy``; tokens, labels (a few masked) and the
``prefix`` of a ``vlm`` or ``encdec`` are numpy-seeded and go to both
packages.  ``jax.value_and_grad(model.loss_fn)`` is the reference.

Bounds:
* f32, the ten smoke configs (all six families): the loss within 1e-5 of
  its magnitude, each leaf's gradient within 1e-4 of its largest entry;
  the packages differ only in the order of f32 sums.  One leaf is held to
  bf16's step instead (``BF16_STEP_LEAVES``): an encdec's encoder reads
  the frames as bf16 in both packages, so layer 0's first norm returns
  bf16 and its weight's gradient sums a cotangent rounded to bf16, where
  an f32 difference near a rounding edge moves an element by a bf16 step.
* bf16, ``llama3.2-3b``: the loss within 1e-3 of its magnitude and each
  leaf's gradient within ``BF16_GRAD_TOL`` of its largest entry, in the
  2-norm.  The packages round activations to bf16 at the same places, but
  the port's attention runs in f32 with its own backward and the f32 sums
  under a bf16 product run in other orders, so a value near a rounding
  edge lands on the neighbouring bf16 value and the backward carries it.
* the attention backward: the Function's dq, dk, dv within 1e-5 of max
  |.| of ``torch.autograd.grad`` of ``ref.flash_attention_ref`` (both f32
  plain code) and of ``jax.grad`` of the JAX ``ref.flash_attention_ref``.
* the SSD scan's backward against ``jax.grad`` of the JAX ``ssd_scan``:
  2e-4, rtol and atol, the scan's own bound (``tests/test_torch_mamba.py``).

The JAX ``encdec`` refuses f32 parameters (ROADMAP queue 3, R2): its f32
case runs the JAX code with ``lax.scan`` unrolled (``loop_scan``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.kernels import ref as RR
from repro.models import build_model as r_build
from repro.models import mamba as RM
from repro.models.sharding import init_params as r_init

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.kernels import ops, ref as TR
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.flash_attention import _launch
from repro_torch.models import build_model
from repro_torch.models import mamba as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.train.train_step import loss_and_grads

from test_torch_mamba import _scan_inputs
from test_torch_models import loop_scan

torch.set_num_threads(1)

ARCHS = list_archs()
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
GRAD_TOL = 1e-4                   # f32, of each leaf's largest entry
# (arch, leaf) -> its f32 bound: a bf16 step (see the module docstring)
BF16_STEP_LEAVES = {("whisper-small", "enc_layers/ln1"): 2.0 ** -8}
BF16_GRAD_TOL = 3e-2              # bf16, 2-norm relative
ATTN_BWD_TOL = 1e-5
SCAN_TOL = 2e-4
B, S = 2, 24


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend != "none":
        batch["prefix"] = rng.normal(
            size=(B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return batch


def _jax_loss_and_grads(arch, dtype, batch, monkeypatch):
    jdt = DTYPES[dtype][0]
    cfg = r_smoke(arch)
    if cfg.family == "encdec" and dtype == "f32":
        monkeypatch.setattr(jax.lax, "scan", loop_scan)
    model = r_build(cfg)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          r_init(model.specs, jax.random.PRNGKey(0)))
    f = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
    (loss, metrics), grads = f(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    return params, float(loss), metrics, grads


def _port_params(jax_params, dtype):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu",
                             dtype=DTYPES[dtype][1])


def _grad_pairs(jax_grads, port_grads):
    """(leaf path, JAX leaf, port leaf), the leaves as f64 numpy, in the
    same (sorted-key) order."""
    flat = jax.tree_util.tree_flatten_with_path(jax_grads)[0]
    return [("/".join(str(k.key) for k in path), np.asarray(a, np.float64),
             b.double().numpy())
            for (path, a), b in zip(flat, tree_leaves(port_grads))]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_f32(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    batch = _batch(cfg)
    rparams, rloss, rmet, rgrads = _jax_loss_and_grads(arch, "f32", batch,
                                                       monkeypatch)
    model = build_model(cfg, device="cpu")
    loss, metrics, grads = loss_and_grads(model, _port_params(rparams, "f32"),
                                          batch)
    assert abs(float(loss) - rloss) <= LOSS_TOL["f32"] * abs(rloss)
    assert abs(float(metrics["ce"]) - float(rmet["ce"])) \
        <= LOSS_TOL["f32"] * abs(rloss)
    if cfg.family == "moe":
        assert abs(float(metrics["aux"]) - float(rmet["aux"])) \
            <= LOSS_TOL["f32"] * abs(float(rmet["aux"]))
    pairs = _grad_pairs(rgrads, grads)
    assert len(pairs) == len(tree_leaves(grads))
    for name, want, got in pairs:
        assert got.shape == want.shape, name
        tol = BF16_STEP_LEAVES.get((arch, name), GRAD_TOL)
        assert np.abs(got - want).max() <= tol * max(
            np.abs(want).max(), 1e-30), name


def test_loss_and_grads_match_jax_bf16(monkeypatch):
    arch = "llama3.2-3b"
    cfg = get_smoke_config(arch)
    batch = _batch(cfg)
    rparams, rloss, _, rgrads = _jax_loss_and_grads(arch, "bf16", batch,
                                                    monkeypatch)
    model = build_model(cfg, device="cpu")
    loss, _, grads = loss_and_grads(model, _port_params(rparams, "bf16"),
                                    batch)
    assert abs(float(loss) - rloss) <= LOSS_TOL["bf16"] * abs(rloss)
    for name, want, got in _grad_pairs(rgrads, grads):
        assert np.isfinite(got).all(), name
        assert np.linalg.norm(got - want) <= BF16_GRAD_TOL * max(
            np.linalg.norm(want), 1e-30), name


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-small", "llava-next-34b"])
def test_remat_on_and_off_give_equal_grads(arch):
    """``cfg.remat`` recomputes each layer (a hybrid group) in the
    backward; the gradients are the same bit for bit, and every leaf gets
    a finite one."""
    from repro_torch.models.sharding import init_params
    cfg = get_smoke_config(arch)
    assert cfg.remat
    batch = _batch(cfg, seed=1)
    params = tree_map(lambda t: t.float(), init_params(
        build_model(cfg, device="cpu").specs,
        torch.Generator().manual_seed(0), "cpu"))
    got = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        got[remat] = loss_and_grads(model, params, batch)
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(tree_leaves(got[True][2]), tree_leaves(got[False][2])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the attention Function's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [8, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(16, 16), (9, 20), (20, 9)])
def test_attention_backward_matches_autograd_and_jax(D, causal, Sq, Sk,
                                                     monkeypatch):
    rng = np.random.default_rng(D + Sq + 3 * Sk + causal)
    BH = 5
    q, k, v = (rng.normal(size=(BH, s, D)).astype(np.float32)
               for s in (Sq, Sk, Sk))
    do = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    # blocks of 2 of the BH axis, so that the blocked loop runs 3 times
    monkeypatch.setattr(TR, "BWD_BLOCK", 2 * Sq * Sk)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    want = torch.autograd.grad(TR.flash_attention_ref(tq, tk, tv, causal),
                               (tq, tk, tv), torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: RR.flash_attention_ref(a, b, c, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jax_want = vjp(jnp.asarray(do))
    for g, w, j in zip(got, want, jax_want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= ATTN_BWD_TOL * scale
        assert np.abs(g.numpy() - np.asarray(j)).max() <= ATTN_BWD_TOL * scale


def test_attention_backward_keeps_the_inputs_dtypes():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 12, 16)).astype(
        np.float32)).bfloat16().requires_grad_(True) for _ in range(3))
    o = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in grads)


def test_no_grad_or_no_requires_grad_skips_the_function():
    q = torch.randn(2, 8, 16)
    assert ops.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.flash_attention(qg, qg, qg).grad_fn is None


def test_bare_launch_refuses_grad_requiring_inputs():
    """The launch's output has no autograd history: handed a tensor that
    requires grad while grad mode is on, it raises instead of dropping the
    gradient (F3)."""
    q = torch.randn(2, 8, 16, requires_grad=True)
    k = torch.randn(2, 8, 16)
    with pytest.raises(KernelError, match="drop the gradient"):
        _launch(q, k, k, True)
    with pytest.raises(KernelError, match="drop the gradient"):
        _launch(k, k, q, False)


def test_launch_count_unchanged_by_the_cpu_backward():
    q = torch.randn(2, 8, 16, requires_grad=True)
    before = ops.flash_attention.launches
    torch.autograd.grad(ops.flash_attention(q, q, q).sum(), q)
    assert ops.flash_attention.launches == before     # the CPU launches none


# ---------------------------------------------------------------------------
# the SSD scan's backward (F4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 5), (8, 8)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ssd_scan_backward_matches_jax(s, chunk, with_s0):
    """``ssd_scan`` under grad takes its out-of-place route; its gradient
    of every input equals ``jax.grad`` of the JAX scan, and y is the
    no-grad (in-place) route's bit for bit."""
    rng = np.random.default_rng(s + chunk)
    arrs = list(_scan_inputs(rng, s))
    b, _, h, p = arrs[0].shape
    n = arrs[3].shape[-1]
    if with_s0:
        arrs.append(rng.normal(size=(b, h, p, n)).astype(np.float32))
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    ws = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def j_obj(*a):
        y, st = RM.ssd_scan(*a[:5], chunk, *a[5:])
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.jit(jax.grad(j_obj, argnums=tuple(range(len(arrs)))))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, st = TM.ssd_scan(*ts[:5], chunk, *ts[5:])
    tg = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                             + (st * torch.from_numpy(ws)).sum(), ts)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
    with torch.no_grad():
        y2, st2 = TM.ssd_scan(*ts[:5], chunk, *ts[5:])
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_mamba_block_backward_gives_every_leaf_a_gradient():
    cfg = get_smoke_config("mamba2-1.3b")
    from repro_torch.models.sharding import init_params
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs, torch.Generator().manual_seed(0),
                         "cpu")
    _, _, grads = loss_and_grads(model, params, _batch(cfg))
    for g in tree_leaves(grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0
