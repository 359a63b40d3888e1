"""The port's models against the JAX package's, on the CPU: every family.

The JAX package's ``init_params(PRNGKey(0))`` is carried over with
``convert.params_from_numpy``; both packages then run the same prefill and
three teacher-forced decode steps on the same numpy-seeded tokens (and,
for ``vlm`` and ``encdec``, the same numpy-seeded ``prefix``), at the four
dense smoke configs (llama; qwen with ``qkv_bias``; glm4 with kv = 2;
gemma with ``geglu``, tied embeddings and ``head_dim``), the two MoE smoke
configs (qwen3-moe, kimi-k2), whose routes are recorded in both packages:
equal in f32, and a bf16 case names any route that flipped, and the
``ssm`` (mamba2), ``hybrid`` (zamba2), ``encdec`` (whisper) and ``vlm``
(llava) smoke configs.  Every cache tensor of a family is compared (``k``,
``v``, the SSM's ``s`` and ``conv``, the cross-attention's ``xk`` and
``xv``).

Tolerances, relative to max |logit|.  f32 (the parameters cast): 1e-4;
the two packages differ only in the order of f32 sums.  bf16: 2e-2, the
JAX package's own bf16 bound for attention
(``tests/test_flash_attention.py``): the packages round products and
activations to bf16 at the same places, but the f32 sums under them run
in other orders, and a value near a rounding edge can land on the
neighbouring bf16 value.  The K/V caches are bf16 in both dtypes, so an
element may land one bf16 step (2**-8 of it) away in f32 too: every cache
tensor is compared at 2**-8 of its largest magnitude in f32, 2e-2 in bf16.

The JAX ``encdec`` refuses f32 parameters: its encoder's ``lax.scan``
carries the bf16 frames, and the first layer returns f32 (ROADMAP queue
3).  Its f32 cases run the JAX code with ``lax.scan`` unrolled into a
Python loop (``loop_scan``), which computes what the scan would.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.models import layers as RL
from repro.models.sharding import init_params as r_init

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import FAMILIES

torch.set_num_threads(1)

DENSE = ["llama3.2-3b", "qwen1.5-4b", "glm4-9b", "gemma-7b"]
MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
# one each of the ssm, hybrid, encdec and vlm families
OTHER = ["mamba2-1.3b", "zamba2-2.7b", "whisper-small", "llava-next-34b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}          # relative to max |logit|
CACHE_TOL = {"f32": 2.0 ** -8, "bf16": 2e-2}
MAX_SEQ = 32


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(arch, dtype):
    """(cfg, JAX model, JAX params, port model, port params) in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    rcfg = r_smoke(arch)
    rmodel = r_build(rcfg)
    rparams = r_init(rmodel.specs, jax.random.PRNGKey(0))
    rparams = jax.tree.map(lambda a: a.astype(jdt), rparams)
    tmodel = build_model(get_smoke_config(arch), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu",
                                dtype=tdt)
    return rcfg, rmodel, rparams, tmodel, tparams


def loop_scan(f, init, xs, length=None):
    """``jax.lax.scan`` as a Python loop: the same carry and stacked
    outputs, and a carry whose dtype changes is let through."""
    carry, ys = init, []
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


@pytest.fixture
def jax_f32_encdec(monkeypatch):
    """Call with (cfg, dtype) before running the JAX package: an f32
    encdec runs with ``lax.scan`` unrolled (see the module docstring)."""
    def use(cfg, dtype):
        if cfg.family == "encdec" and dtype == "f32":
            monkeypatch.setattr(jax.lax, "scan", loop_scan)
    return use


def _prefix(rng, cfg, B):
    """A numpy-seeded ``prefix`` [B, n_prefix, d_model] f32 for a config
    with a front end (None otherwise), drawn as ``tests/test_arch_smoke.py``
    draws it: standard normal."""
    if cfg.frontend == "none":
        return None
    return rng.normal(size=(B, cfg.n_prefix, cfg.d_model)).astype(np.float32)


@pytest.fixture
def routes(monkeypatch):
    """(jax list, port list): the experts ``idx`` of every MoE dispatch each
    package runs, in call order (the JAX package's through an ordered
    debug callback from inside its layer scan)."""
    from repro.models import moe as RM
    from repro_torch.models import moe as TM
    got_r, got_t = [], []
    r_dispatch, t_route = RM._moe_dispatch, TM.route

    def r_wrapped(p, x, cfg):
        logits = jnp.einsum("td,de->te",
                            x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.experts_per_tok)
        jax.debug.callback(lambda i: got_r.append(np.asarray(i)), idx,
                           ordered=True)
        return r_dispatch(p, x, cfg)

    def t_wrapped(p, x, cfg):
        out = t_route(p, x, cfg)
        got_t.append(out[2].reshape(-1, cfg.experts_per_tok).numpy())
        return out

    monkeypatch.setattr(RM, "_moe_dispatch", r_wrapped)
    monkeypatch.setattr(TM, "route", t_wrapped)
    return got_r, got_t


def _flipped(routes) -> int:
    """Slots routed to another expert by the two packages so far."""
    got_r, got_t = routes
    jax.effects_barrier()
    assert len(got_r) == len(got_t)
    return sum(int((a != b).sum()) for a, b in zip(got_r, got_t))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE + MOE + OTHER)
def test_prefill_and_decode_match_jax(arch, dtype, routes, jax_f32_encdec):
    cfg, rmodel, rparams, tmodel, tparams = _both(arch, dtype)
    jax_f32_encdec(cfg, dtype)
    rng = np.random.default_rng(7)
    B, S, steps = 2, 11, 3
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (B, steps)).astype(np.int32)
    prefix = _prefix(rng, cfg, B)
    r_batch, t_batch = {"tokens": jnp.asarray(tokens)}, {"tokens": tokens}
    if prefix is not None:
        r_batch["prefix"], t_batch["prefix"] = jnp.asarray(prefix), prefix
    # a vlm's prefix takes the first positions of the sequence
    pos0 = S + (cfg.n_prefix if cfg.family == "vlm" else 0)
    max_seq = MAX_SEQ + pos0 - S
    tol = TOL[dtype]

    def where(what):
        # a MoE case names the routes that differ between the packages
        if cfg.family != "moe":
            return what
        n = _flipped(routes)
        assert n == 0 or dtype == "bf16", f"{what}: f32 routes differ at {n}"
        return f"{what}: {n} bf16 routes flipped"

    def caches_agree(what):
        assert sorted(t_cache) == sorted(r_cache), what
        for name, want in r_cache.items():
            got = t_cache[name]
            assert str(got.dtype).split(".")[1] == want.dtype.name, name
            assert tuple(got.shape) == tuple(want.shape), name
            assert _rel_err(got.float(), np.asarray(want, np.float32)) \
                <= CACHE_TOL[dtype], f"{what}: {name}"

    r_logits, r_cache = rmodel.prefill_fn(rparams, r_batch, max_seq)
    t_logits, t_cache = tmodel.prefill_fn(tparams, t_batch, max_seq)
    assert t_logits.dtype == torch.float32
    assert _rel_err(t_logits, r_logits) <= tol, where("prefill")
    caches_agree("prefill")

    for i in range(steps):
        pos = np.full((B,), pos0 + i, np.int32)
        tok = forced[:, i:i + 1]
        r_logits, r_cache = rmodel.decode_fn(rparams, r_cache, jnp.asarray(tok),
                                             jnp.asarray(pos))
        t_logits, t_cache = tmodel.decode_fn(tparams, t_cache, tok, pos)
        assert _rel_err(t_logits, r_logits) <= tol, where(f"step {i}")
    if cfg.family == "moe":
        assert routes[1] and where("the end")
    caches_agree(f"after {steps} steps")


def test_padded_vocab_rows_are_masked():
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"), pad_vocab_to=96)
    assert cfg.padded_vocab == 288
    model = build_model(cfg, device="cpu")
    from repro_torch.models.sharding import init_params
    params = init_params(model.specs, torch.Generator().manual_seed(0), "cpu")
    logits, _ = model.prefill_fn(params, {"tokens": np.zeros((1, 3), np.int64)},
                                 8)
    assert logits.shape == (1, 288)
    assert bool((logits[:, cfg.vocab:] == -1e30).all())
    assert bool((logits[:, :cfg.vocab] > -1e29).all())


def test_params_from_numpy_is_exact_for_bf16():
    rcfg = r_smoke("glm4-9b")
    rparams = r_init(r_build(rcfg).specs, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(rparams)
    for path, leaf in leaves:
        t = tparams
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16
        back = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        assert bool(jnp.array_equal(back, leaf)), path


def test_unknown_family_raises():
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg, device="cpu")


def _spec_count(cfg) -> int:
    """What the spec tree holds beyond ``param_count()``: the final norm's
    d_model weights (an encdec's encoder norm too), and an SSM layer's
    ``dt_bias`` (``param_count()`` counts 2 of its 3 per-head vectors)."""
    extra = cfg.d_model * (2 if cfg.family == "encdec" else 1)
    if cfg.family in ("ssm", "hybrid"):
        extra += cfg.n_layers * cfg.ssm_heads
    return cfg.param_count() + extra


def _specs_match_jax(arch):
    """The spec trees of both packages' smoke models hold the same leaves,
    shapes, logical axes, inits and scales."""
    rspecs = r_build(r_smoke(arch)).specs
    tspecs = build_model(get_smoke_config(arch), device="cpu").specs
    r_leaves = jax.tree_util.tree_leaves_with_path(
        rspecs, is_leaf=lambda x: hasattr(x, "logical"))
    t_leaves = []
    from repro_torch.models.sharding import tree_map
    tree_map(t_leaves.append, tspecs)
    assert len(t_leaves) == len(r_leaves)
    for path, leaf in r_leaves:
        t = tspecs
        for key in path:
            t = t[key.key]
        assert t.shape == leaf.shape and t.init == leaf.init, path
        assert t.scale == leaf.scale and t.logical == leaf.logical, path


@pytest.mark.parametrize("arch", MOE)
def test_build_model_admits_moe(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.sharding import tree_map
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    ffn = model.specs["layers"]["ffn"]
    L, E, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert ffn["router"].shape == (L, d, E)
    assert ffn["wg"].shape == ffn["wu"].shape == (L, E, d, f)
    assert ffn["wd"].shape == (L, E, f, d)
    n = []
    tree_map(lambda s: n.append(int(np.prod(s.shape))), model.specs)
    # param_count() leaves the final norm's d_model weights out
    assert sum(n) == cfg.param_count() + d
    if arch == "qwen3-moe-30b-a3b":
        assert cfg.param_count() == 30_079_123_456
    _specs_match_jax(arch)


# the four families' full-width parameter counts (``param_count()``)
FULL_WIDTH = {"mamba2-1.3b": 1_446_500_352, "zamba2-2.7b": 2_422_379_968,
              "whisper-small": 334_514_688,
              "llava-next-34b": 34_388_910_080}


@pytest.mark.parametrize("arch", OTHER)
def test_spec_tree_matches_jax(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.sharding import tree_map
    cfg = get_config(arch)
    specs = build_model(cfg, device="cpu").specs
    n = []
    tree_map(lambda s: n.append(int(np.prod(s.shape))), specs)
    assert cfg.param_count() == FULL_WIDTH[arch]
    assert sum(n) == _spec_count(cfg)
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        wz = specs["layers"]["mixer"]["wz"]
        assert wz.shape == (groups, cfg.attn_every, cfg.d_model, cfg.d_inner)
        assert wz.logical[:2] == ("layers", "layers")
        assert specs["shared_attn"]["attn"]["wq"].shape == (
            cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.family == "encdec":
        assert specs["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
        assert specs["dec_layers"]["xattn"]["wk"].shape[0] == cfg.n_layers
    _specs_match_jax(arch)


def test_every_family_builds_on_the_cpu():
    from repro_torch.configs import get_smoke_config as smoke, list_archs
    from repro_torch.models.sharding import init_params
    seen = {smoke(a).family for a in list_archs()}
    assert seen == set(FAMILIES)
    rng = np.random.default_rng(0)
    for arch in list_archs():
        cfg = smoke(arch)
        model = build_model(cfg, device="cpu")
        assert model.cfg.family in FAMILIES
        params = init_params(model.specs, torch.Generator().manual_seed(0),
                             "cpu")
        toks = rng.integers(0, cfg.vocab, (2, 8))
        batch = {"tokens": toks, "labels": toks}
        prefix = _prefix(rng, cfg, 2)
        if prefix is not None:
            batch["prefix"] = prefix
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, batch)
        assert loss.shape == () and torch.isfinite(loss), arch
        assert torch.isfinite(metrics["ce"]), arch


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_decode_continues_the_prefill_state(arch):
    """Decoding token S after an S-token prefill gives the logits of a
    full (S+1)-token prefill: the prefill hands its real final SSM states
    and conv tails to decode (``tests/test_mamba_ssd.py``'s check, at its
    4e-2 in bf16, and in f32 at 1e-4)."""
    from repro_torch.models.sharding import init_params, tree_map
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
    for p, tol in ((params, 4e-2), (tree_map(lambda t: t.float(), params),
                                    1e-4)):
        full, _ = model.prefill_fn(p, {"tokens": toks}, 24)
        _, cache = model.prefill_fn(p, {"tokens": toks[:, :S]}, 24)
        dec, cache2 = model.decode_fn(p, cache, toks[:, S:],
                                      np.full((B,), S, np.int64))
        assert cache2 is cache                 # written in place
        assert _rel_err(dec, full) <= tol


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_generator_with_prefix_matches_jax(arch, jax_f32_encdec):
    """Greedy tokens of ``Generator.generate(prefix=)`` equal the JAX
    ``Generator``'s in f32: a vlm decodes from S + n_prefix, an encdec from
    S (a wrong first position moves RoPE, and the tokens)."""
    from repro.serve.serve_step import Generator as RGen
    from repro_torch.serve.serve_step import Generator
    cfg, rmodel, rparams, tmodel, tparams = _both(arch, "f32")
    jax_f32_encdec(cfg, "f32")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    prefix = _prefix(rng, cfg, 2)
    max_seq = 9 + 8 + (cfg.n_prefix if cfg.family == "vlm" else 0)
    want = RGen(rmodel, rparams, max_seq=max_seq).generate(
        tokens, 8, prefix=prefix)
    got = Generator(tmodel, tparams, max_seq=max_seq, device="cpu").generate(
        tokens, 8, prefix=prefix)
    np.testing.assert_array_equal(got, np.asarray(want))
    positions = []
    logged = tmodel._replace(decode_fn=lambda p, c, t, pos: (
        positions.append(int(pos[0])), tmodel.decode_fn(p, c, t, pos))[1])
    Generator(logged, tparams, max_seq=max_seq, device="cpu").generate(
        tokens, 3, prefix=prefix)
    first = 9 + (cfg.n_prefix if cfg.family == "vlm" else 0)
    assert positions == [first, first + 1, first + 2]


@pytest.mark.parametrize("arch", OTHER)
def test_batcher_refuses_the_other_families(arch):
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.models.sharding import init_params
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ContinuousBatcher(model, params, n_slots=2, max_seq=32)


# ---------------------------------------------------------------------------
# layers, one by one (f32 unless named)
# ---------------------------------------------------------------------------

def _pair(rng, shape, dtype=np.float32):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 64))
    jw, tw = _pair(rng, (64,))
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        got = TL.rmsnorm(tx.to(tdt), tw.to(tdt))
        assert got.dtype == tdt
        assert _rel_err(got.float(), RL.rmsnorm(jx.astype(jdt), jw.astype(jdt))
                        .astype(jnp.float32)) <= tol


def test_rope():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 9, 4, 32))
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    want = RL.rope(jx, jnp.asarray(pos), 500_000.0)
    got = TL.rope(tx, torch.from_numpy(pos), 500_000.0)
    assert _rel_err(got, want) <= 1e-5
    gotb = TL.rope(tx.bfloat16(), torch.from_numpy(pos), 10_000.0)
    assert gotb.dtype == torch.bfloat16
    wantb = RL.rope(jx.astype(jnp.bfloat16), jnp.asarray(pos), 10_000.0)
    assert _rel_err(gotb.float(), wantb.astype(jnp.float32)) <= 2e-2


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-7b"])
def test_mlp_both_activations(arch):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, (2, 5, cfg.d_model))
    jp, tp = {}, {}
    for name, shape in (("wg", (cfg.d_model, cfg.d_ff)),
                        ("wu", (cfg.d_model, cfg.d_ff)),
                        ("wd", (cfg.d_ff, cfg.d_model))):
        jp[name], tp[name] = _pair(rng, shape)
    assert cfg.activation == ("geglu" if arch == "gemma-7b" else "swiglu")
    assert _rel_err(TL.mlp(tp, tx, cfg), RL.mlp(jp, jx, r_smoke(arch))) <= 1e-5


def test_expand_kv_matches_jnp_repeat():
    rng = np.random.default_rng(3)
    jk, tk = _pair(rng, (2, 6, 2, 8))
    got = TL._expand_kv(tk, 8)
    want = RL._expand_kv(jk, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # head h reads KV head h // 4 (not h % 2, which Tensor.repeat would give)
    np.testing.assert_array_equal(got[:, :, 3].numpy(), tk[:, :, 0].numpy())
    np.testing.assert_array_equal(got[:, :, 4].numpy(), tk[:, :, 1].numpy())
    assert TL._expand_kv(tk, 2) is tk


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen1.5-4b"])
def test_decode_attention(arch):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(4)
    B, S = 3, 16
    H, KV, Dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    jp, tp = {}, {}
    for name, shape in (("wq", (d, H, Dh)), ("wk", (d, KV, Dh)),
                        ("wv", (d, KV, Dh)), ("wo", (H, Dh, d)),
                        ("bq", (H, Dh)), ("bk", (KV, Dh)), ("bv", (KV, Dh))):
        jp[name], tp[name] = _pair(rng, shape)
        tp[name] = tp[name] * 0.1
        jp[name] = jp[name] * 0.1
    jx, tx = _pair(rng, (B, 1, d))
    ck = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    cv = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    position = np.array([0, 7, S - 1], np.int32)
    jo, jck, jcv = RL.decode_attention(
        jp, jx, r_smoke(arch), jnp.asarray(ck).astype(jnp.bfloat16),
        jnp.asarray(cv).astype(jnp.bfloat16), jnp.asarray(position))
    tck = torch.from_numpy(ck).bfloat16()
    tcv = torch.from_numpy(cv).bfloat16()
    to, tck2, tcv2 = TL.decode_attention(tp, tx, cfg, tck, tcv,
                                         torch.from_numpy(position))
    assert tck2 is tck and tcv2 is tcv        # written in place
    assert _rel_err(to, jo) <= 2e-3
    np.testing.assert_array_equal(tck.float().numpy(),
                                  np.asarray(jck, np.float32))
    np.testing.assert_array_equal(tcv.float().numpy(),
                                  np.asarray(jcv, np.float32))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "glm4-9b",
                                  "zamba2-2.7b", "mamba2-1.3b",
                                  "whisper-small"])
def test_init_params_draws_stacked_leaves_one_layer_at_a_time(arch,
                                                              monkeypatch):
    """A leaf stacked over the layers is drawn one layer at a time; the
    hybrid's ``[groups, attn_every, ...]`` leaves (both axes ``"layers"``)
    one group at a time, the whole ``[attn_every, ...]`` block a draw."""
    import dataclasses
    from repro_torch.models.sharding import init_params, tree_map
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 * max(cfg.attn_every, 1))
    model = build_model(cfg, device="cpu")
    drawn = []
    randn = torch.randn

    def counted(*a, **kw):
        out = randn(*a, **kw)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", counted)
    params = init_params(model.specs, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.undo()
    specs, leaves = [], []
    tree_map(specs.append, model.specs)
    tree_map(leaves.append, params)
    largest_layer = max(int(np.prod(s.shape[1:])) for s in specs
                        if s.logical[0] == "layers")
    assert max(drawn) == max(largest_layer, cfg.vocab * cfg.d_model)
    assert sum(drawn) == sum(int(np.prod(s.shape)) for s in specs
                             if s.init == "normal")
    for spec, t in zip(specs, leaves):
        assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
        x = t.float()
        if spec.init != "normal":
            assert bool((x == (1.0 if spec.init == "ones" else 0.0)).all())
            continue
        # each layer's draw is its own: N(0, scale^2) within 5 sigma of
        # the sample std's spread, and no two layers alike
        n = x[0].numel() if spec.logical[0] == "layers" else x.numel()
        rows = x.reshape(spec.shape[0], -1) if spec.logical[0] == "layers" \
            else x.reshape(1, -1)
        for r in rows:
            assert abs(float(r.std()) / spec.scale - 1) <= 5 / np.sqrt(2 * n)
            assert abs(float(r.mean())) <= 5 * spec.scale / np.sqrt(n)
        if len(rows) > 1:
            assert not torch.equal(rows[0], rows[1])
