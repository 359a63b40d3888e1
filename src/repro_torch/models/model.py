"""Model assembly: param specs + loss / prefill / decode fns for all six
families.

``build_model(cfg, device)`` returns a ``Model`` bundle, as in the JAX
package:
  * ``specs``        — tree of ParamSpec (shapes + logical axes)
  * ``loss_fn``      — (params, batch) -> (loss, metrics); ``batch``
                       holds ``tokens`` and ``labels`` (< 0: masked) and,
                       for ``vlm`` and ``encdec``, the ``prefix``
  * ``prefill_fn``   — (params, batch, max_seq) -> (logits_last, cache);
                       ``batch`` holds ``tokens`` and, for ``vlm`` and
                       ``encdec``, the ``prefix`` embeddings
  * ``decode_fn``    — (params, cache, tokens, position) -> (logits, cache)
  * ``init_cache``   — cache spec for a (batch, max_seq) shape

Parameters are a dict tree shaped like the JAX package's, with the layers
stacked ``[L, ...]`` (the hybrid's SSM layers ``[groups, attn_every,
...]``); the layer loop is a Python loop (PyTorch runs eagerly: no scan).
The loss runs a cache-free forward whose layers, under ``cfg.remat``, are
``torch.utils.checkpoint`` calls (non-reentrant) placed where the JAX
package places ``jax.checkpoint``: a layer at a time, a hybrid group at a
time, and each cross-entropy chunk.  Every family is ported: ``dense``,
``moe`` (a layer's FFN is ``moe.moe_block``, whose aux loss serving
drops, as the JAX package's does), ``vlm`` (the decoder with the ``prefix`` prepended), ``ssm`` (Mamba2
layers, ``mamba.py``), ``hybrid`` (groups of Mamba2 layers, each closed by
one shared attention + MLP block) and ``encdec`` (a non-causal encoder over
the ``prefix`` frames, a decoder with cross-attention).  K/V caches are
bf16 ``[L, B, max_seq, KV, D]``, the SSM state and conv tail f32 with no
sequence axis; prefill fills them and decode writes each step into them in
place, where the JAX package returns updated copies.  Prefill and decode
run under ``no_grad``; the loss never calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.device_stats import resolve_device
from . import layers as L
from .mamba import SSMState, mamba_block, mamba_decode_step, mamba_specs
from .moe import moe_block, moe_specs
from .sharding import (ParamSpec, constrain, current_mesh, mesh_zeros, on_mesh,
                       tree_leaves, tree_map)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


class Model(NamedTuple):
    cfg: ModelConfig
    specs: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# logical axes of each cache leaf's trailing dims (leading dims: layers)
CACHE_LOGICAL = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "xk": ("batch", "kv_seq", "kv_heads", None),
    "xv": ("batch", "kv_seq", "kv_heads", None),
    "s": ("batch", "ssm_heads", None, None),
    "conv": ("batch", None, None),
}


def alloc_cache(shapes: Dict[str, CacheSpec], device) -> Dict[str, torch.Tensor]:
    """Zero tensors for a cache spec (``init_cache``'s result); on a mesh,
    DTensors sharded by ``CACHE_LOGICAL`` under the active rules (the
    shardings ``launch.specs.cache_shardings`` gives the decode cache)."""
    if on_mesh():
        return {name: mesh_zeros(
            s.shape, s.dtype,
            ("layers",) * (len(s.shape) - len(CACHE_LOGICAL[name]))
            + CACHE_LOGICAL[name]) for name, s in shapes.items()}
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in shapes.items()}


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    V = cfg.padded_vocab
    out = {
        "embed": ParamSpec((V, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((V, cfg.d_model), ("vocab", "embed"))
    return out


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    if on_mesh():
        x = _embed_on_mesh(params["embed"], tokens.long())
    else:
        x = params["embed"][tokens.long()]
    return constrain(x, "batch", "seq", "embed")


def _embed_on_mesh(table, tokens):
    """The lookup on the active mesh, through ``local_map``: the table
    gathered whole, each rank reading its own rows of the batch.  The
    table's gradient is then a ``Partial`` sum over the mesh dims that
    shard the tokens.  (DTensor's own strategy for the indexed read's
    backward, ``index_put``, fails on some torch releases; the gather of
    the vocab-sharded table is what that strategy does too.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    tokens = constrain(tokens, "batch", "seq")
    tok_pl = tuple(tokens.placements)
    rep = tuple(Replicate() for _ in tok_pl)
    grad_pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in tok_pl)
    fn = local_map(lambda t, i: t[i], out_placements=(tok_pl,),
                   in_placements=(rep, tok_pl),
                   in_grad_placements=(grad_pl, tok_pl),
                   device_mesh=current_mesh(), redistribute_inputs=True)
    return fn(table, tokens)


def _unembed_matrix(params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


# ``torch.utils.checkpoint``'s check that the recompute's tensors have the
# forward's metadata.  The dry-run (``launch/dryrun.py``) turns it off for
# its step: its fake tensors give the MoE dispatch's kept slots a new
# unknown size at each run, which the check cannot compare.
REMAT_DETERMINISM_CHECK = "default"


def _checkpointed(fn, *args):
    """``fn(*args)``, in grad mode as a non-reentrant
    ``torch.utils.checkpoint`` call (``jax.checkpoint``): its activations
    are recomputed in the backward.  The reentrant variant would drop the
    gradients of parameters that reach ``fn`` through a dict when no
    tensor argument requires grad."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          determinism_check=REMAT_DETERMINISM_CHECK)
    return fn(*args)


def _remat(cfg: ModelConfig, fn, *args):
    """A layer (or a hybrid group) of the loss: checkpointed under
    ``cfg.remat``."""
    return _checkpointed(fn, *args) if cfg.remat else fn(*args)


def _chunk_loss(h, lab, W, vocab: int):
    """(sum of the CE over the valid labels, their count) of one chunk:
    f32 logits of h [B, c, d] against W [V, d], padded vocab rows at
    -1e30.  On a mesh: ``_chunk_loss_on_mesh``."""
    if on_mesh():
        return _chunk_loss_on_mesh(h, lab, W, vocab)
    logits = L._mm("bcd,vd->bcv", h, W).float()
    if W.shape[0] > vocab:      # mask padded vocab rows out of the CE
        pad = torch.arange(W.shape[0], device=logits.device) >= vocab
        logits = logits.masked_fill(pad[None, None, :], -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
    valid = (lab >= 0).float()
    return ((logz - ll) * valid).sum(), valid.sum()


class _VocabParallelCE(torch.autograd.Function):
    """The CE rows of a rank's vocab shard of the logits, [b, c, V_l] f32
    (global vocab ids ``start`` + 0 .. V_l - 1): the max, the sum of
    exponentials and the target's logit all-reduced over ``groups`` (the
    mesh dims that shard the vocab).  The backward is local: softmax minus
    the target's one-hot, on the shard."""

    @staticmethod
    def forward(ctx, logits, lab, start: int, groups):
        import torch.distributed._functional_collectives as funcol
        m = logits.amax(dim=-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        e = torch.exp(logits - m)
        se = e.sum(dim=-1, keepdim=True)
        idx = lab - start
        mine = (idx >= 0) & (idx < logits.shape[-1])
        idx = idx.clamp(0, logits.shape[-1] - 1)
        ll = torch.where(mine, logits.gather(-1, idx[..., None])[..., 0], 0.0)
        for g in groups:
            se = funcol.all_reduce(se, "sum", g)
            ll = funcol.all_reduce(ll, "sum", g)
        ctx.save_for_backward(e / se, idx, mine)
        return torch.log(se[..., 0]) + m[..., 0] - ll

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(mine, -g, 0.0)[..., None])
        return grad, None, None, None


def _chunk_loss_on_mesh(h, lab, W, vocab: int):
    """``_chunk_loss`` on the active mesh: a vocab-parallel CE through
    ``local_map``.  Each rank takes the logits of its rows (the DP dims)
    and its vocab shard (the dims sharding W's rows) and all-reduces three
    [b, c] values over the vocab dims, where the DTensor ops gather each
    chunk's logits whole over the vocab, and the gather's backward
    allocates the global [B, c, V] logits on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    lab = constrain(lab, "batch", "seq")
    vdims = [i for i, p in enumerate(W.placements) if p == Shard(0)]
    bdims = [i for i, p in enumerate(lab.placements) if p == Shard(0)]
    dims = range(mesh.ndim)
    lab_pl = tuple(Shard(0) if i in bdims else Replicate() for i in dims)
    w_pl = tuple(Shard(0) if i in vdims else Replicate() for i in dims)
    out_pl = tuple(Partial() if i in bdims else Replicate() for i in dims)
    h_grad = tuple(Shard(0) if i in bdims else Partial() if i in vdims
                   else Replicate() for i in dims)
    w_grad = tuple(Shard(0) if i in vdims else Partial() if i in bdims
                   else Replicate() for i in dims)

    def local(h, W, lab):
        logits = L._mm("bcd,vd->bcv", h, W).float()
        start = 0
        for i in vdims:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
        start *= W.shape[0]
        if start + W.shape[0] > vocab:      # padded vocab rows
            pad = torch.arange(start, start + W.shape[0],
                               device=logits.device) >= vocab
            logits = logits.masked_fill(pad[None, None, :], -1e30)
        rows = _VocabParallelCE.apply(logits, lab.long(), start,
                                      [(mesh, i) for i in vdims])
        valid = (lab >= 0).float()
        return (rows * valid).sum(), valid.sum()

    fn = local_map(local, out_placements=(out_pl, out_pl),
                   in_placements=(lab_pl, w_pl, lab_pl),
                   in_grad_placements=(h_grad, w_grad, lab_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(h, W, lab)


def _lm_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Chunked cross-entropy: never materialises [B, S, V] for the full S.

    labels < 0 are masked (the VLM prefix, padding).  Each chunk of
    ``logits_chunk`` positions runs under a checkpoint (as the JAX
    package's ``jax.checkpoint``), the sums added in chunk order in f32."""
    S = hidden.shape[1]
    W = _unembed_matrix(params)
    c = min(cfg.logits_chunk, S)
    pad = (-S) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S + pad, c):
        t, n = _checkpointed(_chunk_loss, hidden[:, i:i + c],
                             labels[:, i:i + c], W, cfg.vocab)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _batch_tensor(batch, key: str, device) -> torch.Tensor:
    return torch.as_tensor(batch[key], device=device)


def _last_logits(params, hidden: torch.Tensor,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """f32 logits [B, V] of the last position; padded vocab rows are
    -1e30."""
    W = _unembed_matrix(params)
    logits = L._mm("bd,vd->bv", hidden[:, -1, :], W).float()
    if cfg is not None and W.shape[0] > cfg.vocab:
        pad = torch.arange(W.shape[0], device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad[None, :], -1e30)
    return constrain(logits, "batch", "vocab")


# ---------------------------------------------------------------------------
# decoder-only transformer (dense / moe / vlm)
# ---------------------------------------------------------------------------

def _layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_specs(cfg),
    }
    specs["ffn"] = moe_specs(cfg) if cfg.family == "moe" else L.mlp_specs(cfg)
    return specs


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on the normalised stream: the gated MLP, or the MoE
    block with its aux loss dropped (serving)."""
    if cfg.family == "moe":
        return moe_block(lp["ffn"], x, cfg)[0]
    return L.mlp(lp["ffn"], x, cfg)


def _stack_specs_tree(tree, n: int):
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), logical=("layers", *s.logical)), tree)


def _decoder_specs(cfg: ModelConfig):
    return {
        **_embed_specs(cfg),
        "layers": _stack_specs_tree(_layer_specs(cfg), cfg.n_layers),
    }


def layer_params(params, i: int, key: str = "layers"):
    """Layer ``i``'s parameters: a view of every stacked leaf of
    ``params[key]`` (for the hybrid, ``i`` may be a (group, layer) pair)."""
    return tree_map(lambda p: p[i], params[key])


def unstacked(tree) -> list:
    """The layers of a tree stacked ``[L, ...]`` as a list of L trees of
    views, by one ``torch.unbind`` a leaf.  The loss takes its layers so:
    in the backward each leaf's gradient is then one ``stack`` of its
    layers', where indexing one layer at a time (``layer_params``) would
    zero-fill a tensor of the whole stacked leaf for every layer."""
    views = tree_map(lambda p: p.unbind(0), tree)
    n = len(tree_leaves(views)[0])
    return [tree_map(lambda v: v[i], views) for i in range(n)]


def _kv_cache_shapes(cfg: ModelConfig, n: int, batch: int, max_seq: int):
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = CacheSpec((n, batch, max_seq, KV, Dh), torch.bfloat16)
    return {"k": kv, "v": kv}


def _decoder_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return _kv_cache_shapes(cfg, cfg.n_layers, batch, max_seq)


def _self_attention_prefill(p, xn: torch.Tensor, cfg: ModelConfig,
                            positions: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of a prefill (through the flash kernel on the
    card): writes the prompt's K/V into ``cache_k`` / ``cache_v`` [B,
    max_seq, KV, D] and returns the block's output [B, S, d]."""
    q, k, v = L.qkv_project(p, xn, cfg, positions)
    o = L.chunked_attention(q, L._expand_kv(k, cfg.n_heads),
                            L._expand_kv(v, cfg.n_heads), causal=True,
                            chunk=cfg.attn_chunk)
    for c, t in ((cache_k, k), (cache_v, v)):
        L.write_prompt(c, t.to(c.dtype))
    return L._mm("bshk,hkd->bsd", o, p["wo"])


def _embed_tokens(params, tokens, device) -> torch.Tensor:
    return _embed(params, torch.as_tensor(tokens, device=device))


def _prefix(batch, device, dtype) -> torch.Tensor:
    return torch.as_tensor(batch["prefix"], device=device).to(dtype)


@torch.no_grad()
def _decoder_prefill(params, batch, cfg: ModelConfig, max_seq: int, device):
    """Run the prompt (after the ``prefix``, for a ``vlm``) through the
    stack, returning (last_logits, cache)."""
    x = _embed_tokens(params, batch["tokens"], device)
    if cfg.frontend != "none" and "prefix" in batch:
        x = torch.cat([_prefix(batch, device, x.dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=device)[None, :]
    cache = alloc_cache(_decoder_cache_shapes(cfg, B, max_seq), device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x = x + _self_attention_prefill(lp["attn"], L.rmsnorm(x, lp["ln1"]),
                                        cfg, positions, cache["k"][i],
                                        cache["v"][i])
        x = x + _ffn(lp, L.rmsnorm(x, lp["ln2"]), cfg)
    # rmsnorm is per position: normalise only the last one
    hidden = L.rmsnorm(x[:, -1:], params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


@torch.no_grad()
def _decoder_decode(params, cache, tokens, position, cfg: ModelConfig, device):
    """One decode step for the whole batch (tokens: [B, 1]); writes the
    step's K/V into ``cache`` in place and returns (logits, cache)."""
    x = _embed_tokens(params, tokens, device)
    position = torch.as_tensor(position, device=device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        xn = L.rmsnorm(x, lp["ln1"])
        o, _, _ = L.decode_attention(lp["attn"], xn, cfg, cache["k"][i],
                                     cache["v"][i], position)
        x = x + o
        x = x + _ffn(lp, L.rmsnorm(x, lp["ln2"]), cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


# -- training: the cache-free forward and its loss -------------------------

def _decoder_layer(lp, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor):
    """One decoder layer of the loss: (x after it, the MoE aux loss or
    0)."""
    x = x + L.attention(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg, positions)
    if cfg.family == "moe":
        f, aux = moe_block(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg)
    else:
        f, aux = L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg), 0.0
    return x + f, aux


def _decoder_hidden(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstacked(params["layers"]):
        x, a = _remat(cfg, _decoder_layer, lp, x, cfg, positions)
        aux = aux + a
    return L.rmsnorm(x, params["final_norm"]), aux


def _tokens_to_hidden(params, batch, cfg: ModelConfig, device):
    """The decoder stack over the embedded tokens, after the ``prefix`` for
    a ``vlm``: (final hidden, summed aux loss)."""
    x = _embed_tokens(params, batch["tokens"], device)
    if cfg.frontend != "none" and "prefix" in batch:
        prefix = constrain(_prefix(batch, device, x.dtype), "batch",
                           "prefix", "embed")
        x = torch.cat([prefix, x], dim=1)
    positions = torch.arange(x.shape[1], device=device)[None, :]
    return _decoder_hidden(params, x, cfg, positions)


def _decoder_loss(params, batch, cfg: ModelConfig, device):
    hidden, aux = _tokens_to_hidden(params, batch, cfg, device)
    labels = _batch_tensor(batch, "labels", device).long()
    if cfg.frontend != "none" and "prefix" in batch:
        npf = batch["prefix"].shape[1]
        labels = F.pad(labels, (npf, 0), value=-1)
    ce = _lm_loss(params, hidden, labels, cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (zamba2)
# ---------------------------------------------------------------------------

def _ssm_block_specs(cfg: ModelConfig):
    return {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": mamba_specs(cfg),
    }


def _ssm_specs(cfg: ModelConfig):
    return {**_embed_specs(cfg),
            "layers": _stack_specs_tree(_ssm_block_specs(cfg), cfg.n_layers)}


def _ssm_state_shapes(cfg: ModelConfig, lead: Tuple[int, ...], batch: int):
    """The f32 SSM state and conv tail of ``lead`` stacked layers: no
    sequence axis, whatever the prompt's length."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "s": CacheSpec((*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                       torch.float32),
        "conv": CacheSpec((*lead, batch, cfg.conv_kernel - 1, di + 2 * n),
                          torch.float32),
    }


def _ssm_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    del max_seq  # constant-size state: the point of SSMs
    return _ssm_state_shapes(cfg, (cfg.n_layers,), batch)


def _mamba_prefill(lp, x: torch.Tensor, cfg: ModelConfig, cache, at):
    """One Mamba2 layer of a prefill: the residual stream after it, with
    its final state and conv tail written into ``cache[...][at]``."""
    y, st = mamba_block(lp["mixer"], L.rmsnorm(x, lp["ln"]), cfg,
                        return_state=True)
    cache["s"][at] = st.s
    cache["conv"][at] = st.conv
    return x + y


def _mamba_decode(lp, x: torch.Tensor, cfg: ModelConfig, cache, at):
    """One Mamba2 layer of a decode step, from and into ``cache[...][at]``
    (written in place)."""
    y, st = mamba_decode_step(lp["mixer"], L.rmsnorm(x, lp["ln"]),
                              SSMState(cache["s"][at], cache["conv"][at]),
                              cfg)
    cache["s"][at] = st.s
    cache["conv"][at] = st.conv
    return x + y


@torch.no_grad()
def _ssm_prefill(params, batch, cfg: ModelConfig, max_seq: int, device):
    # Prefill = full forward, carrying out each layer's final SSM state
    # (the chunked scan produces it for free) + conv tail for decode.
    x = _embed_tokens(params, batch["tokens"], device)
    cache = alloc_cache(_ssm_cache_shapes(cfg, x.shape[0], max_seq), device)
    for i in range(cfg.n_layers):
        x = _mamba_prefill(layer_params(params, i), x, cfg, cache, i)
    hidden = L.rmsnorm(x[:, -1:], params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


@torch.no_grad()
def _ssm_decode(params, cache, tokens, position, cfg: ModelConfig, device):
    del position  # the state carries it
    x = _embed_tokens(params, tokens, device)
    for i in range(cfg.n_layers):
        x = _mamba_decode(layer_params(params, i), x, cfg, cache, i)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


def _ssm_layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + mamba_block(lp["mixer"], L.rmsnorm(x, lp["ln"]), cfg)


def _ssm_loss(params, batch, cfg: ModelConfig, device):
    x = _embed_tokens(params, batch["tokens"], device)
    for lp in unstacked(params["layers"]):
        x = _remat(cfg, _ssm_layer, lp, x, cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    ce = _lm_loss(params, hidden,
                  _batch_tensor(batch, "labels", device).long(), cfg)
    return ce, {"ce": ce}


# -- hybrid (zamba2): groups of SSM layers + one SHARED attention block ------

def _hybrid_specs(cfg: ModelConfig):
    assert cfg.n_layers % cfg.attn_every == 0
    groups = cfg.n_layers // cfg.attn_every
    stacked = _stack_specs_tree(
        _stack_specs_tree(_ssm_block_specs(cfg), cfg.attn_every), groups)
    return {
        **_embed_specs(cfg),
        "layers": stacked,                       # [groups, attn_every, ...]
        "shared_attn": {
            "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attn_specs(cfg),
            "ffn": L.mlp_specs(cfg),
        },
    }


def _hybrid_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    groups = cfg.n_layers // cfg.attn_every
    return {**_ssm_state_shapes(cfg, (groups, cfg.attn_every), batch),
            **_kv_cache_shapes(cfg, groups, batch, max_seq)}


def _hybrid_group(gp, shared, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """A group of the loss: its Mamba2 layers (``gp``, stacked
    ``[attn_every, ...]``), then the shared block."""
    for lp in unstacked(gp):
        x = _ssm_layer(lp, x, cfg)
    x = x + L.attention(shared["attn"], L.rmsnorm(x, shared["ln1"]), cfg,
                        positions)
    return x + L.mlp(shared["ffn"], L.rmsnorm(x, shared["ln2"]), cfg)


def _hybrid_loss(params, batch, cfg: ModelConfig, device):
    x = _embed_tokens(params, batch["tokens"], device)
    positions = torch.arange(x.shape[1], device=device)[None, :]
    for gp in unstacked(params["layers"]):
        x = _remat(cfg, _hybrid_group, gp, params["shared_attn"], x, cfg,
                   positions)
    hidden = L.rmsnorm(x, params["final_norm"])
    ce = _lm_loss(params, hidden,
                  _batch_tensor(batch, "labels", device).long(), cfg)
    return ce, {"ce": ce}


@torch.no_grad()
def _hybrid_prefill(params, batch, cfg: ModelConfig, max_seq: int, device):
    x = _embed_tokens(params, batch["tokens"], device)
    B, S = x.shape[0], x.shape[1]
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=device)[None, :]
    shared = params["shared_attn"]
    cache = alloc_cache(_hybrid_cache_shapes(cfg, B, max_seq), device)
    for g in range(cfg.n_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            x = _mamba_prefill(layer_params(params, (g, i)), x, cfg, cache,
                               (g, i))
        # the shared attention block closes the group
        x = x + _self_attention_prefill(
            shared["attn"], L.rmsnorm(x, shared["ln1"]), cfg, positions,
            cache["k"][g], cache["v"][g])
        x = x + L.mlp(shared["ffn"], L.rmsnorm(x, shared["ln2"]), cfg)
    hidden = L.rmsnorm(x[:, -1:], params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


@torch.no_grad()
def _hybrid_decode(params, cache, tokens, position, cfg: ModelConfig, device):
    x = _embed_tokens(params, tokens, device)
    position = torch.as_tensor(position, device=device)
    shared = params["shared_attn"]
    for g in range(cfg.n_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            x = _mamba_decode(layer_params(params, (g, i)), x, cfg, cache,
                              (g, i))
        o, _, _ = L.decode_attention(shared["attn"],
                                     L.rmsnorm(x, shared["ln1"]), cfg,
                                     cache["k"][g], cache["v"][g], position)
        x = x + o
        x = x + L.mlp(shared["ffn"], L.rmsnorm(x, shared["ln2"]), cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def _encdec_specs(cfg: ModelConfig):
    enc_layer = {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_specs(cfg),
        "ffn": L.mlp_specs(cfg),
    }
    dec_layer = {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_x": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_specs(cfg),
        "xattn": L.attn_specs(cfg),
        "ffn": L.mlp_specs(cfg),
    }
    return {
        **_embed_specs(cfg),
        "enc_layers": _stack_specs_tree(enc_layer, cfg.n_enc_layers),
        "enc_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "dec_layers": _stack_specs_tree(dec_layer, cfg.n_layers),
    }


def _encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over ``frames`` [B, T, d]: non-causal attention with
    RoPE (through the flash kernel on the card), then the final norm."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in unstacked(params["enc_layers"]):
        x = _remat(cfg, _encoder_layer, lp, x, cfg, positions)
    return L.rmsnorm(x, params["enc_norm"])


def _encoder_layer(lp, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                        positions, causal=False, use_rope=True)
    return x + L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg)


def _cross_attention(lp, x, memory, cfg: ModelConfig):
    """Attention of the decoder stream ``x`` [B, S, d] over the encoder's
    ``memory`` [B, T, d]: no RoPE, no mask, Sq = S against Sk = T through
    the flash kernel on the card."""
    q = L._mm("bsd,dhk->bshk", x, lp["wq"])
    k = L._mm("btd,dhk->bthk", memory, lp["wk"])
    v = L._mm("btd,dhk->bthk", memory, lp["wv"])
    k = L._expand_kv(k, cfg.n_heads)
    v = L._expand_kv(v, cfg.n_heads)
    o = L.chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return L._mm("bshk,hkd->bsd", o, lp["wo"])


def _encdec_dec_layer(lp, x: torch.Tensor, memory: torch.Tensor,
                      cfg: ModelConfig, positions: torch.Tensor):
    x = x + L.attention(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg, positions)
    x = x + _cross_attention(lp["xattn"], L.rmsnorm(x, lp["ln_x"]), memory,
                             cfg)
    return x + L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg)


def _encdec_loss(params, batch, cfg: ModelConfig, device):
    # the frames go in as bf16 whatever the parameters' dtype, as in the
    # JAX package
    memory = _encode(params, _prefix(batch, device, torch.bfloat16), cfg)
    x = _embed_tokens(params, batch["tokens"], device)
    positions = torch.arange(x.shape[1], device=device)[None, :]
    for lp in unstacked(params["dec_layers"]):
        x = _remat(cfg, _encdec_dec_layer, lp, x, memory, cfg, positions)
    hidden = L.rmsnorm(x, params["final_norm"])
    ce = _lm_loss(params, hidden,
                  _batch_tensor(batch, "labels", device).long(), cfg)
    return ce, {"ce": ce}


def _encdec_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                         n_prefix: Optional[int] = None):
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    # cross-attention K/V precomputed from the encoder memory
    xkv = CacheSpec((cfg.n_layers, batch, n_prefix or cfg.n_prefix, KV, Dh),
                    torch.bfloat16)
    return {**_kv_cache_shapes(cfg, cfg.n_layers, batch, max_seq),
            "xk": xkv, "xv": xkv}


@torch.no_grad()
def _encdec_prefill(params, batch, cfg: ModelConfig, max_seq: int, device):
    # the frames go in as bf16 whatever the parameters' dtype, as in the
    # JAX package
    memory = _encode(params, _prefix(batch, device, torch.bfloat16), cfg)
    x = _embed_tokens(params, batch["tokens"], device)
    B, S = x.shape[0], x.shape[1]
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=device)[None, :]
    cache = alloc_cache(_encdec_cache_shapes(cfg, B, max_seq,
                                             memory.shape[1]), device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "dec_layers")
        x = x + _self_attention_prefill(lp["attn"], L.rmsnorm(x, lp["ln1"]),
                                        cfg, positions, cache["k"][i],
                                        cache["v"][i])
        x = x + _cross_attention(lp["xattn"], L.rmsnorm(x, lp["ln_x"]),
                                 memory, cfg)
        x = x + L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg)
        cache["xk"][i] = L._mm("btd,dhk->bthk", memory, lp["xattn"]["wk"])
        cache["xv"][i] = L._mm("btd,dhk->bthk", memory, lp["xattn"]["wv"])
    hidden = L.rmsnorm(x[:, -1:], params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


@torch.no_grad()
def _encdec_decode(params, cache, tokens, position, cfg: ModelConfig, device):
    x = _embed_tokens(params, tokens, device)
    position = torch.as_tensor(position, device=device)
    B, KV = x.shape[0], cfg.n_kv_heads
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "dec_layers")
        o, _, _ = L.decode_attention(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                     cache["k"][i], cache["v"][i], position)
        x = x + o
        # cross-attention over the (static) encoder memory: plain and
        # grouped, its softmax in f32 cast back to the cached values' dtype
        xq = L._mm("bsd,dhk->bshk", L.rmsnorm(x, lp["ln_x"]),
                   lp["xattn"]["wq"])
        qg = xq[:, 0].reshape(B, KV, cfg.n_heads // KV, -1)
        xo = L.grouped_attention(qg, cache["xk"][i], cache["xv"][i])
        xo = xo.reshape(B, 1, cfg.n_heads, -1)
        x = x + L._mm("bohk,hkd->bod", xo, lp["xattn"]["wo"])
        x = x + L.mlp(lp["ffn"], L.rmsnorm(x, lp["ln2"]), cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

_FAMILY_FNS = {
    # family: (specs, loss, prefill, decode, cache shapes)
    "dense": (_decoder_specs, _decoder_loss, _decoder_prefill,
              _decoder_decode, _decoder_cache_shapes),
    "ssm": (_ssm_specs, _ssm_loss, _ssm_prefill, _ssm_decode,
            _ssm_cache_shapes),
    "hybrid": (_hybrid_specs, _hybrid_loss, _hybrid_prefill, _hybrid_decode,
               _hybrid_cache_shapes),
    "encdec": (_encdec_specs, _encdec_loss, _encdec_prefill, _encdec_decode,
               _encdec_cache_shapes),
}
_FAMILY_FNS["moe"] = _FAMILY_FNS["vlm"] = _FAMILY_FNS["dense"]


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The ``Model`` of a config of any of the six families on ``device``
    (None: the GPU, raising without one; ``"cpu"`` for tests): its loss,
    prefill and decode take tokens, labels (and a prefix) as tensors or
    arrays, and the prefill allocates the cache there."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    specs, loss, prefill, decode, cache_shapes = _FAMILY_FNS[fam]
    dev = resolve_device(device)
    return Model(
        cfg, specs(cfg),
        loss_fn=lambda p, b: loss(p, b, cfg, dev),
        prefill_fn=lambda p, b, max_seq: prefill(p, b, cfg, max_seq, dev),
        decode_fn=lambda p, c, t, pos: decode(p, c, t, pos, cfg, dev),
        init_cache=lambda batch, max_seq: cache_shapes(cfg, batch, max_seq),
    )
