"""Model assembly: param specs + prefill / decode fns, dense and MoE.

``build_model(cfg, device)`` returns a ``Model`` bundle, as in the JAX
package:
  * ``specs``        — tree of ParamSpec (shapes + logical axes)
  * ``loss_fn``      — training; not ported yet (raises)
  * ``prefill_fn``   — (params, batch, max_seq) -> (logits_last, cache)
  * ``decode_fn``    — (params, cache, tokens, position) -> (logits, cache)
  * ``init_cache``   — cache spec for a (batch, max_seq) shape

Parameters are a dict tree shaped like the JAX package's, with the layers
stacked ``[L, ...]``; the layer loop is a Python loop over L (PyTorch runs
eagerly: no scan, no remat).  The cache is bf16, ``[L, B, max_seq, KV,
D]``; prefill fills it and decode writes each step into it in place.
The ``dense`` and ``moe`` families are ported (a MoE layer's FFN is
``moe.moe_block``, whose aux loss serving drops, as the JAX package's
does); ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` raise
``NotImplementedError`` (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.device_stats import resolve_device
from . import layers as L
from .moe import moe_block, moe_specs
from .sharding import ParamSpec, tree_map

NOT_PORTED = "ROADMAP queue 1, item 15"
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
PORTED = ("dense", "moe")


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


def alloc_cache(shapes: Dict[str, CacheSpec], device) -> Dict[str, torch.Tensor]:
    """Zero tensors for a cache spec (``init_cache``'s result)."""
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
    return params["embed"][tokens.long()]


def _unembed_matrix(params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def _last_logits(params, hidden: torch.Tensor,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """f32 logits [B, V] of the last position; padded vocab rows are
    -1e30."""
    W = _unembed_matrix(params)
    logits = L._mm("bd,vd->bv", hidden[:, -1, :], W).float()
    if cfg is not None and W.shape[0] > cfg.vocab:
        pad = torch.arange(W.shape[0], device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad[None, :], -1e30)
    return logits


# ---------------------------------------------------------------------------
# decoder-only transformer (dense / moe)
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


def layer_params(params, i: int):
    """Layer ``i``'s parameters: a view of every stacked ``[L, ...]`` leaf."""
    return tree_map(lambda p: p[i], params["layers"])


def _decoder_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = CacheSpec((cfg.n_layers, batch, max_seq, KV, Dh), torch.bfloat16)
    return {"k": kv, "v": kv}


@torch.no_grad()
def _decoder_prefill(params, batch, cfg: ModelConfig, max_seq: int, device):
    """Run the prompt through the stack, returning (last_logits, cache)."""
    tokens = torch.as_tensor(batch["tokens"], device=device)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    x = _embed(params, tokens)
    positions = torch.arange(S, device=device)[None, :]
    cache = alloc_cache(_decoder_cache_shapes(cfg, B, max_seq), device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        xn = L.rmsnorm(x, lp["ln1"])
        q, k, v = L.qkv_project(lp["attn"], xn, cfg, positions)
        ke = L._expand_kv(k, cfg.n_heads)
        ve = L._expand_kv(v, cfg.n_heads)
        o = L.chunked_attention(q, ke, ve, causal=True, chunk=cfg.attn_chunk)
        x = x + L._mm("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = x + _ffn(lp, L.rmsnorm(x, lp["ln2"]), cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    # rmsnorm is per position: normalise only the last one
    hidden = L.rmsnorm(x[:, -1:], params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


@torch.no_grad()
def _decoder_decode(params, cache, tokens, position, cfg: ModelConfig, device):
    """One decode step for the whole batch (tokens: [B, 1]); writes the
    step's K/V into ``cache`` in place and returns (logits, cache)."""
    tokens = torch.as_tensor(tokens, device=device)
    position = torch.as_tensor(position, device=device)
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        xn = L.rmsnorm(x, lp["ln1"])
        o, _, _ = L.decode_attention(lp["attn"], xn, cfg, cache["k"][i],
                                     cache["v"][i], position)
        x = x + o
        x = x + _ffn(lp, L.rmsnorm(x, lp["ln2"]), cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _last_logits(params, hidden, cfg), cache


def _loss_not_ported(params, batch):
    raise NotImplementedError(
        f"training (the loss and its backward) is not ported yet: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig, device=None) -> Model:
    """The ``Model`` of a dense or MoE config on ``device`` (None: the GPU,
    raising without one; ``"cpu"`` for tests): its prefill and decode take
    tokens as tensors or arrays and allocate the cache there."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    if fam not in PORTED:
        raise NotImplementedError(
            f"the {fam!r} family is not ported yet: {NOT_PORTED}")
    dev = resolve_device(device)
    return Model(
        cfg, _decoder_specs(cfg),
        loss_fn=_loss_not_ported,
        prefill_fn=lambda p, b, max_seq: _decoder_prefill(p, b, cfg, max_seq,
                                                          dev),
        decode_fn=lambda p, c, t, pos: _decoder_decode(p, c, t, pos, cfg, dev),
        init_cache=lambda batch, max_seq: _decoder_cache_shapes(cfg, batch,
                                                                max_seq),
    )
