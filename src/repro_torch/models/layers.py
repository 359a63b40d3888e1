"""Transformer building blocks: norms, RoPE, GQA attention, gated MLPs.

Pure functions over parameter dicts (``ParamSpec``-declared), the
counterparts of the JAX package's ``models/layers.py`` with the same names,
layouts (``[B, S, H, D]`` activations, ``[d, H, D]`` projections) and
dtype rules: where the JAX code mixes bf16 and f32 operands the result is
f32 (``_mm`` promotes as ``jnp`` does), and ``rmsnorm`` and ``rope``
compute in f32 and cast back to the input's dtype.

Attention in the prefill is the hand-written flash kernel
(``kernels.ops.flash_attention``) on a CUDA tensor and its plain version on
a CPU tensor; decode attention over the cache stays plain PyTorch, as the
JAX package has no kernel there.  Large products are ``torch.matmul`` /
``einsum``.  The port runs on one card, so nothing here constrains an
activation's sharding.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .sharding import ParamSpec

NEG_INF = -1e30


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp``'s type promotion: a bf16 operand meets
    an f32 one in f32 (torch's einsum takes one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq      # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
    return specs


def qkv_project(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                use_rope: bool = True):
    q = _mm("bsd,dhk->bshk", x, p["wq"])
    k = _mm("bsd,dhk->bshk", x, p["wk"])
    v = _mm("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat each KV head for its group of query heads (``jnp.repeat``
    on the head axis: head h reads KV head h // rep, the order ``wo``
    expects)."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def chunked_attention(
    q: torch.Tensor,         # [B, Sq, H, D]
    k: torch.Tensor,         # [B, Sk, H, D] (already GQA-expanded)
    v: torch.Tensor,
    causal: bool,
    chunk: int,
) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]``: moves to ``[B*H, S, D]`` and
    calls ``kernels.ops.flash_attention`` (the CUDA kernel on the card, its
    plain version on the CPU), then back.

    ``chunk`` is the JAX version's query-block size; the kernel's tiles are
    fixed, so it is accepted for the signature and not read.  The JAX
    version's ``q_offset`` and ``kv_valid`` have no caller in that package
    and are left out.
    """
    del chunk
    B, Sq, H, D = q.shape
    Sk = k.shape[1]

    def heads_major(t, S):
        return t.transpose(1, 2).contiguous().view(B * H, S, D)

    o = ops.flash_attention(heads_major(q, Sq), heads_major(k, Sk),
                            heads_major(v, Sk), causal=causal)
    return o.view(B, H, Sq, D).transpose(1, 2)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    causal: bool = True,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full attention block (projection + flash attention + output)."""
    q, k, v = qkv_project(p, x, cfg, positions, use_rope)
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    o = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return _mm("bshk,hkd->bsd", o, p["wo"])


def decode_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                   # [B, 1, d]
    cfg: ModelConfig,
    cache_k: torch.Tensor,             # [B, S, KV, D]
    cache_v: torch.Tensor,
    position: torch.Tensor,            # [B] PER-REQUEST positions
):
    """Single-token decode against a KV cache.

    Writes this step's K/V at each request's own ``position`` IN PLACE
    (an indexed write into ``cache_k`` / ``cache_v``, where the JAX version
    returns updated copies that its caller donates), then attends over
    each request's prefix with grouped einsums that contract against the
    cache without expanding it to the query heads.  Plain PyTorch: the
    JAX package has no kernel here.  Returns (out, cache_k, cache_v).
    """
    q = _mm("bsd,dhk->bshk", x, p["wq"])
    k = _mm("bsd,dhk->bshk", x, p["wk"])
    v = _mm("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, position[:, None], cfg.rope_theta)
    k = rope(k, position[:, None], cfg.rope_theta)
    B = x.shape[0]
    b_idx = torch.arange(B, device=x.device)
    pos = position.long()
    cache_k[b_idx, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[b_idx, pos] = v[:, 0].to(cache_v.dtype)
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    rep = cfg.n_heads // KV
    qg = q[:, 0].reshape(B, KV, rep, Dh)
    S = cache_k.shape[1]
    scale = Dh ** -0.5
    s = _mm("bgrk,bsgk->bgrs", qg, cache_k) * scale
    mask = (torch.arange(S, device=x.device)[None, None, None, :]
            <= pos[:, None, None, None])
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                          device=s.device))
    w = torch.softmax(s.float(), dim=-1).to(cache_v.dtype)
    o = _mm("bgrs,bsgk->bgrk", w, cache_v)
    wo = p["wo"].reshape(KV, rep, Dh, p["wo"].shape[-1])
    out = _mm("bgrk,grkd->bd", o, wo)[:, None, :]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wu": ParamSpec((d, f), ("embed", "mlp")),
        "wd": ParamSpec((f, d), ("mlp", "embed")),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(cfg: ModelConfig):
    """The gate's activation: SiLU for ``swiglu``, tanh GELU for ``geglu``."""
    return F.silu if cfg.activation == "swiglu" else _gelu_tanh


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg)
    h = act(_mm("bsd,df->bsf", x, p["wg"])) * _mm("bsd,df->bsf", x, p["wu"])
    return _mm("bsf,fd->bsd", h, p["wd"])
