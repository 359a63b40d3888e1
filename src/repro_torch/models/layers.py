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
``einsum``.  Activations are constrained by logical axes at the JAX
package's call sites (``sharding.constrain``: a no-op off a mesh and on a
mesh of one rank); under a larger mesh they are DTensors, and the flash
kernel runs on each rank's local batch and heads (``chunked_attention``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .sharding import ParamSpec, constrain, current_mesh, on_mesh

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
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
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

    Under a mesh of more than one rank q, k and v are DTensors: the kernel
    has no DTensor sharding strategy, and attention is local to a batch
    row and a head, so it runs through ``local_map`` on each rank's shard
    of the batch (over the DP axes) and of the heads (over ``model``),
    each of q, k and v first redistributed to that layout.
    """
    del chunk
    if on_mesh():
        return _local_attention(q, k, v, causal)
    return _flash_bshd(q, k, v, causal)


def _flash_bshd(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk = k.shape[1]

    def heads_major(t, S):
        return t.transpose(1, 2).contiguous().view(B * H, S, D)

    o = ops.flash_attention(heads_major(q, Sq), heads_major(k, Sk),
                            heads_major(v, Sk), causal=causal)
    return o.view(B, H, Sq, D).transpose(1, 2)


def _local_attention(q, k, v, causal: bool):
    """``_flash_bshd`` on each rank's [B / dp, S, H / tp, D] shard of q, k
    and v (DTensors on the active mesh): heads over ``model`` and the
    batch over the DP axes where they divide (``constrain``'s rules),
    the sequence and head dim whole on every rank."""
    from torch.distributed.tensor.experimental import local_map

    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    v = constrain(v, "batch", None, "heads", None)
    placements = q.placements
    fn = local_map(lambda a, b, c: _flash_bshd(a, b, c, causal),
                   out_placements=(placements,),
                   in_placements=(placements, placements, placements),
                   device_mesh=current_mesh(), redistribute_inputs=True)
    return fn(q, k, v)


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
    o = constrain(o, "batch", "seq", "heads", None)
    return constrain(_mm("bshk,hkd->bsd", o, p["wo"]), "batch", "seq",
                     "embed")


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
    pos = position.long()
    S = cache_k.shape[1]
    if on_mesh():
        # an indexed write into a sharded DTensor cache has no sharding
        # strategy: select each request's row by a mask instead (the same
        # values; it reads and writes the whole cache)
        hit = (torch.arange(S, device=x.device)[None, :]
               == pos[:, None])[:, :, None, None]
        for c, t in ((cache_k, k), (cache_v, v)):
            c.copy_(torch.where(hit, t.to(c.dtype), c))
    else:
        b_idx = torch.arange(B, device=x.device)
        cache_k[b_idx, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[b_idx, pos] = v[:, 0].to(cache_v.dtype)
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    rep = cfg.n_heads // KV
    qg = q[:, 0].reshape(B, KV, rep, Dh)
    o = grouped_attention(qg, cache_k, cache_v, pos)
    wo = p["wo"].reshape(KV, rep, Dh, p["wo"].shape[-1])
    out = _mm("bgrk,grkd->bd", o, wo)[:, None, :]
    return constrain(out, "batch", None, "embed"), cache_k, cache_v


def grouped_attention(qg, ck, cv, pos=None):
    """Attention of one query a request over a cache, grouped: qg [B, G,
    R, D] (G KV heads, R query heads each), ck, cv [B, S, G, D]; keys at
    positions above ``pos`` [B] are masked (``pos=None``: none).  f32
    softmax, the weights cast to ``cv``'s dtype.  Returns [B, G, R, D].
    On a mesh, each rank attends over its shard of the DTensor caches
    (``_grouped_attention_on_mesh``)."""
    if on_mesh():
        return _grouped_attention_on_mesh(qg, ck, cv, pos)
    return _grouped_attention(qg, ck, cv, pos)


def _grouped_attention(qg, ck, cv, pos=None):
    s = _mm("bgrk,bsgk->bgrs", qg, ck) * qg.shape[-1] ** -0.5
    if pos is not None:
        at = torch.arange(ck.shape[1], device=qg.device)
        mask = at[None, None, None, :] <= pos[:, None, None, None]
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
    w = torch.softmax(s.float(), dim=-1).to(cv.dtype)
    return _mm("bgrs,bsgk->bgrk", w, cv)


def _grouped_attention_on_mesh(qg, ck, cv, pos=None):
    """``grouped_attention`` on the active mesh, the caches DTensors.

    The einsums would flatten a batch dim sharded over the DP axes with a
    head dim sharded over ``model`` (no DTensor strategy), so each rank
    attends over its own shard through ``local_map``: its batch rows and,
    where the cache shards its KV heads, its heads.  Where a mesh dim
    shards the cache's sequence (context parallelism) the softmax is
    taken over the shards with all-reduces of the max, the normaliser and
    the weighted values on that dim's group."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    cp = ck.placements
    q_pl = tuple(Shard(1) if c == Shard(2) else
                 c if c == Shard(0) else Replicate() for c in cp)
    pos_pl = tuple(c if c == Shard(0) else Replicate() for c in cp)
    seq_dims = [i for i, c in enumerate(cp) if c == Shard(1)]

    def local(qg, ck, cv, pos):
        if not seq_dims:
            return _grouped_attention(qg, ck, cv, pos)
        off = _seq_offset(mesh, cp, ck.shape[1])
        s = _mm("bgrk,bsgk->bgrs", qg, ck).float() * qg.shape[-1] ** -0.5
        if pos is not None:
            at = torch.arange(ck.shape[1], device=qg.device) + off
            mask = at[None, None, None, :] <= pos[:, None, None, None]
            s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                                  device=s.device))
        m = s.amax(dim=-1, keepdim=True)
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(s - m)
        z = e.sum(dim=-1, keepdim=True)
        for i in seq_dims:
            z = funcol.all_reduce(z, "sum", (mesh, i))
        # the weights normalised and cast as the one-rank softmax's are,
        # the shards' partial products summed in f32, rounded once
        w = (e / z).to(cv.dtype)
        o = _mm("bgrs,bsgk->bgrk", w.float(), cv.float())
        for i in seq_dims:
            o = funcol.all_reduce(o, "sum", (mesh, i))
        return o.to(cv.dtype)

    args = (qg, ck, cv, pos)
    in_pl = (q_pl, cp, cp, None if pos is None else pos_pl)
    fn = local_map(local, out_placements=(q_pl,), in_placements=in_pl,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def _seq_offset(mesh, placements, local_len: int) -> int:
    """Where this rank's shard of a dim sharded over the mesh dims marked
    ``Shard(1)`` starts (mesh dims major to minor, DTensor's order)."""
    from torch.distributed.tensor import Shard
    off = 0
    for i, p in enumerate(placements):
        if p == Shard(1):
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    return off * local_len


def write_prompt(cache, t) -> None:
    """``cache[:, :S] = t``: a prompt's K or V [B, S, KV, D] into the
    cache [B, max_seq, KV, D].  On a mesh the cache is a DTensor and each
    rank writes its own shard: DTensor has no strategy for a slice
    assignment into a sharded tensor.  ``t`` is redistributed to the
    cache's placements but whole along the sequence, where a
    context-parallel cache is sharded: a rank then writes the prompt
    positions its sequence shard holds."""
    if not on_mesh():
        cache[:, :t.shape[1]] = t
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = current_mesh()
    cp = tuple(cache.placements)
    src = t.redistribute(mesh, tuple(Replicate() if p == Shard(1) else p
                                     for p in cp)).to_local()
    local = cache.to_local()
    off = _seq_offset(mesh, cp, local.shape[1])
    n = max(0, min(src.shape[1] - off, local.shape[1]))
    local[:, :n] = src[:, off:off + n]


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
    h = constrain(h, "batch", "seq", "mlp")
    return constrain(_mm("bsf,fd->bsd", h, p["wd"]), "batch", "seq", "embed")
