"""Abstract input specs + sharding assignments for every (arch x shape).

The counterpart of the JAX package's ``launch/specs.py``, with the same
names and the same PartitionSpecs: each step function's inputs as
tensors on the ``meta`` device (shape and dtype, no storage: what
``jax.ShapeDtypeStruct`` is there) and the matching ``NamedSharding``s.

Sharding policy:
  tokens/labels  [B, S]         -> (('pod','data'), None); B=1 replicates
  prefix embeds  [B, T, d]      -> (dp, None, None)
  KV caches      [L, B, S, KV, D]: heads over `model` when divisible,
                 otherwise the SEQUENCE dim over `model` (context
                 parallelism) — decided per arch (e.g. GLM-4 kv=2, Kimi
                 kv=8 -> sequence-sharded caches).
  params/opt     from ParamSpec logical axes (FSDP over ('pod','data')
                 via the 'embed' rule + TP over 'model').
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import InputShape, ModelConfig
from ..models.model import Model
from ..models.sharding import NamedSharding, P, mesh_shape, resolve_axis


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def arch_rules(cfg: ModelConfig, mesh, kind: str = "train") -> Dict[str, Any]:
    """Per-arch rule overrides.

    * context-parallel KV caches when the KV heads can't TP-shard;
    * decode with TP-resident weights — the per-step FSDP all-gather of
      every parameter is the decode bottleneck, so the 'embed' (FSDP) dim
      replicates and weights live sharded over `model`.
    """
    tp = mesh_shape(mesh).get("model", 1)
    rules: Dict[str, Any] = {}
    if cfg.n_kv_heads and tp > 1 and cfg.n_kv_heads % tp != 0:
        rules["kv_seq"] = "model"
    if cfg.no_fsdp or (kind == "decode" and cfg.serve_resident):
        rules["embed"] = None
    return rules


def batch_pspec(mesh, global_batch: int) -> Any:
    return resolve_axis(global_batch, ("pod", "data"), mesh)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    B, S = shape.global_batch, shape.seq_len
    dp = batch_pspec(mesh, B)
    n_tok = S - (cfg.n_prefix if cfg.family == "vlm" else 0)
    batch = {
        "tokens": _abstract((B, n_tok), torch.int32),
        "labels": _abstract((B, n_tok), torch.int32),
    }
    pspecs = {
        "tokens": NamedSharding(mesh, P(dp, None)),
        "labels": NamedSharding(mesh, P(dp, None)),
    }
    if cfg.frontend != "none":
        batch["prefix"] = _abstract((B, cfg.n_prefix, cfg.d_model),
                                    torch.float32)
        pspecs["prefix"] = NamedSharding(mesh, P(dp, None, None))
    return batch, pspecs


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    return train_batch_specs(cfg, shape, mesh)


def cache_shardings(cfg: ModelConfig, cache_shapes, mesh):
    """NamedShardings for the decode cache tree, per family
    (``cache_shapes``: name -> anything with a ``shape``)."""
    tp = mesh_shape(mesh).get("model", 1)
    kv_on_heads = cfg.n_kv_heads and tp > 1 and cfg.n_kv_heads % tp == 0

    def kv_spec(ndim_prefix: int, batch: int, seq: int, kv: int):
        dp = batch_pspec(mesh, batch)
        if kv_on_heads:
            return P(*([None] * ndim_prefix), dp, None,
                     resolve_axis(kv, "model", mesh), None)
        # context parallelism — but only if the cache length divides
        # (e.g. whisper's 1500-frame cross-attention K/V replicates)
        return P(*([None] * ndim_prefix), dp,
                 resolve_axis(seq, "model", mesh), None, None)

    def leaf_spec(path: str, s):
        nd = len(s.shape)
        if path in ("k", "v", "xk", "xv"):
            batch, seq, kv = s.shape[nd - 4], s.shape[nd - 3], s.shape[nd - 2]
            return kv_spec(nd - 4, batch, seq, kv)
        if path == "s":       # SSM state [..., B, H, P, N]
            dp = batch_pspec(mesh, s.shape[nd - 4])
            h_ax = resolve_axis(s.shape[nd - 3], "model", mesh)
            return P(*([None] * (nd - 4)), dp, h_ax, None, None)
        if path == "conv":    # [..., B, K-1, C]
            dp = batch_pspec(mesh, s.shape[nd - 3])
            return P(*([None] * (nd - 3)), dp, None, None)
        return P()

    return {k: NamedSharding(mesh, leaf_spec(k, v))
            for k, v in cache_shapes.items()}


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh, model: Model):
    """(cache, tokens, position) abstract values + shardings for decode."""
    B, S = shape.global_batch, shape.seq_len
    dp = batch_pspec(mesh, B)
    cache_shapes = {k: _abstract(s.shape, s.dtype)
                    for k, s in model.init_cache(B, S).items()}
    cache_sh = cache_shardings(cfg, cache_shapes, mesh)
    tokens = _abstract((B, 1), torch.int32)
    position = _abstract((B,), torch.int32)
    return (
        (cache_shapes, tokens, position),
        (cache_sh, NamedSharding(mesh, P(dp, None)),
         NamedSharding(mesh, P(dp))),
    )
