"""LLaVA-NeXT 34B — VLM backbone, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only (the assignment's rule): 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000.  The vision frontend is a STUB — input_specs()
provides precomputed patch embeddings [B, n_prefix, d_model] that the
model prepends to the token embeddings (loss masked over the prefix).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab=64_000,
    frontend="patch",
    n_prefix=576,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        frontend="patch",
        n_prefix=8,
        logits_chunk=32,
        attn_chunk=32,
    )
