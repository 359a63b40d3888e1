"""Gemma 7B — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab=256_000,
    activation="geglu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab=256,
        activation="geglu",
        tie_embeddings=True,
        logits_chunk=32,
        attn_chunk=32,
    )
