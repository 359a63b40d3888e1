"""Qwen3-MoE 30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) expert d_ff=768, MoE 128e top-8,
vocab 151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151_936,
    n_experts=128,
    experts_per_tok=8,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab=256,
        n_experts=4,
        experts_per_tok=2,
        logits_chunk=32,
        attn_chunk=32,
    )
