"""Kimi K2 — trillion-parameter MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048, MoE 384 experts top-8,
vocab 163840.  Optimizer state kept in bf16 (``optimizer_state_dtype``).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163_840,
    n_experts=384,
    experts_per_tok=8,
    optimizer_state_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab=256,
        n_experts=8,
        experts_per_tok=2,
        logits_chunk=32,
        attn_chunk=32,
    )
