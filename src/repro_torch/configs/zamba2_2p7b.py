"""Zamba2 2.7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54 Mamba2 layers, d_model=2560, ssm_state=64; one SHARED attention+MLP
block (32H, kv=32, d_ff=10240) applied every 6 SSM layers — Zamba2's
parameter-sharing trick.  vocab 32000.  Sub-quadratic: runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab=32_000,
    ssm_state=64,
    attn_every=6,
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=32,
        attn_every=2,
        ssm_chunk=16,
        logits_chunk=32,
        attn_chunk=32,
        supports_long_context=True,
    )
