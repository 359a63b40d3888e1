"""Mamba2 1.3B — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L d_model=2048, ssm_state=128, vocab=50280.  Sub-quadratic: runs
long_500k (constant-size state cache at decode).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=16,
        logits_chunk=32,
        supports_long_context=True,
    )
