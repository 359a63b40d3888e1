"""Qwen1.5 4B — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151_936,
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        logits_chunk=32,
        attn_chunk=32,
    )
