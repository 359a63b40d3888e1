"""GLM-4 9B — dense, RoPE, aggressive GQA [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.  kv=2 cannot
shard over 16-way TP -> KV projections replicate (models/sharding.py).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab=151_552,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        logits_chunk=32,
        attn_chunk=32,
    )
