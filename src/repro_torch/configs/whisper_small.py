"""Whisper small — encoder-decoder ASR backbone [arXiv:2212.04356;
unverified].

12 encoder + 12 decoder layers, d_model=768 12H d_ff=3072 vocab=51865.
The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, n_frames, d_model] (post-conv mel features).  decode_*
shapes exercise the DECODER with cached self- and cross-attention.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    frontend="frames",
    n_prefix=1500,           # 30s of audio at 50 frames/s
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        frontend="frames",
        n_prefix=16,
        logits_chunk=32,
        attn_chunk=32,
    )
