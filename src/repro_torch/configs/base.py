"""Model configuration schema + registry for the 10 assigned architectures.

A copy of the JAX package's ``configs/base.py`` (plain data), so that the
port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    activation: str = "swiglu"   # swiglu | geglu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_seq_chunk: int = 256   # dispatch chunk along S: bounds the [E,C,d]
                               # buffers to O(B*chunk) tokens instead of B*S

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4

    # hybrid (Zamba2-style): one shared attention block applied every
    # `attn_every` SSM layers
    attn_every: int = 0

    # encoder-decoder (Whisper-style)
    n_enc_layers: int = 0

    # modality frontend stub: none | patch (VLM) | frames (audio)
    frontend: str = "none"
    n_prefix: int = 576          # patches / frames prepended (stub output)

    # training-time knobs
    remat: bool = True
    scan_layers: bool = True
    logits_chunk: int = 512      # sequence chunking for the CE loss
    attn_chunk: int = 512        # query-block size for chunked attention
    ssm_chunk: int = 256         # SSD chunk length
    optimizer_state_dtype: str = "float32"  # bf16 for the 1T config

    # which long-context shapes this arch supports (sub-quadratic only)
    supports_long_context: bool = False

    # ---- the JAX package's sharding and layout knobs, kept so that one
    # ModelConfig reads the same in both packages; the port runs on one
    # card and reads only pad_vocab_to and moe_dispatch here (with
    # capacity_factor and moe_seq_chunk above: the MoE dispatch) ----
    moe_sharding: str = "fsdp"
    moe_dispatch: str = "scatter"
    serve_resident: bool = False
    # pad the vocab to a multiple (0 = off); padded rows are masked out of
    # the logits (whisper: 51865 -> 51872)
    pad_vocab_to: int = 0
    no_fsdp: bool = False

    @property
    def padded_vocab(self) -> int:
        if self.pad_vocab_to <= 0:
            return self.vocab
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family in ("dense", "vlm"):
            mlp = 3 * d * self.d_ff
            return emb + self.n_layers * (attn + mlp + 2 * d)
        if self.family == "moe":
            mlp = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
            return emb + self.n_layers * (attn + mlp + 2 * d)
        if self.family == "ssm":
            ssm = self._ssm_block_params()
            return emb + self.n_layers * (ssm + d)
        if self.family == "hybrid":
            ssm = self._ssm_block_params()
            shared_attn = attn + 3 * d * self.d_ff + 2 * d
            return emb + self.n_layers * (ssm + d) + shared_attn
        if self.family == "encdec":
            mlp = 3 * d * self.d_ff
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            return emb + enc + dec
        raise ValueError(self.family)

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)
        conv = (di + 2 * n) * self.conv_kernel
        return in_proj + conv + 2 * h + di + di * d

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp = 3 * d * self.d_ff * self.experts_per_tok + d * self.n_experts
        emb = self.vocab * d * 2
        return emb + self.n_layers * (attn + mlp + 2 * d)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_REGISTRY = (
    "kimi_k2_1t_a32b",
    "qwen3_moe_30b_a3b",
    "zamba2_2p7b",
    "qwen1p5_4b",
    "glm4_9b",
    "llama3p2_3b",
    "gemma_7b",
    "llava_next_34b",
    "whisper_small",
    "mamba2_1p3b",
)

# CLI ids (--arch <id>) -> module names
ARCH_IDS = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen1.5-4b": "qwen1p5_4b",
    "glm4-9b": "glm4_9b",
    "llama3.2-3b": "llama3p2_3b",
    "gemma-7b": "gemma_7b",
    "llava-next-34b": "llava_next_34b",
    "whisper-small": "whisper_small",
    "mamba2-1.3b": "mamba2_1p3b",
}


def _module(name: str):
    mod_name = ARCH_IDS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCH_IDS)


def shape_supported(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if supported, else a human-readable skip reason."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention")
    return None
