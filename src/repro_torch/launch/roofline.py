"""Roofline-term derivation for the dry-run cells, with H100 terms.

The counterpart of the JAX package's ``launch/roofline.py``.  Three terms
per (arch x shape x mesh), in seconds — the dominant one is the
bottleneck:

  compute    = analytic_flops / (chips * PEAK_FLOPS)
  memory     = analytic_hbm_bytes / (chips * HBM_BW)
  collective = sum over mesh axes of that axis's per-device collective
               bytes / the bandwidth of the link class its ranks span

``analytic_flops``, ``analytic_hbm_bytes``, ``model_flops_for`` and their
helpers are the JAX package's, unchanged: they count a config's matmuls,
attention and memory traffic and know nothing of the hardware.

Collective bytes: the port has no HLO to parse.  The dry-run runs the
cell's step once on DTensors and counts every c10d functional collective
it issues (``dryrun.CollectiveCounter``): the bytes of each by kind and by
mesh axis, per device.  ``collective_bytes`` takes that counted
``{axis: {kind: bytes}}`` mapping where the JAX one takes HLO text.  The
step runs eagerly, layer after layer, so every layer's collectives are
counted where they happen: no loop trip count to multiply by.

Hardware model: one NVIDIA H100 SXM a rank (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): 989
TFLOP/s bf16, 3.35 TB/s HBM, and NVLink at 450 GB/s each way to every
other card of its 8-card host.  Between hosts a card has one 400 Gb/s NDR
InfiniBand port (the DGX H100 / HGX H100 reference design: eight ConnectX-7
400 Gb/s ports a node, one a GPU): 50 GB/s each way.  An axis whose ranks
all lie in one host (the mesh's ranks fill hosts of ``CARDS_PER_HOST`` in
rank order) is priced at NVLink's rate, any other at the inter-host one.
These are published peaks, so the terms are lower bounds, derived and not
measured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s each way, card to card inside a host
# one 400 Gb/s NDR InfiniBand port a card (DGX H100: 8 ConnectX-7 a node)
INTER_HOST_BW = 400e9 / 8    # bytes/s each way
CARDS_PER_HOST = 8


def collective_bytes(counted: Mapping[str, Mapping[str, float]]
                     ) -> Dict[str, float]:
    """Per-collective-kind bytes a device, summed over the mesh axes of a
    counted ``{axis: {kind: bytes}}`` mapping (the dry-run's count of the
    step's c10d functional collectives)."""
    out: Dict[str, float] = {}
    for kinds in counted.values():
        for kind, b in kinds.items():
            out[kind] = out.get(kind, 0.0) + float(b)
    return out


def link_of(ranks) -> str:
    """``"nvlink"`` when a group's ranks all lie in one host of
    ``CARDS_PER_HOST`` cards (hosts filled in rank order), else
    ``"inter_host"``."""
    return "nvlink" if len({int(r) // CARDS_PER_HOST for r in ranks}) == 1 \
        else "inter_host"


LINK_BW = {"nvlink": NVLINK_BW, "inter_host": INTER_HOST_BW}


# ---------------------------------------------------------------------------
# Analytic FLOPs / HBM models (the JAX package's, hardware-free)
# ---------------------------------------------------------------------------

def _attention_layers(cfg) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every     # shared block applications
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers  # self + cross
    return 0


def _matmul_params(cfg) -> int:
    """Active parameters that participate in matmuls (embedding gather
    excluded; unembedding projection included)."""
    n = cfg.active_param_count()
    emb_factor = 1 if cfg.tie_embeddings else 2
    n -= cfg.vocab * cfg.d_model * emb_factor     # remove both tables
    n += cfg.vocab * cfg.d_model                  # unembed matmul is real
    return n


def _ssd_extra_flops_per_token(cfg) -> float:
    """SSD state-path flops/token beyond the projections (per layer):
    intra-chunk dual form ~ 2*q*(n + p) per token-pair column + state
    update/output ~ 6*p*n per head."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    h, p, n, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    intra = 2.0 * q * (n + p) * h / 2.0           # causal half
    inter = 6.0 * p * n * h
    return (intra + inter) * cfg.n_layers


def analytic_flops(cfg, shape) -> float:
    """Global FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = B if decode else B * S
    kv_len = S if decode else S / 2               # causal average

    base = 2.0 * _matmul_params(cfg) * tokens
    hd = cfg.resolved_head_dim
    attn = 4.0 * kv_len * cfg.n_heads * hd * _attention_layers(cfg) * tokens
    ssd = _ssd_extra_flops_per_token(cfg) * tokens
    fwd = base + attn + ssd
    if shape.kind == "train":
        # 1 fwd + 2 bwd (+1 remat recompute of the fwd)
        return fwd * (4.0 if cfg.remat else 3.0)
    return fwd


def analytic_hbm_bytes(cfg, shape, chips: int) -> float:
    """Global HBM traffic model for one step.

    train:   weights bf16 read fwd+bwd (2x) + grad write/read (f32) +
             optimizer m,v read+write (state dtype) + activation traffic
             ~ 12 bf16 touches per token per layer-equivalent.
    prefill: weights read + activations + KV-cache write.
    decode:  weights read + KV/state cache read (+tiny writes) — the
             classic decode bound.
    Per-device weight traffic never drops below the full shard (weights
    are read wherever they live); activation traffic scales with tokens.
    """
    B, S = shape.global_batch, shape.seq_len
    p_bytes = cfg.param_count() * 2.0
    opt_bytes = cfg.param_count() * (4.0 if cfg.optimizer_state_dtype ==
                                     "float32" else 2.0) * 2.0
    layers_eq = max(cfg.n_layers, 1)
    act_per_tok_layer = 12.0 * cfg.d_model * 2.0
    kv_heads = max(cfg.n_kv_heads, 0)
    hd = cfg.resolved_head_dim

    if shape.kind == "train":
        tokens = B * S
        acts = tokens * layers_eq * act_per_tok_layer * (1.5 if cfg.remat else 1.0)
        grads = cfg.param_count() * 4.0 * 2.0
        return 2.0 * p_bytes + grads + 2.0 * opt_bytes + acts
    if shape.kind == "prefill":
        tokens = B * S
        acts = tokens * layers_eq * act_per_tok_layer / 2.0
        kv = tokens * _attention_layers(cfg) * kv_heads * hd * 2 * 2.0
        return p_bytes + acts + kv
    # decode: read all weights + the whole KV/state cache once per step
    kv = B * S * _attention_layers(cfg) * kv_heads * hd * 2 * 2.0
    if cfg.family in ("ssm", "hybrid"):
        kv += B * cfg.n_layers * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
        if cfg.family == "ssm":
            kv = B * cfg.n_layers * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
    acts = B * layers_eq * act_per_tok_layer
    return p_bytes + kv + acts


@dataclasses.dataclass
class Roofline:
    flops: float                 # global analytic flops
    hbm_bytes: float             # global analytic bytes
    coll_bytes: float            # per-device counted collective bytes
    coll_breakdown: Dict[str, float]               # by kind
    coll_by_axis: Dict[str, Dict[str, float]]      # axis -> kind -> bytes
    axis_links: Dict[str, str]                     # axis -> link class
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6*N_active*D (train) — the MFU numerator
    useful_ratio: float          # model_flops / analytic flops
    chips: int
    hardware: str = "NVIDIA H100 SXM (published peaks, 700 W)"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_for(cfg, shape) -> float:
    """MFU numerator: 6*N_active*tokens (train) or 2*N_active*tokens."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * tokens


def derive(cfg, shape, counted: Mapping[str, Mapping[str, float]],
           chips: int, links: Optional[Mapping[str, str]] = None
           ) -> Roofline:
    """The three terms of a cell from its counted collectives
    (``{axis: {kind: bytes}}`` a device) and each axis's link class
    (``link_of``; an axis missing from ``links`` is priced inter-host)."""
    links = dict(links or {})
    coll = collective_bytes(counted)
    coll_total = sum(coll.values())
    collective_s = sum(
        sum(kinds.values()) / LINK_BW[links.get(axis, "inter_host")]
        for axis, kinds in counted.items())

    flops = analytic_flops(cfg, shape)
    hbm = analytic_hbm_bytes(cfg, shape, chips)
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = hbm / (chips * HBM_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_for(cfg, shape)
    return Roofline(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll_total,
        coll_breakdown=coll,
        coll_by_axis={a: dict(k) for a, k in counted.items()},
        axis_links=links, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=bottleneck,
        model_flops=mf, useful_ratio=mf / flops if flops else 0.0,
        chips=chips,
    )
