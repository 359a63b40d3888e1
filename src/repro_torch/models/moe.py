"""Mixture-of-Experts block: top-k routing with capacity-based dispatch.

The counterpart of the JAX package's ``models/moe.py``, with the same
names and the same semantics, in two parts:

  * ``route`` — the router: f32 logits, softmax, the top k experts of each
    token and their weights renormalised to sum to 1, in ``x``'s dtype;
  * ``dispatch_scatter`` / ``dispatch_grouped`` — the dispatch given
    ``(w, idx)``: the slots (token, choice) are ranked within their
    expert by a STABLE sort and a ``searchsorted``, a slot of rank < C is
    written to row ``e * C + rank`` of an ``[E, C, d]`` expert buffer,
    the expert FFNs run as batched products over it, and the outputs are
    combined back with the routing weights.  A slot of rank >= C is
    dropped: its token's residual stream passes by that expert unchanged.
    C = ceil(T * k * capacity_factor / E) over the T tokens of one
    dispatch (``"scatter"``: the whole batch of a chunk; ``"grouped"``:
    one batch row).

``moe_block`` chunks along S exactly where the JAX package does (S >
``moe_seq_chunk`` and S a multiple of it) and averages the Switch
load-balance loss over the chunks.  Capacity is per dispatch, so a
prompt's tokens dispatched in one chunk, in a batch of four or alone can
keep different slots: that is the JAX package's semantics, kept here.

The router's product runs in full f32: a route is a comparison, and TF32's
10-bit mantissa flips near-ties (a random router's probabilities are close
to uniform), so ``route`` raises on a CUDA tensor while
``torch.backends.cuda.matmul.allow_tf32`` is set.  The expert products are
batched ``einsum``s (``layers._mm``) in the parameters' dtype, as the JAX
package computes them with ``jnp.einsum`` outside any Pallas kernel.
``moe_sharding`` names the expert weights' logical axes (``moe_specs``).

On a mesh of more than one rank the block runs whole on every rank
(``sharding.whole_on_every_rank``: the tokens and the expert weights are
gathered): the dispatch's stable sort, ``searchsorted`` and indexed
writes have no DTensor sharding strategy, and a per-shard dispatch would
rank slots and apply the capacity over one shard's tokens, which is
another function than the JAX package's.  Expert-parallel dispatch is
ROADMAP item 15.6; its output is constrained back to the batch sharding.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import _mm, activation
from .sharding import ParamSpec, constrain, on_mesh, whole_on_every_rank


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The router and the stacked expert weights, their logical axes by
    ``cfg.moe_sharding`` as in the JAX package: ``"resident"`` shards the
    experts over the DP axes and d_ff over ``model``; ``"expert_only"``
    the experts over ``model`` alone; the default the experts over
    ``model`` with the FSDP (``embed``) dim."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.moe_sharding == "resident":
        e_ax, d_ax, f_ax = "experts_resident", None, "moe_ff"
    elif cfg.moe_sharding == "expert_only":
        e_ax, d_ax, f_ax = "experts", None, None
    else:
        e_ax, d_ax, f_ax = "experts", "embed", None
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), scale=0.01),
        "wg": ParamSpec((E, d, f), (e_ax, d_ax, f_ax)),
        "wu": ParamSpec((E, d, f), (e_ax, d_ax, f_ax)),
        "wd": ParamSpec((E, f, d), (e_ax, f_ax, d_ax)),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert keeps in one dispatch of ``tokens`` tokens."""
    return max(int(math.ceil(tokens * cfg.experts_per_tok
                             * cfg.capacity_factor / cfg.n_experts)), 1)


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs f32 [..., E], w [..., k] in x's dtype, idx [..., k] int64) for
    tokens ``x`` [..., d]: the softmax of the f32 router logits, its top k
    (descending) and their weights renormalised to sum to 1."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the MoE router's f32 product must not run in TF32 (near-tie "
            "routes flip): unset torch.backends.cuda.matmul.allow_tf32")
    logits = torch.matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    w = (w / w.sum(-1, keepdim=True)).to(x.dtype)
    return probs, w, idx


def slot_ranks(flat_e: torch.Tensor):
    """(order, sorted_e, rank) of the slots' experts ``flat_e`` [..., n]
    along the last axis: the stable sort (a slot's rank among its expert's
    slots follows slot order, as ``jnp.argsort``'s) and each sorted slot's
    rank within its expert."""
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    first = torch.searchsorted(sorted_e.contiguous(), sorted_e.contiguous(),
                               side="left")
    n = flat_e.shape[-1]
    rank = torch.arange(n, device=flat_e.device) - first
    return order, sorted_e, rank


def kept_slots(idx: torch.Tensor, C: int) -> torch.Tensor:
    """bool [T, k]: which slots of a dispatch of ``idx`` [T, k] keep their
    expert at capacity ``C`` (the rest are dropped)."""
    order, _, rank = slot_ranks(idx.reshape(-1))
    keep = torch.empty_like(rank, dtype=torch.bool)
    keep[order] = rank < C
    return keep.view(idx.shape)


def _experts(p: Dict[str, torch.Tensor], xe: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """The expert FFNs over ``xe`` [E, n, d]: [E, n, d]."""
    act = activation(cfg)
    h = act(_mm("ecd,edf->ecf", xe, p["wg"])) * _mm("ecd,edf->ecf", xe,
                                                    p["wu"])
    return _mm("ecf,efd->ecd", h, p["wd"])


def _aux(probs: torch.Tensor, flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e mean_prob_e * frac_e."""
    me = probs.reshape(-1, E).mean(dim=0)
    ce = torch.bincount(flat_e.reshape(-1), minlength=E).float() / flat_e.numel()
    return E * torch.sum(me * ce)


def dispatch_scatter(p: Dict[str, torch.Tensor], xt: torch.Tensor,
                     w: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    """The ``"scatter"`` dispatch of tokens ``xt`` [T, d] routed to
    ``idx`` [T, k] with weights ``w``: y [T, d]."""
    T, d = xt.shape
    k, E = cfg.experts_per_tok, cfg.n_experts
    C = capacity(T, cfg)
    order, sorted_e, rank = slot_ranks(idx.reshape(-1))
    keep = rank < C
    dest = (sorted_e * C + rank)[keep]
    src = order[keep]
    buf = xt.new_zeros((E * C, d))
    buf[dest] = xt[src // k]
    ye = _experts(p, buf.view(E, C, d), cfg).reshape(E * C, d)
    y_slots = ye.new_zeros((T * k, d))
    y_slots[src] = ye[dest]
    return (y_slots.view(T, k, d) * w[..., None]).sum(dim=1)


def dispatch_grouped(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     w: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    """The ``"grouped"`` dispatch: each batch row of ``x`` [B, S, d]
    (routed to ``idx`` [B, S, k]) ranks and fills its own [E, C_b, d]
    buffer, C_b = capacity(S); y [B, S, d]."""
    B, S, d = x.shape
    k, E = cfg.experts_per_tok, cfg.n_experts
    C = capacity(S, cfg)
    order, sorted_e, rank = slot_ranks(idx.reshape(B, S * k))
    keep = rank < C
    row = torch.arange(B, device=x.device)[:, None].expand(B, S * k)[keep]
    dest = (sorted_e * C + rank)[keep]
    src = order[keep]
    buf = x.new_zeros((B, E * C, d))
    buf[row, dest] = x[row, src // k]
    xe = buf.view(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    ye = _experts(p, xe, cfg).view(E, B, C, d).transpose(0, 1)
    ye = ye.reshape(B, E * C, d)
    y_slots = ye.new_zeros((B, S * k, d))
    y_slots[row, src] = ye[row, dest]
    return (y_slots.view(B, S, k, d) * w[..., None]).sum(dim=2)


def _moe_dispatch(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E = cfg.n_experts
    if cfg.moe_dispatch == "grouped":
        probs, w, idx = route(p, x, cfg)
        return dispatch_grouped(p, x, w, idx, cfg), _aux(probs, idx, E)
    xt = x.reshape(B * S, d)
    probs, w, idx = route(p, xt, cfg)
    y = dispatch_scatter(p, xt, w, idx, cfg)
    return y.view(B, S, d), _aux(probs, idx, E)


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output [B, S, d], the aux load-balancing loss, an f32 scalar).

    Long sequences are dispatched in chunks along S: each chunk of
    ``moe_seq_chunk`` positions of every row is one dispatch, and the aux
    loss is the chunks' mean.
    """
    if on_mesh():
        y, aux = whole_on_every_rank(_moe_block, n_out=2)(p, x, cfg)
        return constrain(y, "batch", "seq", "embed"), aux
    return _moe_block(p, x, cfg)


def _moe_block(p, x: torch.Tensor, cfg: ModelConfig):
    B, S, d = x.shape
    c = cfg.moe_seq_chunk
    if S > c and S % c == 0:
        nc = S // c
        ys, aux = [], 0.0
        for i in range(nc):
            y, a = _moe_dispatch(p, x[:, i * c:(i + 1) * c], cfg)
            ys.append(y)
            aux = aux + a
        return torch.cat(ys, dim=1), aux / nc
    return _moe_dispatch(p, x, cfg)


def router_boundary_stats(logits: torch.Tensor, k: int, block: int = 256
                          ) -> torch.Tensor:
    """Diagnostic: fraction of router-logit blocks skippable by the paper's
    top-k boundary rule (block max <= running k-th); not on the serving
    path."""
    T, E = logits.shape
    nb = T // block
    bmax = logits[: nb * block].reshape(nb, block, E).amax(dim=1)
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    kth_blocks = kth[: nb * block].reshape(nb, block).amax(dim=1)
    return (bmax <= kth_blocks[:, None]).float().mean()
