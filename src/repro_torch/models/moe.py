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

On a mesh of more than one rank the block is expert-parallel
(``_mesh_dispatch``): the expert weights stay in the shards ``moe_specs``
gives them (``"fsdp"`` and ``"expert_only"``: the experts over
``model``; ``"resident"``: the experts over the batch axes, their d_ff
over ``model``) and never move; tokens, slot rows and partial outputs
move instead.  It computes the one-card function of the global batch:

  * the router [d, E] is gathered whole (a sum of zero-padded shards: its
    ``"experts"`` dim), each rank routes its own tokens with ``route``;
  * ``"scatter"`` gathers the int routes over the batch axes (a sum of
    zero-padded blocks, as the router's: ``_gather_rows``), so every
    rank ranks the global chunk's slots (``slot_ranks``) and knows every
    slot's keep flag and buffer row; ``"grouped"`` ranks each batch row
    on its own rank, with nothing gathered;
  * experts on mesh dims that do not shard the tokens (``"experts"`` over
    ``model``): the tokens are already there; a rank runs its own tokens'
    kept slots through its own experts, in buffer rows at the positions
    the one-card buffer gives them (other rows zero), and the slot outputs
    are summed over those dims.  The sum is exact: a slot is non-zero on
    one rank only;
  * experts on mesh dims that shard the tokens (``"resident"``): an
    all-to-all over those dims carries each kept slot's row to its
    expert's rank and the output back: ``"grouped"`` with equal, static
    splits of the fixed [B_loc, E, C_b, d] buffer by expert owner,
    ``"scatter"`` with variable splits from the gathered routes (only the
    kept slots move, not [E_loc, C, d] blocks);
  * d_ff over ``model`` (``"resident"``): each rank's products over its
    d_ff shard are partial sums, added over ``model`` in the parameters'
    dtype.  That sum is not exact (bf16: one rounding of each shard's
    product, then of their sum);
  * the weighting and the sum over the k choices run locally, in the
    one-card order; the aux loss's mean probabilities are summed over the
    batch axes (f32, another order than one card's mean).

Experts that do not divide their mesh axis replicate (``resolve_axis``):
every rank then holds every expert and nothing is summed for them.  Every
collective is a functional one (``_functional_collectives``), the
all-to-all in its autograd form under grad; a sum whose result every rank
uses whole (``_SumOver``) passes each rank's gradient through unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import _mm, activation
from .sharding import (ParamSpec, axis_dims, constrain, current_mesh,
                       dims_group, dims_index, entry_dims, on_mesh,
                       spec_placements, spec_pspec)


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
    loss is the chunks' mean.  On a mesh each chunk is dispatched
    expert-parallel (``_mesh_dispatch``).
    """
    if on_mesh():
        y, aux = _moe_block(p, x, cfg, _mesh_dispatch)
        return constrain(y, "batch", "seq", "embed"), aux
    return _moe_block(p, x, cfg, _moe_dispatch)


def _moe_block(p, x: torch.Tensor, cfg: ModelConfig, dispatch):
    B, S, d = x.shape
    c = cfg.moe_seq_chunk
    if S > c and S % c == 0:
        nc = S // c
        ys, aux = [], 0.0
        for i in range(nc):
            y, a = dispatch(p, x[:, i * c:(i + 1) * c], cfg)
            ys.append(y)
            aux = aux + a
        return torch.cat(ys, dim=1), aux / nc
    return dispatch(p, x, cfg)


# ---------------------------------------------------------------------------
# expert-parallel dispatch on a mesh
# ---------------------------------------------------------------------------

def _waited(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


class _SumOver(torch.autograd.Function):
    """``t`` summed over the ranks of ``groups``, one group after another
    (functional all-reduces).  Every rank gets the same sum and uses it
    whole, so the gradient of its own ``t`` is the sum's gradient: the
    backward passes it through."""

    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed._functional_collectives as funcol
        for g in groups:
            t = _waited(funcol.all_reduce(t.contiguous(), "sum", g))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_over(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` summed over the active mesh's ``dims`` (``_SumOver``); ``t``
    itself for none."""
    if not dims:
        return t
    return _SumOver.apply(t, [dims_group((i,)) for i in dims])


def _all_to_all(t: torch.Tensor, out_splits, in_splits, group):
    """A functional all-to-all of ``t``'s rows over ``group`` (splits None:
    equal), in its autograd form where ``t`` requires grad (the backward
    swaps the splits)."""
    import torch.distributed._functional_collectives as funcol
    t = t.contiguous()
    if torch.is_grad_enabled() and t.requires_grad:
        return _waited(funcol.all_to_all_single_autograd(
            t, out_splits, in_splits, group))
    return _waited(funcol.all_to_all_single(t, out_splits, in_splits,
                                            group))


def _gather_rows(t: torch.Tensor, dims) -> torch.Tensor:
    """The blocks of ``t`` (no gradient) held along the active mesh's
    ``dims``, concatenated along dim 0 in block order (the first dim the
    major): each rank's block written into zeros and summed over ``dims``
    (exact).  A sum, not an all-gather: gloo's functional all-gather of
    CUDA tensors kills its rank (``tools/gloo_cuda_probe.py``), its
    all-reduce does not."""
    if not dims:
        return t
    mesh = current_mesh()
    n = math.prod(mesh.size(i) for i in dims)
    at = dims_index(dims) * t.shape[0]
    full = t.new_zeros((n * t.shape[0], *t.shape[1:]))
    full[at:at + t.shape[0]] = t
    return _sum_over(full, dims)


def _unravel(i: int, sizes) -> list:
    out = []
    for n in reversed(sizes):
        out.append(i % n)
        i //= n
    return out[::-1]


def _ravel(coords, sizes) -> int:
    i = 0
    for c, n in zip(coords, sizes):
        i = i * n + c
    return i


class _MeshLayout:
    """Where the MoE block's pieces live on the active mesh, for a batch of
    ``B`` rows: the mesh dims sharding the tokens' batch (``bd``), the
    experts (``xd``), the expert d_ff (``fd``) and the router's experts
    (``rd``); of the expert dims those that also shard the tokens (``A``:
    slots move by all-to-all) and those that do not (``R``: the tokens are
    there, slot outputs are summed); this rank's expert block and, for
    each expert block, the rank of ``A``'s group that holds it, or -1 for
    a block whose ``R`` coordinates are not this rank's."""

    def __init__(self, cfg: ModelConfig, B: int):
        from torch.distributed.tensor import Partial, Replicate, Shard

        mesh = current_mesh()
        specs = moe_specs(cfg)
        self.bd = axis_dims("batch", B)
        self.xd, dd, self.fd = (entry_dims(e) for e in spec_pspec(specs["wg"]))
        rdd, self.rd = (entry_dims(e) for e in spec_pspec(specs["router"]))
        if dd or rdd:
            raise NotImplementedError(
                "expert-parallel MoE with d_model sharded (the 'embed' "
                "rule): no layout of the JAX package's rules shards it")
        if set(self.fd + self.rd) & set(self.bd):
            raise NotImplementedError(
                "expert-parallel MoE with the expert d_ff or the router's "
                "experts on a batch axis")
        self.A = tuple(i for i in self.xd if i in self.bd)
        self.R = tuple(i for i in self.xd if i not in self.bd)
        size = [mesh.size(i) for i in range(mesh.ndim)]
        self.nA = math.prod(size[i] for i in self.A)
        self.n_blocks = math.prod(size[i] for i in self.xd)
        self.E_l = cfg.n_experts // self.n_blocks
        self.block = dims_index(self.xd)
        coord = mesh.get_coordinate()
        self.batch_blocks = []          # the batch block of each A rank
        for j in range(self.nA):
            at = list(coord)
            for i, c in zip(self.A, _unravel(j, [size[i] for i in self.A])):
                at[i] = c
            self.batch_blocks.append(_ravel([at[i] for i in self.bd],
                                            [size[i] for i in self.bd]))
        self.block_rank = []
        for b in range(self.n_blocks):
            at = dict(zip(self.xd, _unravel(b, [size[i] for i in self.xd])))
            mine = all(at[i] == coord[i] for i in self.R)
            self.block_rank.append(
                _ravel([at[i] for i in self.A], [size[i] for i in self.A])
                if mine else -1)
        self.block_rank.append(-1)      # the trash block: dropped slots
        n = mesh.ndim
        self.x_pl = tuple(Shard(0) if i in self.bd else Replicate()
                          for i in range(n))
        self.rep = tuple(Replicate() for _ in range(n))
        # gradients: a sum over the ranks that share an input but each
        # use a part of it (Partial), else the input's own placement
        summed = set(self.R + self.fd)
        self.x_grad = tuple(Shard(0) if i in self.bd else
                            Partial() if i in summed else Replicate()
                            for i in range(n))
        self.w_pl = {name: spec_placements(specs[name])
                     for name in ("router", "wg", "wu", "wd")}
        self.w_grad = {
            name: tuple(pl if isinstance(pl, Shard) else
                        Partial() if i in self.bd else Replicate()
                        for i, pl in enumerate(self.w_pl[name]))
            for name in self.w_pl}


def _mesh_dispatch(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch of ``x`` [B, S, d] (a DTensor) on the active mesh:
    ``mesh_routes`` then ``mesh_experts``."""
    lay = _MeshLayout(cfg, x.shape[0])
    x = constrain(x, "batch", "seq", "embed")
    w, dest, aux = mesh_routes(p, x, cfg, lay)
    return mesh_experts(p, x, w, dest, cfg, lay), aux


def mesh_routes(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, lay: _MeshLayout = None):
    """(w [B, S, k], dest, aux) of one dispatch of ``x`` [B, S, d] on the
    active mesh, through ``local_map``: each rank routes its own tokens
    with the whole router.  ``dest`` holds each slot's row of the
    dispatch's expert buffer, E * C where the slot is dropped (C its
    capacity): ``"scatter"``: [B, S, k] of the global chunk, the same on
    every rank (from the gathered routes); ``"grouped"``: each row's own
    buffer, sharded as the tokens."""
    from torch.distributed.tensor.experimental import local_map

    lay = lay or _MeshLayout(cfg, x.shape[0])
    E, k = cfg.n_experts, cfg.experts_per_tok
    B, S, d = x.shape
    scatter = cfg.moe_dispatch != "grouped"

    def local(router, xl):
        b = xl.shape[0]
        if lay.rd:          # the whole router: a sum of zero-padded shards
            at = dims_index(lay.rd) * router.shape[1]
            router = _sum_over(torch.cat([
                router.new_zeros((d, at)), router,
                router.new_zeros((d, E - at - router.shape[1]))], 1), lay.rd)
        if scatter:
            probs, w, idx = route({"router": router}, xl.reshape(b * S, d),
                                  cfg)
            flat = _gather_rows(idx, lay.bd).reshape(-1)
            C = capacity(B * S, cfg)
            order, sorted_e, rank = slot_ranks(flat)
            at = torch.where(rank < C, sorted_e * C + rank, E * C)
            dest = torch.empty_like(at).scatter_(0, order, at).view(B, S, k)
        else:
            probs, w, idx = route({"router": router}, xl, cfg)
            flat = idx.reshape(-1)
            C = capacity(S, cfg)
            order, sorted_e, rank = slot_ranks(idx.reshape(b, S * k))
            at = torch.where(rank < C, sorted_e * C + rank, E * C)
            dest = torch.empty_like(at).scatter_(1, order, at).view(b, S, k)
        counts = torch.zeros(E, dtype=torch.int64, device=flat.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        if not scatter:
            counts = _sum_over(counts, lay.bd)
        me = _sum_over(probs.reshape(-1, E).sum(dim=0), lay.bd) / (B * S)
        aux = E * torch.sum(me * (counts.float() / (B * S * k)))
        return w.view(b, S, k), dest, aux

    dest_pl = lay.rep if scatter else lay.x_pl
    fn = local_map(local, out_placements=(lay.x_pl, dest_pl, lay.rep),
                   in_placements=(lay.w_pl["router"], lay.x_pl),
                   in_grad_placements=(lay.w_grad["router"], lay.x_pl),
                   device_mesh=current_mesh(), redistribute_inputs=True)
    return fn(p["router"], x)


def mesh_experts(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 w: torch.Tensor, dest: torch.Tensor, cfg: ModelConfig,
                 lay: _MeshLayout = None) -> torch.Tensor:
    """y [B, S, d] of one dispatch of ``x`` on the active mesh given its
    routes (``mesh_routes``'s w and dest), through ``local_map``: each
    rank runs the slots that reach its experts through its shards of
    ``wg``, ``wu``, ``wd``, the slot outputs are summed over the expert
    and d_ff dims that do not shard the tokens, and each rank combines
    its own tokens' k outputs."""
    from torch.distributed.tensor.experimental import local_map

    lay = lay or _MeshLayout(cfg, x.shape[0])
    k = cfg.experts_per_tok
    B, S, d = x.shape
    scatter = cfg.moe_dispatch != "grouped"

    def local(xl, wl, dl, wg, wu, wd):
        pl = {"wg": wg, "wu": wu, "wd": wd}
        b = xl.shape[0]
        if not scatter:
            y_slots = _grouped_slots(pl, xl, dl.reshape(b, S * k),
                                     capacity(S, cfg), cfg, lay)
        elif lay.A:
            y_slots = _exchanged_slots(pl, xl, dl.reshape(-1),
                                       capacity(B * S, cfg), cfg, lay)
        else:
            m = b * S * k
            a = dims_index(lay.bd)
            y_slots = _local_slots(pl, xl, dl.reshape(-1)[a * m:(a + 1) * m],
                                   capacity(B * S, cfg), cfg, lay)
        y_slots = _sum_over(y_slots, lay.R + lay.fd)
        return (y_slots.view(b, S, k, d) * wl[..., None]).sum(dim=2)

    dest_pl = lay.rep if scatter else lay.x_pl
    fn = local_map(
        local, out_placements=(lay.x_pl,),
        in_placements=(lay.x_pl, lay.x_pl, dest_pl, lay.w_pl["wg"],
                       lay.w_pl["wu"], lay.w_pl["wd"]),
        in_grad_placements=(lay.x_grad, lay.x_pl, dest_pl, lay.w_grad["wg"],
                            lay.w_grad["wu"], lay.w_grad["wd"]),
        device_mesh=current_mesh(), redistribute_inputs=True)
    return fn(x, w, dest, p["wg"], p["wu"], p["wd"])


def _local_slots(p, xl, own, C: int, cfg: ModelConfig, lay: _MeshLayout):
    """``"scatter"`` with the experts on dims that do not shard the tokens:
    this rank's own slots (``own`` [T_loc * k]: their buffer rows) that
    reach its expert block, written at their rows of the block ([E_loc,
    C, d], as in the one-card buffer; a trash row takes the rest), through
    its experts: [T_loc * k, d] slot outputs, zero where another rank's
    experts (or none) take the slot.  Static shapes."""
    d = xl.shape[-1]
    k = cfg.experts_per_tok
    n = lay.E_l * C
    pos = own - lay.block * n
    pos = torch.where((pos >= 0) & (pos < n), pos, n)
    tok = torch.arange(own.numel(), device=own.device) // k
    buf = xl.new_zeros((n + 1, d))
    buf[pos] = xl.reshape(-1, d)[tok]
    ye = _experts(p, buf[:n].view(lay.E_l, C, d), cfg).reshape(n, d)
    return torch.cat([ye, ye.new_zeros((1, d))])[pos]


def _exchanged_slots(p, xl, dest, C: int, cfg: ModelConfig,
                     lay: _MeshLayout):
    """``"scatter"`` with the experts on dims that shard the tokens
    (``lay.A``): each kept slot's row goes to the rank of ``A``'s group
    that holds its expert (variable splits, sorted by destination and
    buffer row), the outputs come back in the same order.  A rank knows
    what it receives from ``dest`` [T * k], the global chunk's buffer
    rows.  [T_loc * k, d] slot outputs of this rank's own tokens."""
    b, S, d = xl.shape
    k = cfg.experts_per_tok
    n, m, EC = lay.E_l * C, b * S * k, cfg.n_experts * C
    group = dims_group(lay.A)
    own = dest[dims_index(lay.bd) * m:][:m]
    to = torch.tensor(lay.block_rank, device=dest.device)[
        torch.clamp(own // n, max=lay.n_blocks)]
    sent = torch.argsort(torch.where(to >= 0, to * EC + own,
                                     lay.nA * EC), stable=True)
    send = torch.bincount(to[to >= 0], minlength=lay.nA).tolist()
    sent = sent[:sum(send)]
    base = lay.block * n
    pos, recv = [], []
    for a in lay.batch_blocks:      # each source's slots in this block
        src = dest[a * m:(a + 1) * m]
        got = torch.sort(src[(src >= base) & (src < base + n)]).values
        pos.append(got - base)
        recv.append(int(got.numel()))
    pos = torch.cat(pos)
    rows = _all_to_all(xl.reshape(-1, d)[sent // k], recv, send, group)
    buf = xl.new_zeros((n, d))
    buf[pos] = rows
    ye = _experts(p, buf.view(lay.E_l, C, d), cfg).reshape(n, d)
    back = _all_to_all(ye[pos], send, recv, group)
    y_slots = back.new_zeros((m, d))
    y_slots[sent] = back
    return y_slots


def _grouped_slots(p, xl, dest, C: int, cfg: ModelConfig, lay: _MeshLayout):
    """``"grouped"``: each row's slots (``dest`` [b, S * k]: rows of its
    own [E, C, d] buffer) that reach an expert block this rank's ``R``
    coordinates select, in a fixed [b, nA, E_loc * C, d] buffer (one block
    a rank of ``A``'s group; a trash row for the rest); an all-to-all of
    equal, static splits over ``A`` carries each block to its experts'
    rank and the outputs back.  [b, S * k, d] slot outputs."""
    b, S, d = xl.shape
    k, nA = cfg.experts_per_tok, lay.nA
    n = lay.E_l * C
    blk = torch.clamp(dest // n, max=lay.n_blocks)
    to = torch.tensor(lay.block_rank, device=dest.device)[blk]
    pos = torch.where(to >= 0, to * n + dest - blk * n, nA * n)
    row = torch.arange(b, device=dest.device)[:, None].expand(b, S * k)
    tok = torch.arange(S * k, device=dest.device) // k
    buf = xl.new_zeros((b, nA * n + 1, d))
    buf[row, pos] = xl[:, tok]
    blocks = buf[:, :nA * n].reshape(b, nA, n, d).transpose(0, 1)
    if nA > 1:
        blocks = _all_to_all(blocks.reshape(nA * b * n, d), None, None,
                             dims_group(lay.A))
    xe = blocks.reshape(nA * b, lay.E_l, C, d).transpose(0, 1)
    ye = _experts(p, xe.reshape(lay.E_l, nA * b * C, d), cfg)
    ye = ye.reshape(lay.E_l, nA * b, C, d).transpose(0, 1)
    if nA > 1:
        ye = _all_to_all(ye.reshape(nA * b * n, d), None, None,
                         dims_group(lay.A))
    ye = ye.reshape(nA, b, n, d).transpose(0, 1).reshape(b, nA * n, d)
    ye = torch.cat([ye, ye.new_zeros((b, 1, d))], dim=1)
    return ye[row, pos]


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
