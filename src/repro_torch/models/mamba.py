"""Mamba2 (SSD, state-space duality) mixer in the chunked scan formulation.

The counterpart of the JAX package's ``models/mamba.py``, with the same
names and dtype rules.  The SSD block algorithm [arXiv:2405.21060]: within
a chunk the quadratic dual form (attention-like products), across chunks a
linear recurrence over the ``[H, P, N]`` state.  A is a scalar per head;
B and C are shared across heads (one group).  Also the depthwise causal
conv front end and the single-token decode step of serving, whose state
has a constant size.

Plain PyTorch: the JAX package has no Pallas kernel for the scan, the conv
or the decode step (it computes them with ``jnp.einsum``), so the products
here are ``torch.matmul`` / ``einsum`` through ``layers._mm``, which
promotes a bf16 operand meeting an f32 one to f32 as ``jnp`` does.  The
scan's products are in f32, so ``ssd_scan`` raises on a CUDA tensor while
``torch.backends.cuda.matmul.allow_tf32`` is set: TF32's 10-bit mantissa
would put its error (~1e-3) above the 2e-4 that the scan holds against the
step-by-step recurrence.

The causal conv adds its K taps one at a time in the input's dtype (bf16
on the served path), as the JAX code does; ``F.conv1d`` would sum in f32.
Activations are constrained where the JAX code constrains them.  The
decode step's state read-out is a product and a sum: a batched matmul
would flatten a batch and a head dim that a mesh shards at once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L
from .sharding import ParamSpec, constrain


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, K = cfg.ssm_heads, cfg.conv_kernel
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, n), ("embed", "ssm_state")),
        "wC": ParamSpec((d, n), ("embed", "ssm_state")),
        "wdt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((K, di), ("conv", "ssm_inner"), scale=0.1),
        "conv_B": ParamSpec((K, n), ("conv", "ssm_state"), scale=0.1),
        "conv_C": ParamSpec((K, n), ("conv", "ssm_state"), scale=0.1),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),  # A = -exp(.)
        "D": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel K unrolled: y_t = sum_j w_j x_{t-K+1+j}."""
    K = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + pad[:, j:j + S, :] * w[j]
    return out


class SSMState(NamedTuple):
    """Decode-time cache: recurrent state + conv tail (constant size)."""

    s: torch.Tensor       # [B, H, P, N] recurrent state
    conv: torch.Tensor    # [B, K-1, di + 2n] conv input tail


def ssd_scan(
    x: torch.Tensor,      # [B, S, H, P]
    dt: torch.Tensor,     # [B, S, H]  (post-softplus)
    A: torch.Tensor,      # [H]        (negative reals)
    B: torch.Tensor,      # [B, S, N]
    C: torch.Tensor,      # [B, S, N]
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # [B, H, P, N] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: returns (y [B,S,H,P], final state [B,H,P,N]).

    A prompt that is not a multiple of the chunk is padded with zeros,
    ``dt`` included, so padded steps neither decay nor add and the final
    state is the one at the last real step.  The products run heads-major
    (``[b, c, h, i, j]``); the decay is masked to -inf above the diagonal
    before its exp, where ``cum_i - cum_j`` is positive and large (a mask
    after the exp would give inf * 0 = NaN in the backward).  Under
    ``no_grad``, or with no input requiring grad, the intra-chunk block is
    one buffer written in place; when a gradient is taken it is written
    out of place, with the same y bit for bit.
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the SSD scan's f32 products must not run in TF32: unset "
            "torch.backends.cuda.matmul.allow_tf32")
    b, s, h, p_ = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // q
    xh = x.reshape(b, nc, q, h, p_).permute(0, 1, 3, 2, 4)   # [b,c,h,q,p]
    dth = dt.reshape(b, nc, q, h).permute(0, 1, 3, 2)         # [b,c,h,q]
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    cum = torch.cumsum(dth * A[None, None, :, None], dim=-1)  # [b,c,h,q] <= 0

    # intra-chunk (dual quadratic form): y_i += C_i.B_j dt_j decay(i,j) x_j
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    G = cum[..., :, None] - cum[..., None, :]                 # [b,c,h,i,j]
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))           # [b,c,i,j]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, s0)):
        # out of place: autograd keeps the exp's output for its backward
        G = (G.masked_fill(~causal, float("-inf")).exp()
             * scores[:, :, None] * dth[:, :, :, None, :])
    else:
        # serving: one buffer, written in place (537 MB at Mamba2's width)
        G = G.masked_fill_(~causal, float("-inf")).exp_()
        G.mul_(scores[:, :, None]).mul_(dth[:, :, :, None, :])
    y = torch.matmul(G, xh)                                   # [b,c,h,i,p]
    del G

    # per-chunk states: S_c = sum_j B_j dt_j decay(end, j) x_j
    w_end = dth * torch.exp(cum[..., -1:] - cum)              # [b,c,h,q]
    states = torch.matmul((xh * w_end[..., None]).transpose(-1, -2),
                          Bc[:, :, None])                     # [b,c,h,p,n]

    # inter-chunk recurrence (linear scan over chunks)
    chunk_decay = torch.exp(cum[..., -1])                     # [b,c,h]
    s_prev = (torch.zeros((b, h, p_, n), dtype=x.dtype, device=x.device)
              if s0 is None else s0.to(x.dtype))
    prefix = []
    for c in range(nc):
        prefix.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prefix = torch.stack(prefix, dim=1)                     # [b,c,h,p,n]

    y_inter = torch.matmul(Cc[:, :, None], s_prefix.transpose(-1, -2))
    y = y + y_inter * torch.exp(cum)[..., None]               # [b,c,h,i,p]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, h, p_)[:, :s]
    return y.to(x.dtype), s_prev


def ssd_recurrence(x, dt, A, B, C, s0=None):
    """The chunked scan's plain version: the SSM recurrence one step at a
    time, s_t = s_{t-1} exp(dt_t A) + dt_t B_t x_t and y_t = C_t . s_t, in
    the inputs' dtype (the JAX tests' ``naive_ssd``).  Same arguments and
    result as ``ssd_scan``, without the chunk; no product spans two steps,
    so it shares nothing with the scan's algorithm."""
    b, s, h, p_ = x.shape
    n = B.shape[-1]
    st = (torch.zeros((b, h, p_, n), dtype=x.dtype, device=x.device)
          if s0 is None else s0.to(x.dtype).clone())
    decay = torch.exp(dt * A)                                 # [b,s,h]
    dtx = dt[..., None] * x                                   # [b,s,h,p]
    y = torch.empty_like(x)
    for t in range(s):
        st.mul_(decay[:, t, :, None, None]).addcmul_(
            dtx[:, t, :, :, None], B[:, t, None, None, :])
        y[:, t] = torch.matmul(st, C[:, t, None, :, None])[..., 0]
    return y, st


def mamba_block(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    return_state: bool = False,
):
    """Full Mamba2 mixer over a sequence (the prefill path).

    With ``return_state`` also returns the decode-ready SSMState: the
    final recurrent state from the chunked scan plus the conv tail (the
    last K-1 *pre-conv* projected inputs) — what ``mamba_decode_step``
    continues from.
    """
    di, h, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    K = cfg.conv_kernel
    z = L._mm("bsd,de->bse", x, p["wz"])
    xi0 = L._mm("bsd,de->bse", x, p["wx"])
    Bv0 = L._mm("bsd,dn->bsn", x, p["wB"])
    Cv0 = L._mm("bsd,dn->bsn", x, p["wC"])
    dt = F.softplus(L._mm("bsd,dh->bsh", x, p["wdt"]).float()
                    + p["dt_bias"].float())
    xi = F.silu(_causal_conv(xi0, p["conv_x"]))
    Bv = F.silu(_causal_conv(Bv0, p["conv_B"]))
    Cv = F.silu(_causal_conv(Cv0, p["conv_C"]))
    xi = constrain(xi, "batch", "seq", "ssm_inner")

    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(*xi.shape[:2], h, hd).float()
    y, s_final = ssd_scan(xh, dt, A, Bv.float(), Cv.float(), cfg.ssm_chunk)
    y = y + xh * p["D"].float()[None, None, :, None]
    y = y.reshape(*xi.shape[:2], di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"])
    out = constrain(L._mm("bse,ed->bsd", y, p["wo"]), "batch", "seq", "embed")
    if not return_state:
        return out
    # conv tail: last K-1 raw (pre-conv) projected inputs, left-padded
    # with zeros when the prompt is shorter than the kernel
    cat = torch.cat([xi0, Bv0, Cv0], dim=-1)                 # [B, S, di+2n]
    cat = F.pad(cat, (0, 0, K - 1, 0))[:, -(K - 1):, :]
    return out, SSMState(s=s_final.float(), conv=cat.float())


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> SSMState:
    di, n = cfg.d_inner, cfg.ssm_state
    return SSMState(
        s=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                      dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * n),
                         dtype=dtype, device=device),
    )


def mamba_decode_step(
    p: Dict[str, torch.Tensor], x: torch.Tensor, state: SSMState,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, SSMState]:
    """Single-token decode: O(1) state update (x: [B, 1, d]).  Returns the
    output and a new SSMState; the caller's state is not written."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = L._mm("bsd,de->bse", x, p["wz"])[:, 0]
    xi = L._mm("bsd,de->bse", x, p["wx"])[:, 0]
    Bv = L._mm("bsd,dn->bsn", x, p["wB"])[:, 0]
    Cv = L._mm("bsd,dn->bsn", x, p["wC"])[:, 0]
    dt = F.softplus(L._mm("bsd,dh->bsh", x, p["wdt"])[:, 0].float()
                    + p["dt_bias"].float())                   # [B, H]

    # conv over the cached tail + this step (the f32 tail promotes it)
    cat = torch.cat([xi, Bv, Cv], dim=-1)                     # [B, di+2n]
    window = torch.cat([state.conv, cat[:, None, :]], dim=1)  # [B, K, *]
    wfull = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1)
    conv_out = F.silu(L._mm("bkf,kf->bf", window, wfull))
    xi, Bv, Cv = torch.split(conv_out, [di, n, n], dim=-1)

    A = -torch.exp(p["A_log"].float())                        # [H]
    xh = xi.reshape(-1, h, hd).float()
    decay = torch.exp(dt * A)                                 # [B, H]
    upd = (dt[:, :, None] * xh)[..., None] * Bv.float()[:, None, None, :]
    s_new = state.s * decay[..., None, None] + upd
    # a product and a sum, not a batched matmul: that would flatten [B, H]
    # into one dim, which on a mesh is sharded over the DP axes and over
    # `model` at once (DTensor has no strategy for it)
    y = (s_new * Cv.float()[:, None, None, :]).sum(-1)            # [B,H,P]
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(-1, di).to(x.dtype) * F.silu(z)
    y = L.rmsnorm(y, p["norm"])
    out = L._mm("be,ed->bd", y, p["wo"])[:, None, :]
    return out, SSMState(s=s_new, conv=window[:, 1:, :])
