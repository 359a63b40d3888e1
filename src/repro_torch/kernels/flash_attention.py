"""Forward softmax attention (flash) over ``[BH, S, D]``.

``flash_attention(q, k, v, causal)`` computes, for q [BH, Sq, D] and k, v
[BH, Sk, D] in f32 or bf16, softmax(q k^T * D ** -0.5) v with f32 scores,
running max, sum and accumulator, and returns q's dtype.  Under ``causal``
key j is kept for query i iff ``j <= i``, with no offset, for any Sq and
Sk; masked scores are -1e30, and the normaliser has a floor of 1e-30, as
in the JAX package's Pallas kernel (``src/repro/kernels/flash_attention.py``).
The model's prefill reaches it through ``models.layers.chunked_attention``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` (built at first use, see ``build.py``): bf16 on
the tensor cores (``mma.sync``, P rounded to bf16 before P V), f32 on the
CUDA cores (``template`` names the one a call runs); on a CPU tensor it
runs the plain PyTorch version (``ref.flash_attention_ref``).
There is no fallback between the two: a CUDA input either launches the
kernel or raises ``KernelError``, as does any input the kernel does not
take (another dtype, a head dim above 256).

Training: whenever grad mode is on and q, k or v requires grad, the
wrapper runs through ``FlashAttention`` (a ``torch.autograd.Function``)
on both devices.  Its forward is the path above and saves q, k and v;
its backward is the plain version ``ref.flash_attention_bwd_ref``, which
recomputes P in f32, so the gradient is that of the plain attention, not
of the kernel's bf16 rounding.  The JAX package has no backward kernel
(its training differentiates the jnp attention).  The bare launch
(``_launch``) refuses grad-requiring inputs while grad mode is on: its
output has no autograd history, and a loss through it would get no
gradient for q, k and v without a word.
"""

from __future__ import annotations

import torch

from . import build
from .build import KernelError, check_tensor
from .ref import flash_attention_bwd_ref, flash_attention_ref

KERNEL = "flash_attention"
MAX_HEAD_DIM = 256          # the kernel's shared-memory tiles are sized for it
DTYPES = (torch.float32, torch.bfloat16)
# padded head dims of the bf16 tensor-core template and of the f32 one
TC_HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
F32_HEAD_DIMS = (16, 32, 64, 128, 256)


def template(dtype: torch.dtype, D: int) -> str:
    """The kernel template a CUDA call with this dtype and head dim runs,
    as ``csrc/flash_attention.cu`` dispatches it."""
    tc = dtype == torch.bfloat16
    DP = next(p for p in (TC_HEAD_DIMS if tc else F32_HEAD_DIMS) if D <= p)
    return (f"bf16 tensor cores (mma.sync m16n8k16), DP={DP}" if tc
            else f"f32 CUDA cores, DP={DP}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """The kernel on checked CUDA tensors: o [BH, Sq, D], with no autograd
    history, so it raises on grad-requiring inputs while grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise KernelError(
            "the bare flash_attention launch would drop the gradient of q, "
            "k and v: call flash_attention, which runs FlashAttention")
    BH, Sq, D = q.shape
    o = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return o                        # nothing to launch
    build.launch(KERNEL, q.device, q, k, v, o, BH, Sq, int(k.shape[1]), D,
                 int(bool(causal)), int(q.dtype == torch.bfloat16),
                 float(D) ** -0.5)
    flash_attention.launches += 1
    return o


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    if build.runs_kernel(q.device):
        return _launch(q, k, v, causal)
    return flash_attention_ref(q, k, v, causal=causal)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward of ``flash_attention`` (the
    kernel on the card, the plain version on the CPU), the backward of the
    plain version (``ref.flash_attention_bwd_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do.contiguous(),
                                             ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,         # [BH, Sq, D]
    k: torch.Tensor,         # [BH, Sk, D]
    v: torch.Tensor,         # [BH, Sk, D]
    causal: bool = True,
) -> torch.Tensor:
    """Returns o [BH, Sq, D] in q's dtype on q's device, differentiable in
    q, k and v."""
    if q.dim() != 3 or k.dim() != 3:
        raise KernelError("q must be [BH, Sq, D] and k, v [BH, Sk, D]")
    BH, Sq, D = q.shape
    Sk = int(k.shape[1])
    dev = q.device
    if q.dtype not in DTYPES:
        raise KernelError(f"q must be one of {DTYPES}, got {q.dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise KernelError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    for name, t, shape in (("q", q, (BH, Sq, D)), ("k", k, (BH, Sk, D)),
                           ("v", v, (BH, Sk, D))):
        check_tensor(name, t, q.dtype, shape, dev)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal))
    return _forward(q, k, v, causal)


# launches of the CUDA kernel (CPU calls of the plain version not counted)
flash_attention.launches = 0
