"""The port's flash attention (its plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle.

The cases are fixed draws from the grid of ``tests/test_flash_attention.py``
(BH 1-4; Sq in {1, 7, 128, 130, 256}; Sk = Sq, or Sk in {128, 200, 256}
without ``causal``; D in {8, 64, 128}; f32 and bf16), held to that file's
bounds: 2e-5 in f32 and 2e-2 in bf16, rtol and atol — the summation order
differs from package to package.  The port's ``chunked_attention`` is held
to the JAX one's at that file's 3e-4.  The bf16 kernel's own rounding (P
in bf16 before P V) is emulated in plain torch and held to the same
bounds.  The CUDA kernel itself is checked on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.layers import chunked_attention as r_chunked

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.flash_attention import (TC_HEAD_DIMS, flash_attention,
                                                  template)
from repro_torch.models.layers import chunked_attention

torch.set_num_threads(1)

# (BH, Sq, Sk, D, dtype, causal)
CASES = [
    (1, 1, 1, 8, "f32", True),
    (2, 7, 7, 64, "bf16", True),
    (3, 128, 128, 128, "f32", True),
    (4, 130, 130, 64, "f32", True),
    (1, 256, 256, 8, "bf16", True),
    (2, 130, 130, 128, "bf16", False),
    (3, 1, 200, 64, "f32", False),
    (1, 7, 256, 128, "bf16", False),
    (2, 256, 128, 8, "f32", False),
    (4, 128, 200, 64, "bf16", False),
    (1, 130, 256, 128, "f32", False),
    (2, 256, 256, 64, "f32", False),
]
TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _problem(seed, BH, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(BH, S, D)).astype(np.float32)
              for S in (Sq, Sk, Sk)]
    jax_in = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    torch_in = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return jax_in, torch_in


@pytest.mark.parametrize("BH,Sq,Sk,D,dtype,causal", CASES)
def test_plain_version_matches_pallas_and_oracle(BH, Sq, Sk, D, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _problem(BH * 1000 + Sq + Sk + D, BH, Sq, Sk,
                                          D, dtype)
    launches = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == launches      # the CPU launches nothing
    assert got.dtype == TDT[dtype] and got.shape == (BH, Sq, D)
    got = got.float().numpy()
    tol = TOL[dtype]
    for want in (pallas_flash(jq, jk, jv, causal=causal, interpret=True),
                 rref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_causal_long_context():
    (jq, jk, jv), (tq, tk, tv) = _problem(0, 2, 512, 512, 64, "f32")
    got = tref.flash_attention_ref(tq, tk, tv, causal=True)
    want = rref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_chunked_attention_matches_jax():
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 256, 4, 64
    arrays = [rng.normal(size=(B, S, H, D)).astype(np.float32)
              for _ in range(3)]
    want = r_chunked(*[jnp.asarray(a) for a in arrays], causal=True,
                     chunk=128)
    got = chunked_attention(*[torch.from_numpy(a) for a in arrays],
                            causal=True, chunk=128)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_ops_entry_point_is_the_wrapper():
    assert ops.flash_attention is flash_attention
    assert "flash_attention" in ops.KERNELS


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "shape", "contiguous",
                                 "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 8, 16)
    k = torch.zeros(2, 8, 16)
    v = torch.zeros(2, 8, 16)
    if bad == "head_dim":
        q = k = v = torch.zeros(2, 8, 512)
    elif bad == "dtype":
        q = k = v = torch.zeros(2, 8, 16, dtype=torch.float16)
    elif bad == "shape":
        v = torch.zeros(2, 9, 16)
    elif bad == "contiguous":
        k = torch.zeros(2, 16, 8).transpose(1, 2)
    else:
        q = torch.zeros(2, 8, 4, 4)
    with pytest.raises(KernelError):
        flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# the bf16 tensor-core template's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

def tensor_core_emulation(q, k, v, causal):
    """What ``csrc/flash_attention.cu``'s bf16 template computes, in plain
    torch: f32 scores of the bf16 inputs, the online softmax over its key
    tiles (64 keys, 32 at a padded head dim above 192) with f32 m, l and
    accumulator, and P rounded to bf16 before P V."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    DP = next(p for p in TC_HEAD_DIMS if D <= p)
    BK = 32 if DP > 192 else 64
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, BK):
        keys = torch.arange(k0, min(k0 + BK, Sk))[None, :]
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + BK]) * D ** -0.5
        if causal:
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqk,bkd->bqd", p.bfloat16().float(), vf[:, k0:k0 + BK])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("D", [8, 100, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_template_rounding_within_the_bf16_bound(D, causal):
    """Rounding P to bf16 before P V (the tensor-core template's one
    difference from the TPU kernel) stays inside the JAX package's bf16
    bound against its Pallas kernel and its jnp oracle."""
    Sq, Sk = (130, 130) if causal else (7, 200)
    (jq, jk, jv), (tq, tk, tv) = _problem(D + Sk, 2, Sq, Sk, D, "bf16")
    got = tensor_core_emulation(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, Sq, D)
    got = got.float().numpy()
    for want in (pallas_flash(jq, jk, jv, causal=causal, interpret=True),
                 rref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL["bf16"], atol=TOL["bf16"])


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 8, "bf16 tensor cores (mma.sync m16n8k16), DP=16"),
    (torch.bfloat16, 72, "bf16 tensor cores (mma.sync m16n8k16), DP=96"),
    (torch.bfloat16, 200, "bf16 tensor cores (mma.sync m16n8k16), DP=256"),
    (torch.float32, 100, "f32 CUDA cores, DP=128"),
])
def test_template_names_the_dispatch(dtype, D, want):
    assert template(dtype, D) == want
