// Forward softmax attention (flash) on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel): for q [BH, Sq, D] and k, v
// [BH, Sk, D] in f32 or bf16,
//   s[i, j] = (q[i] . k[j]) * scale            scale = D ** -0.5
//   s[i, j] = -1e30 unless j < Sk and, under causal, j <= i (no offset)
//   o[i]    = sum_j softmax_j(s[i, :]) v[j]    in q's dtype
// with the online softmax of the flash algorithm: a running max m, sum l
// and accumulator acc per query row, all f32, rescaled by exp(m_old -
// m_new) at every key tile, and o = acc / max(l, 1e-30).  The TPU grid's
// sequential KV axis, which carried (m, l, acc) in VMEM scratch, is the
// tile loop inside one block here; tiles that lie wholly past the
// diagonal under causal are not visited (the TPU's pl.when(live)).
//
// What bounds it on the card: at the serving prefill (bf16, D = 128,
// S = 2048) the work is 4 * D operations a live (query, key) pair, ~270
// per byte of q, k, v and o: compute, on the tensor cores' 989 TFLOP/s
// for bf16.  This first kernel computes on the CUDA cores in f32 (no
// mma.sync / wgmma / TMA yet), so it sits far above that bound; the
// design is the simple one that is right for every shape:
//   * one block of 256 threads per (bh, 64-row query tile); the heaviest
//     causal tiles (the last rows) are scheduled first;
//   * the Q tile and each 64-key K and V tile are staged through shared
//     memory in the input dtype, zero beyond Sq, Sk and D; a thread
//     computes a 4 x 4 block of scores from registers (4 query rows, 4
//     keys), so a shared load feeds 4 FMAs;
//   * the 16 threads of a query row reduce its max and sum with warp
//     shuffles; the probabilities go through a [64, 65] f32 shared tile
//     into P V, where each thread owns 4 rows x D/16 columns of acc;
//   * shared memory is fixed by the padded head dim DP in {16, ..., 256}
//     (a template): at most 213,760 bytes (f32, DP = 256), set with
//     cudaFuncAttributeMaxDynamicSharedMemorySize; the wrapper refuses
//     D > 256.  Row strides are an odd number of 32-bit words, so the 16
//     threads that read 16 keys at one column hit 16 banks.
//
// Float semantics: build without --use_fast_math; exp is expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 keys of scores each
constexpr int kSP = kBK + 1;   // row stride of the probability tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Row stride (elements) of the Q and K tiles: an odd number of words.
template <typename T, int DP> __host__ __device__ constexpr int q_stride() {
  return DP + (sizeof(T) == 4 ? 1 : 2);
}

template <typename T, int DP> constexpr size_t smem_bytes() {
  return sizeof(float) * kBQ * kSP +
         sizeof(T) * ((kBQ + kBK) * q_stride<T, DP>() + kBK * DP);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,   // [BH, Sq, D]
    const T* __restrict__ k,   // [BH, Sk, D]
    const T* __restrict__ v,   // [BH, Sk, D]
    T* __restrict__ o,         // [BH, Sq, D]
    int Sq, int Sk, int D, int nq, int causal, float scale) {
  constexpr int SQ = q_stride<T, DP>();
  constexpr int DC = DP / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  T* Qs = reinterpret_cast<T*>(Ps + kBQ * kSP);
  T* Ks = Qs + kBQ * SQ;
  T* Vs = Ks + kBK * SQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // key / column group
  const int ty = tid >> 4;     // rows ty*4 .. ty*4+3
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kBQ;   // heaviest first
  const T* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const T* kb = k + static_cast<int64_t>(bh) * Sk * D;
  const T* vb = v + static_cast<int64_t>(bh) * Sk * D;
  const T zero = from_f<T>(0.0f);

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    Qs[r * SQ + d] = (q0 + r < Sq && d < D)
        ? qb[static_cast<int64_t>(q0 + r) * D + d] : zero;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) {
    // a tile is live iff its first key <= the block's last row
    const int live = (q0 + kBQ - 1) / kBK + 1;
    nk = nk < live ? nk : live;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      const bool in = k0 + r < Sk && d < D;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + d;
      Ks[r * SQ + d] = in ? kb[off] : zero;
      Vs[r * DP + d] = in ? vb[off] : zero;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(Qs[(ty * 4 + i) * SQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f(Ks[(tx + 16 * j) * SQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < Sk && (!causal || kj <= qi);
        s[i][j] = keep ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kSP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kSP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = to_f(Vs[j * DP + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] / lf);
    }
  }
}

template <typename T, int DP>
int launch_t(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Sk, int D, int causal, float scale,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(nq) * BH;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T, DP><<<static_cast<unsigned int>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, nq, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Sk, int D, int causal, float scale,
             cudaStream_t stream) {
  if (D <= 16)
    return launch_t<T, 16>(q, k, v, o, BH, Sq, Sk, D, causal, scale, stream);
  if (D <= 32)
    return launch_t<T, 32>(q, k, v, o, BH, Sq, Sk, D, causal, scale, stream);
  if (D <= 64)
    return launch_t<T, 64>(q, k, v, o, BH, Sq, Sk, D, causal, scale, stream);
  if (D <= 128)
    return launch_t<T, 128>(q, k, v, o, BH, Sq, Sk, D, causal, scale, stream);
  return launch_t<T, 256>(q, k, v, o, BH, Sq, Sk, D, causal, scale, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `o` and checks dtypes, shapes and 1 <= D <= 256;
// nothing is allocated here and nothing is synchronised.  is_bf16 picks
// __nv_bfloat16 inputs and output, else float.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int BH, int Sq,
    int Sk, int D, int causal, int is_bf16, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || D > 256 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, causal, scale, s)
      : dispatch<float>(q, k, v, o, BH, Sq, Sk, D, causal, scale, s);
}
