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
// diagonal under causal are not visited (the TPU's pl.when(live)), and
// the heaviest causal query tiles (the last rows) are scheduled first.
//
// What bounds it on the card: at the serving prefill (bf16, D = 128,
// S = 2048) the work is 4 * D operations a live (query, key) pair, ~270
// per byte of q, k, v and o: compute, on the tensor cores' 989 TFLOP/s
// for bf16.  Two templates:
//
// bf16: the tensor cores (flash_tc_kernel), FA2-style, by mma.sync
//   (m16n8k16, bf16 in, f32 accumulate) with hand-written PTX:
//   * one block of 4 warps per (bh, query tile); up to a padded head dim
//     DP = 128 each warp owns two m16 row tiles (a 128-row block tile),
//     so every K and V fragment it reads from shared memory feeds two
//     products, and ldmatrix traffic per product drops by a third; above
//     128 one (64 rows), to stay inside the register file.  Q stays in
//     shared memory and its fragments are read by ldmatrix at each k-step:
//     the registers hold the second row tile's accumulator instead;
//   * S = Q K^T per tile of BK keys (64; 32 at DP = 256) with K fragments
//     from ldmatrix; scores, m and l stay in registers, the row max and
//     sum reduce over the 4 threads of a quad with shuffles; exp(x) is
//     exp2f(x log2 e), one multiply-add and one MUFU.EX2 a score; the
//     mask is computed only in the tiles that cross the diagonal or Sk
//     (the rest are scaled and no more), and under causal a warp skips
//     the tiles wholly past its last row;
//   * P is rounded to bf16 in registers and is the A operand of P V as it
//     stands: the m16n8 accumulator layout is the m16n8k16 A layout, so
//     there is no shared-memory P tile.  V fragments by ldmatrix.trans;
//   * K and V tiles are double-buffered by 16-byte cp.async (commit_group
//     / wait_group): the next tile streams in while this one computes.
//     Rows are padded by 16 bytes, so the 8 rows an ldmatrix phase reads
//     fall in 8 distinct 4-bank groups;
//   * the head dim is padded with zeros to DP, a multiple of 16, in {16,
//     32, 64, 96, 128, 192, 256}; a row that is not 16-byte aligned (D
//     not a multiple of 8, or a data_ptr off 16 bytes) takes an element
//     load path in the same kernel.
//   One difference from the TPU kernel: P is rounded to bf16 before P V
//   (<= 2^-9 max|v| an output); the QK^T products of bf16 inputs are
//   exact in f32.
// f32: the CUDA cores (flash_f32_kernel), which keep every digit the
//   JAX package's 2e-5 bound asks for (TF32 keeps ~3):
//   * one block of 256 threads per (bh, 64-row query tile); the Q tile
//     and each 64-key K and V tile are staged through shared memory, zero
//     beyond Sq, Sk and D; a thread computes a 4 x 4 block of scores;
//   * the 16 threads of a query row reduce its max and sum with warp
//     shuffles; the probabilities go through a [64, 65] f32 shared tile
//     into P V, where each thread owns 4 rows x DP/16 columns of acc;
//   * shared memory is fixed by DP in {16, 32, 64, 128, 256}: at most
//     213,760 bytes (DP = 256).
// Both opt in to their dynamic shared memory with cudaFuncSetAttribute;
// the wrapper refuses D > 256.
//
// Float semantics: build without --use_fast_math; the f32 template's exp
// is expf, the bf16 one's exp2f(x log2 e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 keys of scores each
constexpr int kSP = kBK + 1;   // row stride of the probability tile

// Row stride (floats) of the Q and K tiles: odd, so the 16 threads that
// read 16 keys at one column hit 16 banks.
template <int DP> __host__ __device__ constexpr int q_stride() {
  return DP + 1;
}

template <int DP> constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBQ * kSP + (kBQ + kBK) * q_stride<DP>() + kBK * DP);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q,   // [BH, Sq, D]
    const float* __restrict__ k,   // [BH, Sk, D]
    const float* __restrict__ v,   // [BH, Sk, D]
    float* __restrict__ o,         // [BH, Sq, D]
    int Sq, int Sk, int D, int nq, int causal, float scale) {
  constexpr int SQ = q_stride<DP>();
  constexpr int DC = DP / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* Qs = Ps + kBQ * kSP;
  float* Ks = Qs + kBQ * SQ;
  float* Vs = Ks + kBK * SQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // key / column group
  const int ty = tid >> 4;     // rows ty*4 .. ty*4+3
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kBQ;   // heaviest first
  const float* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const float* kb = k + static_cast<int64_t>(bh) * Sk * D;
  const float* vb = v + static_cast<int64_t>(bh) * Sk * D;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    Qs[r * SQ + d] = (q0 + r < Sq && d < D)
        ? qb[static_cast<int64_t>(q0 + r) * D + d] : 0.0f;
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
      Ks[r * SQ + d] = in ? kb[off] : 0.0f;
      Vs[r * DP + d] = in ? vb[off] : 0.0f;
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
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * SQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * SQ + d];
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
        const float vv = Vs[j * DP + tx + 16 * c];
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
    float* orow = o + (static_cast<int64_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = acc[i][c] / lf;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int DP> struct Tc {
  // m16 row tiles a warp owns: two up to DP = 128, so every K and V
  // fragment read from shared memory feeds two products; one above, to
  // stay inside the register file
  static constexpr int MT = DP <= 128 ? 2 : 1;
  static constexpr int BQ = kTcThreads / 32 * 16 * MT;   // rows a block
  static constexpr int BK = DP > 192 ? 32 : 64;   // keys a tile
  static constexpr int STR = DP + 8;              // row stride: +16 bytes
  // Q [BQ][STR], then K and V, two buffers each: [2][BK][STR]
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (BQ + 4 * BK) * STR;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + ROWS) of a [S, D] matrix into a [ROWS][STR] tile,
// zero past S and D: 16-byte cp.async chunks when `vec` (the caller
// commits them), else element loads.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int D, bool vec) {
  constexpr int STR = Tc<DP>::STR;
  if (vec) {
    constexpr int CPR = DP / 8;   // chunks a row
    static_assert(ROWS * CPR % kTcThreads == 0, "whole rounds of chunks");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / kTcThreads; ++i) {
      const int c = threadIdx.x + i * kTcThreads;
      const int r = c / CPR, col = (c % CPR) * 8;
      const bool in = row0 + r < S && col < D;
      const __nv_bfloat16* from =
          in ? src + static_cast<int64_t>(row0 + r) * D + col : src;
      cp_async16(smem_addr(tile + r * STR + col), from, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kTcThreads) {
      const int r = i / DP, d = i % DP;
      tile[r * STR + d] = (row0 + r < S && d < D)
          ? src[static_cast<int64_t>(row0 + r) * D + d]
          : __float2bfloat16(0.0f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // [BH, Sq, D]
    const __nv_bfloat16* __restrict__ k,   // [BH, Sk, D]
    const __nv_bfloat16* __restrict__ v,   // [BH, Sk, D]
    __nv_bfloat16* __restrict__ o,         // [BH, Sq, D]
    int Sq, int Sk, int D, int nq, int causal, float scale, int vec) {
  constexpr int MT = Tc<DP>::MT;
  constexpr int BQ = Tc<DP>::BQ;
  constexpr int BK = Tc<DP>::BK;
  constexpr int STR = Tc<DP>::STR;
  constexpr int NT = BK / 8;    // score tiles of 8 keys
  constexpr int ND = DP / 8;    // accumulator tiles of 8 columns
  constexpr int KQ = DP / 16;   // k-steps of Q K^T
  constexpr int KV = BK / 16;   // k-steps of P V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * STR;           // [2][BK][STR]
  __nv_bfloat16* Vs = Ks + 2 * BK * STR;       // [2][BK][STR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;     // quad, thread in quad
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;   // heaviest first
  const int w0 = q0 + warp * 16 * MT;               // the warp's first row
  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(bh) * Sk * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(bh) * Sk * D;

  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    // a tile is live iff its first key <= the block's last row
    const int live = (q0 + BQ - 1) / BK + 1;
    nk = nk < live ? nk : live;
  }
  load_tile<DP, BQ>(Qs, qb, q0, Sq, D, vec);
  if (nk > 0) {
    load_tile<DP, BK>(Ks, kb, 0, Sk, D, vec);
    load_tile<DP, BK>(Vs, vb, 0, Sk, D, vec);
  }
  cp_async_commit();

  // ldmatrix addresses: lane l names row l % 8 of matrix l / 8.  Q (A)
  // and V (trans): matrices 1, 3 are rows +8, matrices 2, 3 columns +8;
  // K (B, non-trans): matrices 2, 3 are keys +8, matrices 1, 3 columns +8.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr =
      smem_addr(Qs + (warp * 16 * MT + a_row) * STR + a_col);

  // row tile mt of the warp: this thread's rows w0 + 16 mt + g (elements
  // 0, 1 of an accumulator tile) and + 8 (elements 2, 3)
  float acc[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
    m[mt][0] = m[mt][1] = kMasked;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    const int buf = t & 1;
    if (t + 1 < nk) {   // the next tile streams in while this one computes
      load_tile<DP, BK>(Ks + (buf ^ 1) * BK * STR, kb, k0 + BK, Sk, D, vec);
      load_tile<DP, BK>(Vs + (buf ^ 1) * BK * STR, vb, k0 + BK, Sk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // under causal a tile wholly past the warp's last row changes none of
    // its rows (every p is 0, every rescale 1)
    if (!causal || k0 <= w0 + 16 * MT - 1) {
      const __nv_bfloat16* Kt = Ks + buf * BK * STR;
      const __nv_bfloat16* Vt = Vs + buf * BK * STR;

      // S = Q K^T, [16 MT, BK] a warp
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(q_addr + (mt * 16 * STR + kk * 16) * 2, a[mt]);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t b[4];
          ldsm_x4(smem_addr(Kt + (j2 * 16 + k_row) * STR + kk * 16 + k_col),
                  b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * j2], a[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * j2 + 1], a[mt], b[2], b[3]);
          }
        }
      }

      // scale and mask: element e of score tile j is key k0 + 8j + 2 tig
      // + e % 2 of row w0 + 16 mt + g + 8 (e / 2)
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > w0);
      if (edge) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 8 + tig * 2 + (e & 1);
              const int row = w0 + mt * 16 + g + (e >> 1) * 8;
              const bool keep = key < Sk && (!causal || key <= row);
              s[mt][j][e] = keep ? s[mt][j][e] * scale : kMasked;
            }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale;
      }

      // online softmax; a row's 4 threads (a quad) share its max.  exp(x)
      // is exp2f(x log2 e), one multiply-add and one MUFU.EX2 a score
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = kMasked;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mt][h], mx);
          const float corr = exp2f((m[mt][h] - mn) * kLog2e);
          const float off = -mn * kLog2e;
          m[mt][h] = mn;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              s[mt][j][e] = exp2f(fmaf(s[mt][j][e], kLog2e, off));
              sum += s[mt][j][e];
            }
          // l stays a per-thread partial sum (the quad's corr is one)
          l[mt][h] = l[mt][h] * corr + sum;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            acc[mt][n][2 * h] *= corr;
            acc[mt][n][2 * h + 1] *= corr;
          }
        }
      }

      // O += P V: score tiles 2kk, 2kk + 1 are the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(
              smem_addr(Vt + (kk * 16 + a_row) * STR + n2 * 16 + a_col), b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * n2], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * n2 + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // this buffer is refilled at step t + 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = w0 + mt * 16 + g + h * 8;
      if (row >= Sq) continue;
      const float f = fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + tig * 2;
        const float x = acc[mt][n][2 * h] / f;
        const float y = acc[mt][n][2 * h + 1] / f;
        if (vec) {
          if (d < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(x, y);
        } else {
          if (d < D) orow[d] = __float2bfloat16(x);
          if (d + 1 < D) orow[d + 1] = __float2bfloat16(y);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Opt `kernel` in to `smem` bytes of dynamic shared memory and count its
// blocks: one per (bh, BQ-row query tile).
template <typename Kernel>
int grid_of(Kernel kernel, size_t smem, int BQ, int BH, int Sq, int& nq,
            unsigned int& blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nq = (Sq + BQ - 1) / BQ;
  const int64_t n = static_cast<int64_t>(nq) * BH;
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  blocks = static_cast<unsigned int>(n);
  return static_cast<int>(cudaSuccess);
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int Sq, int Sk, int D, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<DP>();
  int nq;
  unsigned int blocks;
  const int err = grid_of(flash_f32_kernel<DP>, smem, kBQ, BH, Sq, nq,
                          blocks);
  if (err) return err;
  flash_f32_kernel<DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, D, nq,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int Sq, int Sk, int D, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = Tc<DP>::smem;
  int nq;
  unsigned int blocks;
  const int err = grid_of(flash_tc_kernel<DP>, smem, Tc<DP>::BQ, BH, Sq,
                          nq, blocks);
  if (err) return err;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  const int vec = D % 8 == 0 && (bits & 15) == 0;
  flash_tc_kernel<DP><<<blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, D, nq, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `o` and checks dtypes, shapes and 1 <= D <= 256;
// nothing is allocated here and nothing is synchronised.  is_bf16 picks
// __nv_bfloat16 inputs and output on the tensor cores, else float on the
// CUDA cores.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int BH, int Sq,
    int Sk, int D, int causal, int is_bf16, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || D > 256 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, BH, Sq, Sk, D, causal, scale, s
  if (is_bf16) {
    if (D <= 16) return launch_tc<16>(FLASH_ARGS);
    if (D <= 32) return launch_tc<32>(FLASH_ARGS);
    if (D <= 64) return launch_tc<64>(FLASH_ARGS);
    if (D <= 96) return launch_tc<96>(FLASH_ARGS);
    if (D <= 128) return launch_tc<128>(FLASH_ARGS);
    if (D <= 192) return launch_tc<192>(FLASH_ARGS);
    return launch_tc<256>(FLASH_ARGS);
  }
  if (D <= 16) return launch_f32<16>(FLASH_ARGS);
  if (D <= 32) return launch_f32<32>(FLASH_ARGS);
  if (D <= 64) return launch_f32<64>(FLASH_ARGS);
  if (D <= 128) return launch_f32<128>(FLASH_ARGS);
  return launch_f32<256>(FLASH_ARGS);
#undef FLASH_ARGS
}
