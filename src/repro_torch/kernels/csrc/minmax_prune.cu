// Single-query three-valued min/max range pruning on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/minmax_prune.py
// (minmax_prune, body _minmax_prune_kernel): one conjunction of K closed
// ranges [lo[i], hi[i]] against [K, P] pre-gathered per-constraint stats
// (row i holds the partition minima / maxima / nullable flags of
// constraint i's column), giving tv[p] in
//   0 = NO       pmax < lo, pmin > hi, or pmin > pmax (empty interval)
//   2 = FULL     lo <= pmin, pmax <= hi, nullable == 0 and not empty
//   1 = PARTIAL  otherwise
// combined over the K constraints by min (AND).  Unlike the batched
// kernel there is no padding slot: every row is a real constraint, and
// P needs no padding either.
//
// What bounds it on the card: memory.  The least traffic is what the data
// needs: constraint i's min and max where no earlier constraint made the
// verdict NO, its nullable flag only where the verdict can still be FULL,
// and one int32 verdict a partition.  The design streams that:
//   * a thread takes kV consecutive partitions and reads each row with one
//     16-byte load (kV = 4) where the row's address allows it; a row off
//     16 bytes (P % 4 != 0, or a view at another storage offset) and the
//     last partial group are read 4 bytes at a time;
//   * lo[i] and hi[i] are the same for every thread: read through the
//     read-only cache, with no shared staging and no barrier for any K;
//   * a constraint's nullable flags are loaded only when one of the
//     thread's partitions can still be FULL (2 so far and its interval
//     inside [lo, hi]);
//   * AND is a min, so a thread whose verdicts all reached NO reads no
//     more rows;
//   * the verdicts go out with one 16-byte store;
//   * the grid covers P with kV * kThreads partitions a block, up to the
//     blocks the card holds at once, and strides over the rest.
//
// Float semantics: build without --use_fast_math and without -ftz=true;
// the compares are IEEE f32, denormals included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kV = 4;           // consecutive partitions a thread
constexpr int kBlocksPerSM = 2048 / kThreads;   // resident at most
static_assert(kV == 2 || kV == 4, "kV is 2 or 4");

__device__ __forceinline__ bool vec_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * kV - 1)) == 0;
}

// x[e] = a[e] for e < n (n in [1, kV]), one vector load where it can.
__device__ __forceinline__ void load_v(const float* __restrict__ a, int n,
                                       float (&x)[kV]) {
  if (n == kV && vec_aligned(a)) {
    if constexpr (kV == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(a));
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else {
      const float2 t = __ldg(reinterpret_cast<const float2*>(a));
      x[0] = t.x;
      x[1] = t.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) x[e] = e < n ? __ldg(a + e) : 0.0f;
}

// a[e] = v[e] for e < n, one vector store where it can.
__device__ __forceinline__ void store_v(int32_t* __restrict__ a, int n,
                                        const int (&v)[kV]) {
  if (n == kV && vec_aligned(a)) {
    if constexpr (kV == 4) {
      *reinterpret_cast<int4*>(a) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<int2*>(a) = make_int2(v[0], v[1]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e)
    if (e < n) a[e] = v[e];
}

__global__ void __launch_bounds__(kThreads) minmax_prune_kernel(
    const float* __restrict__ lo,         // [K]
    const float* __restrict__ hi,         // [K]
    const float* __restrict__ mins,       // [K, P]
    const float* __restrict__ maxs,       // [K, P]
    const float* __restrict__ nullable,   // [K, P]
    int32_t* __restrict__ tv,             // [P]
    int K, int P) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kV;
  for (int64_t p = (static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x) * kV;
       p < P; p += stride) {
    const int n = P - p < kV ? static_cast<int>(P - p) : kV;
    int v[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) v[e] = e < n ? 2 : 0;
    for (int i = 0; i < K; ++i) {
      bool live = false;
#pragma unroll
      for (int e = 0; e < kV; ++e) live |= v[e] > 0;
      if (!live) break;
      const float l = __ldg(lo + i);
      const float h = __ldg(hi + i);
      const int64_t off = static_cast<int64_t>(i) * P + p;
      float mn[kV], mx[kV], nl[kV];
      load_v(mins + off, n, mn);
      load_v(maxs + off, n, mx);
      bool no[kV], inside[kV];
      bool need = false;              // can some verdict still be FULL?
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const bool empty = mn[e] > mx[e];
        no[e] = (mx[e] < l) | (mn[e] > h) | empty;
        inside[e] = (mn[e] >= l) & (mx[e] <= h) & !empty;
        need |= (v[e] == 2) & inside[e];
        nl[e] = 1.0f;                 // read only where FULL can be kept
      }
      if (need) load_v(nullable + off, n, nl);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const int t = no[e] ? 0 : ((inside[e] & (nl[e] == 0.0f)) ? 2 : 1);
        v[e] = v[e] < t ? v[e] : t;
      }
    }
    store_v(tv + p, n, v);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `tv` and checks shapes; nothing is allocated here and
// nothing is synchronised.
extern "C" int minmax_prune_launch(
    const void* lo, const void* hi, const void* mins, const void* maxs,
    const void* nullable, void* tv, int K, int P, void* stream) {
  if (P <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kV;
  const int64_t need = (static_cast<int64_t>(P) + per_block - 1) / per_block;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSM;
  const unsigned int blocks =
      static_cast<unsigned int>(need < most ? need : most);
  minmax_prune_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(mins), static_cast<const float*>(maxs),
      static_cast<const float*>(nullable), static_cast<int32_t*>(tv), K, P);
  return static_cast<int>(cudaGetLastError());
}
