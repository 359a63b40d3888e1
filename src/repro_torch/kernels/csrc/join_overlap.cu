// Single-query JOIN distinct-key overlap on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/join_overlap.py
// (join_overlap, body _join_overlap_kernel): one build side's sorted
// distinct join keys [D] against every probe partition's [pmin, pmax] key
// interval [P], giving
//   hit[p] = 1  iff some key d has pmin[p] <= d <= pmax[p]
// (0: the partition can be pruned).  The empty interval (+inf, -inf) of an
// all-null partition never hits.
//
// The TPU kernel compares every key with every partition (D * P compares,
// NaN-padded to its tiles).  Here each thread binary-searches pmin[p] in
// the sorted keys (a lower bound: the first key >= pmin[p]) and tests that
// one key against pmax[p], the reference's own searchsorted formulation:
// at most log2(D) + 1 steps instead of D.  A binary search is right only
// on a sorted, NaN-free list; the wrapper (kernels/join_overlap.py)
// checks both before it launches.
//
// What bounds it on the card: memory.  The least traffic is the two f32
// interval rows (8 bytes per partition), the keys once and one int32
// verdict per partition; the search steps run in shared memory.  The
// design:
//   * one thread per partition, kPerThread partitions a thread in tiles
//     of kThreads, so interval loads and verdict stores are coalesced;
//   * each block stages the keys in shared memory once (up to
//     kSharedKeys keys, 16 KB); a longer list is searched in place through
//     L1/L2 instead, so any D launches.
//
// Float semantics: build without --use_fast_math; the compares are IEEE
// f32, denormals included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;         // partitions per thread
constexpr int kSharedKeys = 4096;     // keys staged in shared memory

__global__ void join_overlap_kernel(
    const float* __restrict__ pmin,       // [P]
    const float* __restrict__ pmax,       // [P]
    const float* __restrict__ distinct,   // [D] sorted, no NaN
    int32_t* __restrict__ hit,            // [P]
    int D, int P) {
  __shared__ float s_keys[kSharedKeys];
  const float* keys = distinct;
  if (D <= kSharedKeys) {
    for (int i = threadIdx.x; i < D; i += blockDim.x) s_keys[i] = distinct[i];
    __syncthreads();
    keys = s_keys;                    // generic pointer into shared memory
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kPerThread;
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t p = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    if (p >= P) break;
    const float lo = __ldg(pmin + p);
    const float hi = __ldg(pmax + p);
    // lower bound: the number of keys < lo
    int first = 0;
    int n = D;
    while (n > 0) {
      const int half = n >> 1;
      if (keys[first + half] < lo) {
        first += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    hit[p] = (first < D && keys[first] <= hi) ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `hit`, checks shapes and checks that the keys are
// sorted and hold no NaN; nothing is allocated here and nothing is
// synchronised.
extern "C" int join_overlap_launch(
    const void* pmin, const void* pmax, const void* distinct, void* hit,
    int D, int P, void* stream) {
  if (P <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = static_cast<int64_t>(kThreads) * kPerThread;
  const unsigned int blocks = static_cast<unsigned int>((P + tile - 1) / tile);
  join_overlap_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pmin), static_cast<const float*>(pmax),
      static_cast<const float*>(distinct), static_cast<int32_t*>(hit), D, P);
  return static_cast<int>(cudaGetLastError());
}
