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
// P needs no padding either (threads past P store nothing).
//
// What bounds it on the card: memory.  The least traffic is the three
// [K, P] f32 stat rows (12 bytes per constraint and partition) plus one
// int32 verdict per partition.  The design:
//   * one thread per partition, a loop over K; row i is read at
//     i * P + p, so a warp's loads are 32 consecutive floats (coalesced);
//   * lo / hi go through a fixed kSlots-slot static shared-memory tile,
//     in chunks when K is larger, so shared memory stays at 16 KB for any
//     K (a tile sized by K failed to launch at K = 8192 in the batched
//     kernel);
//   * AND is a min, so a thread whose verdict reached NO reads no more
//     rows, and a block whose threads all reached NO stops staging
//     chunks (__syncthreads_or at each chunk).
//
// Float semantics: build without --use_fast_math and without -ftz=true;
// the compares are IEEE f32, denormals included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // partitions per block
constexpr int kSlots = 2048;    // (lo, hi) pairs in shared memory

__global__ void minmax_prune_kernel(
    const float* __restrict__ lo,         // [K]
    const float* __restrict__ hi,         // [K]
    const float* __restrict__ mins,       // [K, P]
    const float* __restrict__ maxs,       // [K, P]
    const float* __restrict__ nullable,   // [K, P]
    int32_t* __restrict__ tv,             // [P]
    int K, int P) {
  __shared__ float s_lo[kSlots];
  __shared__ float s_hi[kSlots];
  const int64_t p64 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // threads past P stage slots and meet every barrier, but store nothing
  const bool active = p64 < P;
  const int64_t p = active ? p64 : 0;
  int v = active ? 2 : 0;
  for (int c0 = 0; c0 < K; c0 += kSlots) {
    // a barrier before restaging: the previous chunk has been read; and
    // the whole block stops once every verdict is NO
    if (!__syncthreads_or(v > 0)) break;
    const int m = K - c0 < kSlots ? K - c0 : kSlots;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      s_lo[i] = lo[c0 + i];
      s_hi[i] = hi[c0 + i];
    }
    __syncthreads();
    for (int i = 0; i < m && v > 0; ++i) {
      const int64_t off = static_cast<int64_t>(c0 + i) * P + p;
      const float l = s_lo[i];
      const float h = s_hi[i];
      const float pmin = __ldg(mins + off);
      const float pmax = __ldg(maxs + off);
      const float pnull = __ldg(nullable + off);
      const bool empty = pmin > pmax;
      const bool no = (pmax < l) | (pmin > h) | empty;
      const bool full = (pmin >= l) & (pmax <= h) & (pnull == 0.0f) & !empty;
      v = min(v, no ? 0 : (full ? 2 : 1));
    }
  }
  if (active) tv[p] = v;
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
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<int64_t>(P) + kThreads - 1) /
                                kThreads);
  minmax_prune_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(mins), static_cast<const float*>(maxs),
      static_cast<const float*>(nullable), static_cast<int32_t*>(tv), K, P);
  return static_cast<int>(cudaGetLastError());
}
