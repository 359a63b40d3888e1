// Batched JOIN distinct-key overlap on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/join_overlap.py
// (join_overlap_batched, body _join_overlap_batched_kernel): Q queries,
// each with its build side's sorted distinct join keys, against the
// resident [Pc] join-key plane of the probe table, giving
//   hit[q, p] = 1  iff some key d of query q has pmin[p] <= d <= pmax[p]
// for the first P partitions.  Key rows are [Q, Db] f32, non-decreasing,
// padded with +inf; the plane is finite (clamped to +-f32max), so a pad
// key never lands inside an interval, and the empty-interval sentinel
// (+f32max, -f32max) of dropped and capacity slots never hits.
//
// The TPU kernel compares every key with every partition: Db * Q * P
// comparisons, 2.7e11 at 4096 keys x 32 queries x 2M slots.  Here each
// thread binary-searches pmin[p] in the query's sorted keys (a lower
// bound: the first key >= pmin[p]) and tests that one key against
// pmax[p] -- the reference's own searchsorted formulation, at most
// log2(Db) + 1 steps instead of Db.
//
// What bounds it on the card: memory.  The least traffic is the plane's
// two f32 rows (8 bytes per partition) plus one verdict byte per (query,
// partition); the search steps run in shared memory.  The design:
//   * one query per block (grid.y), a tile of kThreads * kPerThread
//     partitions per block (grid.x); neighbouring threads take
//     neighbouring partitions, so plane loads and verdict stores are
//     coalesced;
//   * the block stages its query's keys in shared memory once (up to
//     kSharedKeys keys, 16 KB); a longer key row is searched in place
//     through L1/L2 instead, so any Db launches;
//   * verdicts are int8 in the logical [Q, P] output.
//
// Float semantics: build without --use_fast_math; the compares are IEEE
// f32, denormals included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;         // partitions per thread
constexpr int kSharedKeys = 4096;     // keys staged in shared memory

__global__ void join_overlap_batched_kernel(
    const float* __restrict__ dist,   // [Q, Db] sorted keys, +inf padded
    const float* __restrict__ pmin,   // [Pc]
    const float* __restrict__ pmax,   // [Pc]
    int8_t* __restrict__ hit,         // [Q, P]
    int Db, int P) {
  __shared__ float s_keys[kSharedKeys];
  const int q = blockIdx.y;
  const float* row = dist + static_cast<int64_t>(q) * Db;
  const float* keys = row;
  if (Db <= kSharedKeys) {
    for (int i = threadIdx.x; i < Db; i += blockDim.x) s_keys[i] = row[i];
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
    int n = Db;
    while (n > 0) {
      const int half = n >> 1;
      if (keys[first + half] < lo) {
        first += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    const bool h = first < Db && keys[first] <= hi;
    hit[static_cast<int64_t>(q) * P + p] = h ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `hit` and checks shapes; nothing is allocated here and
// nothing is synchronised.
extern "C" int join_overlap_batched_launch(
    const void* dist, const void* pmin, const void* pmax, void* hit, int Q,
    int Db, int P, void* stream) {
  if (Q <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (Db <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = static_cast<int64_t>(kThreads) * kPerThread;
  const unsigned int tiles = static_cast<unsigned int>((P + tile - 1) / tile);
  // grid.y holds at most 65535 queries: longer batches go in chunks
  for (int q0 = 0; q0 < Q; q0 += 65535) {
    const int nq = Q - q0 < 65535 ? Q - q0 : 65535;
    join_overlap_batched_kernel<<<dim3(tiles, nq), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dist) + static_cast<int64_t>(q0) * Db,
        static_cast<const float*>(pmin), static_cast<const float*>(pmax),
        static_cast<int8_t*>(hit) + static_cast<int64_t>(q0) * P, Db, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
