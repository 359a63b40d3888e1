// Sequential top-k boundary scan on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/topk_boundary.py
// (topk_boundary, body _topk_boundary_kernel): the paper's Sec. 5 scan
// over per-partition block-top-k rows [P, k] f32 in processing order (each
// row descending, -inf padded, no NaN), carrying the global top-k heap.
// With H the heap's k-th value (the heap is full iff H > -inf) and B the
// upfront boundary, row j is skipped iff
//   row[0] < max(B, full ? H : -inf)   or   (full and row[0] <= H),
// and a row that is not skipped merges into the heap.  Outputs: skip [P]
// int32 and the final heap [k], descending, -inf padded.
//
// The carry is sequential by the paper's semantics (a prefix formulation
// would skip a superset, a different result), so one block walks the rows.
// Between two merges the heap does not change and the skip test is one
// fixed threshold over the row heads, so the block tests a tile of heads
// at once:
//   * each thread loads kHeadsPerThread heads of the tile into registers
//     (row j's head at j * k: one 32-byte sector a head);
//   * a block-wide min finds the first row of the tile that merges; the
//     rows before it get skip = 1 with no further work;
//   * that row is staged in shared memory and merged into the heap there
//     by merge path: each thread ranks a candidate by a binary search in
//     the other sorted list (heap values win ties, so the ranks are a
//     permutation) and writes it to its rank if that is below k;
//   * the scan carries on from the next row of the same tile, its heads
//     still in registers, and loads the next tile when this one is done.
//
// What bounds it on the card: at best the row heads (one sector each),
// the merged rows and the skip output, but a single block on one SM
// cannot draw the card's memory rate, and every merge is a chain of
// block-wide barriers: latency, not bytes, is its real limit.
//
// Shared memory: the heap, the staged row and the merge target, 3 * k
// floats (192 KB at the largest k = kMaxK), as dynamic shared memory
// opted in with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeadsPerThread = 8;
constexpr int kTile = kThreads * kHeadsPerThread;   // rows per tile
constexpr int kMaxK = 16384;
constexpr int kNone = 0x7fffffff;

// Number of leading values of `list` (descending, n long) that are > v,
// or >= v with `or_equal`.
__device__ __forceinline__ int count_before(const float* list, int n, float v,
                                            bool or_equal) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = list[mid];
    if (x > v || (or_equal && x == v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void topk_boundary_kernel(
    const float* __restrict__ rows,   // [P, k]
    float b_init,
    int32_t* __restrict__ skip,       // [P]
    float* __restrict__ heap_out,     // [k]
    int P, int k) {
  extern __shared__ float s_mem[];    // heap [k], row [k], merge target [k]
  __shared__ int s_first;
  const int tid = threadIdx.x;
  float* heap = s_mem;
  float* row = s_mem + k;
  float* next = s_mem + 2 * k;
  for (int i = tid; i < k; i += kThreads) heap[i] = -CUDART_INF_F;
  __syncthreads();
  float h = -CUDART_INF_F;            // heap[k - 1], the same in every thread

  for (int t0 = 0; t0 < P; t0 += kTile) {
    const int tend = P - t0 < kTile ? P : t0 + kTile;
    float head[kHeadsPerThread];
#pragma unroll
    for (int r = 0; r < kHeadsPerThread; ++r) {
      const int j = t0 + r * kThreads + tid;
      head[r] = j < tend ? __ldg(rows + static_cast<int64_t>(j) * k)
                         : -CUDART_INF_F;
    }
    int start = t0;
    while (true) {
      const bool full = h > -CUDART_INF_F;
      const float eff = fmaxf(b_init, full ? h : -CUDART_INF_F);
      int local = kNone;              // first merging row of mine, from t0
#pragma unroll
      for (int r = 0; r < kHeadsPerThread; ++r) {
        const int j = t0 + r * kThreads + tid;
        const float bm = head[r];
        const bool skipped = (bm < eff) | (full & (bm <= h));
        if (j >= start && j < tend && !skipped)
          local = min(local, r * kThreads + tid);
      }
      __syncthreads();                // s_first of the last round is read
      if (tid == 0) s_first = kNone;
      __syncthreads();
      if (local != kNone) atomicMin(&s_first, local);
      __syncthreads();
      const int first = s_first;
      const int end = first == kNone ? tend : t0 + first;
#pragma unroll
      for (int r = 0; r < kHeadsPerThread; ++r) {
        const int j = t0 + r * kThreads + tid;
        if (j >= start && j < end) skip[j] = 1;
      }
      if (first == kNone) break;      // the tile is done
      const int jm = t0 + first;
      if (tid == 0) skip[jm] = 0;
      const float* src = rows + static_cast<int64_t>(jm) * k;
      for (int i = tid; i < k; i += kThreads) row[i] = __ldg(src + i);
      __syncthreads();
      for (int c = tid; c < 2 * k; c += kThreads) {
        float v;
        int rank;
        if (c < k) {                  // a heap value: row values > it first
          v = heap[c];
          rank = c + count_before(row, k, v, false);
        } else {                      // a row value: heap values >= it first
          v = row[c - k];
          rank = (c - k) + count_before(heap, k, v, true);
        }
        if (rank < k) next[rank] = v;
      }
      __syncthreads();
      float* t = heap;
      heap = next;
      next = t;
      h = heap[k - 1];
      start = jm + 1;
    }
  }
  for (int i = tid; i < k; i += kThreads) heap_out[i] = heap[i];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `skip` and `heap` and checks shapes; nothing is
// allocated here and nothing is synchronised.
extern "C" int topk_boundary_launch(const void* rows, float b_init,
                                    void* skip, void* heap, int P, int k,
                                    void* stream) {
  if (k <= 0 || k > kMaxK || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * k * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      topk_boundary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_boundary_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), b_init, static_cast<int32_t*>(skip),
      static_cast<float*>(heap), P, k);
  return static_cast<int>(cudaGetLastError());
}
