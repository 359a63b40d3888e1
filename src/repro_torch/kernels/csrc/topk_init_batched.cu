// Batched top-k boundary initialisation on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/topk_boundary.py
// (topk_init_batched, body _topk_init_kernel): for each of Q queries, the
// k largest values among the rows of its candidate partitions in the
// resident block-top-k plane, [Pc, K] f32, each row sorted descending and
// padded with -inf (core/device_stats.py).  The result is heap [Q, k],
// descending, -inf padded; it is a value multiset, so ties need no order.
// Candidates come as CSR: query q's partition ids are
// ids[offsets[q] : offsets[q + 1]].  The plane holds no NaN.
//
// The TPU kernel merges every row into every query's heap with an
// all-pairs rank selection, O((k + K)^2) per row, over a dense [P, Q]
// mask.  Here the work follows the candidates:
//   * grid (S, Q): block (s, q) takes slab s of query q's candidate list;
//     each thread walks its share of the slab's rows and keeps its own
//     descending top-k list in shared memory (element i of thread t at
//     i * kThreads + t, so a warp's accesses fall in distinct banks);
//   * rows are sorted, so a thread stops reading a row at its first value
//     that cannot enter its list (<= its current k-th, or -inf): most
//     rows cost one load once the lists fill;
//   * the block merges its threads' lists by k rounds of a block-wide
//     argmax over the list heads and writes the slab's top-k to scratch;
//     the last block of a query to finish (a ticket from an atomic
//     counter, after a __threadfence) merges the S slab lists the same
//     way into heap[q].  One launch, no second pass.
// A value that is not larger than the k-th of some list it would enter
// cannot change the top-k multiset of the union, so every early stop
// above is exact.
//
// What bounds it on the card: memory.  The least traffic is the candidate
// ids (4 bytes each) and the first value of every candidate row; the
// merges run in shared memory and registers.
//
// Shared memory: k * kThreads * 4 bytes of lists, 64 KB at k = 128, over
// the 48 KB static limit: the launch opts in to dynamic shared memory
// with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kMaxSlabs = kThreads;   // the final merge gives a thread a slab

__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// Thread t owns a descending list of `cnt` values at list[i * stride],
// i < cnt (cnt may be 0).  Writes the k largest values of the union to
// out[0..k), descending, -inf padded.  Every thread of the block calls it.
__device__ void merge_lists(const float* list, int stride, int cnt, int k,
                            float* out) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_win_val;
  __shared__ int s_win;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float v = head < cnt ? list[head * stride] : -CUDART_INF_F;
    int idx = tid;
    warp_argmax(v, idx);
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? s_val[lane] : -CUDART_INF_F;
      idx = lane < kWarps ? s_idx[lane] : 0x7fffffff;
      warp_argmax(v, idx);
      if (lane == 0) {
        s_win_val = v;
        s_win = idx;
        out[r] = v;
      }
    }
    __syncthreads();
    const float wv = s_win_val;
    if (!(wv > -CUDART_INF_F)) {          // every list is exhausted
      if (tid == 0)
        for (int i = r + 1; i < k; ++i) out[i] = -CUDART_INF_F;
      break;
    }
    if (tid == s_win) ++head;
  }
}

__global__ void topk_init_batched_kernel(
    const float* __restrict__ plane,       // [Pc, K]
    const int64_t* __restrict__ offsets,   // [Q + 1]
    const int32_t* __restrict__ ids,       // [offsets[Q]]
    float* __restrict__ heap,              // [Q, k]
    float* scratch,                        // [Q, S, k] slab lists
    unsigned int* tickets,                 // [Q], zero at launch
    int K, int k, int S) {
  extern __shared__ float s_list[];        // [k][kThreads]
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int q = blockIdx.y;
  const int64_t begin = offsets[q];
  const int64_t n = offsets[q + 1] - begin;
  const int64_t chunk = (n + S - 1) / S;
  const int64_t lo = begin + s * chunk;
  const int64_t hi = min(begin + n, lo + chunk);

  float* mine = s_list + tid;
  int cnt = 0;
  float kth = -CUDART_INF_F;
  for (int64_t r = lo + tid; r < hi; r += kThreads) {
    const float* row = plane + static_cast<int64_t>(ids[r]) * K;
    for (int j = 0; j < K; ++j) {
      const float v = __ldg(row + j);
      if (!(v > -CUDART_INF_F)) break;      // -inf: the row's padding
      if (cnt == k && !(v > kth)) break;    // sorted row: nothing enters
      int pos = cnt < k ? cnt : k - 1;
      while (pos > 0 && mine[(pos - 1) * kThreads] < v) {
        mine[pos * kThreads] = mine[(pos - 1) * kThreads];
        --pos;
      }
      mine[pos * kThreads] = v;
      if (cnt < k) ++cnt;
      if (cnt == k) kth = mine[(k - 1) * kThreads];
    }
  }
  __syncthreads();
  float* slab = scratch + (static_cast<int64_t>(q) * S + s) * k;
  merge_lists(mine, kThreads, cnt, k, slab);
  if (tid == 0) {
    __threadfence();                       // the slab list, then the ticket
    s_last = atomicAdd(tickets + q, 1u) == static_cast<unsigned int>(S - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of query q merges the S slab lists; thread t owns list t
  const float* lists = scratch + static_cast<int64_t>(q) * S * k;
  merge_lists(lists + static_cast<int64_t>(tid) * k, 1, tid < S ? k : 0, k,
              heap + static_cast<int64_t>(q) * k);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `heap`, `scratch` ([Q, S, k] f32) and `tickets` ([Q]
// uint32, zeroed) and checks shapes; nothing is allocated here and nothing
// is synchronised.
extern "C" int topk_init_batched_launch(
    const void* plane, const void* offsets, const void* ids, void* heap,
    void* scratch, void* tickets, int Q, int K, int k, int S, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || k <= 0 || k > kMaxK || S <= 0 || S > kMaxSlabs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = k * kThreads * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      topk_init_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // grid.y holds at most 65535 queries: longer batches go in chunks
  for (int q0 = 0; q0 < Q; q0 += 65535) {
    const int nq = Q - q0 < 65535 ? Q - q0 : 65535;
    topk_init_batched_kernel<<<dim3(S, nq), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(plane),
        static_cast<const int64_t*>(offsets) + q0,
        static_cast<const int32_t*>(ids),
        static_cast<float*>(heap) + static_cast<int64_t>(q0) * k,
        static_cast<float*>(scratch) + static_cast<int64_t>(q0) * S * k,
        static_cast<unsigned int*>(tickets) + q0, K, k, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
