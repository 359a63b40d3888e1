// Batched top-k boundary initialisation on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/topk_boundary.py
// (topk_init_batched, body _topk_init_kernel): for each of Q queries, the
// k largest values among the rows of its candidate partitions in the
// resident block-top-k plane, [Pc, K] f32, each row sorted descending and
// padded with -inf (core/device_stats.py).  The result is heap [Q, k],
// descending, -inf padded; it is a value multiset, so ties need no order.
// Candidates come as CSR: query q's partition ids are
// ids[offsets[q] : offsets[q + 1]] (a repeated id counts twice).  The
// plane holds no NaN.
//
// The TPU kernel merges every row into every query's heap with an
// all-pairs rank selection over a dense [P, Q] mask.  Here the work
// rests on one threshold a query.  Let t be the k-th largest row head
// among query q's n candidates (t = -inf when n < k).  Rows are sorted,
// so k values >= t exist and t <= the answer's k-th value; fewer than k
// rows have a head > t, and only they hold values > t.  The heap is the
// values > t of those rows, descending, then t up to k.  Exact under any
// ties: values equal to t are counted, never stored.
//
// What bounds it on the card: memory.  Each candidate costs its id and
// its row head, a gathered 4-byte value that moves a 32-byte sector; the
// rest is a few passes over 4-byte keys.  The design, one wrapper call,
// six launches:
//   1. grid (Q, S): block (q, s) walks slab s of query q's list, loads
//      the id and the head, writes the head's order-preserving uint32 key
//      to keys[] (coalesced) and counts its top byte in a 256-bin shared
//      histogram (warp-aggregated atomics: heads tie heavily), merged
//      into the query's global histogram by atomics;
//   2-4. the same over keys[] for bytes 2, 3 and 4, counting only keys
//      whose higher bytes equal the prefix chosen so far;
//      after each pass the query's last block (a ticket from an atomic
//      counter, after a __threadfence) picks the byte of the k-th largest
//      key from the histogram and clears it: a radix select, 4 passes;
//   5. grid (Q, S): the keys above t append their row ids to the query's
//      list (fewer than k);
//   6. grid Q: one block gathers those rows' values above t (at most
//      (k - 1) * min(K, k)), sorts them by a bitonic sort in shared
//      memory and writes the heap, padded with t.
// No per-thread list of k values and no k-round merge: a candidate costs
// one id and one head load, then 4-byte key reads.
//
// Workspace (int32, zeroed by the caller), per query: the histogram, the
// select state and the list of rows above t; keys[nnz] uint32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // scan passes
constexpr int kBins = 256;         // one byte of the key a pass
constexpr int kSortThreads = 512;  // the last kernel's block
constexpr int kMaxK = 128;
// per-query workspace: hist [kBins], then the state words, then rows [k]
constexpr int kPrefix = kBins;     // the key bits chosen so far
constexpr int kRank = kBins + 1;   // rank of t among keys with that prefix
constexpr int kDone = kBins + 2;   // 1: prefix is t's whole key
constexpr int kTicket = kBins + 3; // blocks of the query done with a pass
constexpr int kRows = kBins + 4;   // rows gathered above t
constexpr int kHeader = kBins + 8;

__device__ __forceinline__ uint32_t key_of(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;    // -0.0 keys as +0.0: they compare equal
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ void slab_range(const int64_t* offsets, int q,
                                           int S, int64_t& lo,
                                           int64_t& hi) {
  const int64_t begin = offsets[q];
  const int64_t n = offsets[q + 1] - begin;
  const int64_t chunk = (n + S - 1) / S;
  lo = begin + static_cast<int64_t>(blockIdx.y) * chunk;
  hi = min(begin + n, lo + chunk);
}

// Count `bin` (kBins: nothing) once per warp and bin.  Every lane of the
// warp calls it.
__device__ __forceinline__ void count(unsigned int* hist, unsigned int bin) {
  const unsigned int peers = __match_any_sync(0xffffffffu, bin);
  if (bin < kBins && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + bin, static_cast<unsigned int>(__popc(peers)));
}

// After a pass: merge the block's histogram into the query's, and let the
// query's last block pick the next byte of t's key.  pass 0 takes the
// top byte with rank k; n < k ends the search at t = -inf.
__device__ void merge_and_select(unsigned int* s_hist, int* w, int pass,
                                 int k, int64_t n, int S) {
  __shared__ unsigned int s_scan[kBins];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads)
    if (s_hist[b]) atomicAdd(reinterpret_cast<unsigned int*>(w) + b,
                             s_hist[b]);
  __threadfence();                 // the counts, then the ticket
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(w + kTicket, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (pass == 0 && n < k) {        // fewer than k rows: t = -inf
    if (tid == 0) {
      w[kPrefix] = static_cast<int>(key_of(-CUDART_INF_F));
      w[kDone] = 1;
    }
    for (int b = tid; b < kBins; b += kThreads) w[b] = 0;
    if (tid == 0) w[kTicket] = 0;
    return;
  }
  const int rank = pass == 0 ? k : __ldcg(w + kRank);
  // s_scan[b] = keys in bins >= b (an inclusive scan from the top)
  const unsigned int h = __ldcg(reinterpret_cast<unsigned int*>(w) + tid);
  s_scan[tid] = h;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {
    const unsigned int add = tid + off < kBins ? s_scan[tid + off] : 0u;
    __syncthreads();
    s_scan[tid] += add;
    __syncthreads();
  }
  const unsigned int above = s_scan[tid] - h;
  if (above < static_cast<unsigned int>(rank) &&
      s_scan[tid] >= static_cast<unsigned int>(rank)) {
    const int shift = 24 - 8 * pass;
    const uint32_t prefix = pass == 0 ? 0u : static_cast<uint32_t>(
        __ldcg(w + kPrefix));
    w[kPrefix] = static_cast<int>(prefix | (static_cast<uint32_t>(tid)
                                            << shift));
    w[kRank] = rank - static_cast<int>(above);
    if (pass == 3) w[kDone] = 1;
  }
  w[tid] = 0;                      // the histogram, cleared for the next pass
  if (tid == 0) w[kTicket] = 0;
}

// Pass 0: ids and heads in, keys out, top bytes counted.
__global__ void __launch_bounds__(kThreads) first_pass(
    const float* __restrict__ plane, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ ids, uint32_t* __restrict__ keys,
    int* __restrict__ work, int K, int k, int S) {
  __shared__ unsigned int s_hist[kBins];
  const int q = blockIdx.x;
  for (int b = threadIdx.x; b < kBins; b += kThreads) s_hist[b] = 0;
  __syncthreads();
  int64_t lo, hi;
  slab_range(offsets, q, S, lo, hi);
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    unsigned int bin = kBins;
    if (r < hi) {
      const uint32_t key = key_of(
          __ldg(plane + static_cast<int64_t>(__ldg(ids + r)) * K));
      keys[r] = key;
      bin = key >> 24;
    }
    count(s_hist, bin);
  }
  merge_and_select(s_hist, work + static_cast<int64_t>(q) * (kHeader + k), 0,
                   k, offsets[q + 1] - offsets[q], S);
}

// Passes 1-3: the next byte of the keys that match the prefix.
__global__ void __launch_bounds__(kThreads) next_pass(
    const int64_t* __restrict__ offsets, const uint32_t* __restrict__ keys,
    int* __restrict__ work, int k, int S, int pass) {
  __shared__ unsigned int s_hist[kBins];
  const int q = blockIdx.x;
  int* w = work + static_cast<int64_t>(q) * (kHeader + k);
  if (w[kDone]) return;            // every block of the query returns
  for (int b = threadIdx.x; b < kBins; b += kThreads) s_hist[b] = 0;
  __syncthreads();
  const uint32_t prefix = static_cast<uint32_t>(w[kPrefix]);
  const uint32_t high = ~0u << (32 - 8 * pass);
  const int shift = 24 - 8 * pass;
  int64_t lo, hi;
  slab_range(offsets, q, S, lo, hi);
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    unsigned int bin = kBins;
    if (r < hi) {
      const uint32_t key = keys[r];
      if ((key & high) == prefix) bin = (key >> shift) & 0xffu;
    }
    count(s_hist, bin);
  }
  merge_and_select(s_hist, w, pass, k, offsets[q + 1] - offsets[q], S);
}

// Pass 4: the rows whose key is above t's append their ids.
__global__ void __launch_bounds__(kThreads) gather_rows(
    const int64_t* __restrict__ offsets, const int32_t* __restrict__ ids,
    const uint32_t* __restrict__ keys, int* __restrict__ work, int k,
    int S) {
  const int q = blockIdx.x;
  int* w = work + static_cast<int64_t>(q) * (kHeader + k);
  const uint32_t t = static_cast<uint32_t>(w[kPrefix]);
  int64_t lo, hi;
  slab_range(offsets, q, S, lo, hi);
  for (int64_t r = lo + threadIdx.x; r < hi; r += kThreads) {
    if (keys[r] > t) {
      const int slot = atomicAdd(w + kRows, 1);
      if (slot < k) w[kHeader + slot] = __ldg(ids + r);
    }
  }
}

// Last: the values above t of the gathered rows, sorted; t pads the heap.
__global__ void __launch_bounds__(kSortThreads) write_heap(
    const float* __restrict__ plane, const int* __restrict__ work,
    float* __restrict__ heap, int K, int k) {
  extern __shared__ float s_buf[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int* w = work + static_cast<int64_t>(q) * (kHeader + k);
  const float t = value_of(static_cast<uint32_t>(w[kPrefix]));
  const int rows = min(w[kRows], k - 1 > 0 ? k - 1 : 0);
  const int kk = min(K, k);        // a row's values past the k-th never enter
  const int total = rows * kk;
  int m = 1;
  while (m < total) m <<= 1;
  for (int i = tid; i < m; i += kSortThreads) {
    float v = -CUDART_INF_F;
    if (i < total) {
      const int row = w[kHeader + i / kk];
      v = __ldg(plane + static_cast<int64_t>(row) * K + i % kk);
      if (!(v > t)) v = -CUDART_INF_F;
    }
    s_buf[i] = v;
  }
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (m >> 1); i += kSortThreads) {
        const int a = 2 * stride * (i / stride) + (i % stride);
        const int b = a + stride;
        const float va = s_buf[a], vb = s_buf[b];
        const bool desc = (a & size) == 0;
        if (desc ? va < vb : va > vb) {
          s_buf[a] = vb;
          s_buf[b] = va;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kSortThreads) {
    const float v = i < total ? s_buf[i] : -CUDART_INF_F;
    heap[static_cast<int64_t>(q) * k + i] = v > t ? v : t;
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).  The
// caller allocates `heap` [Q, k] f32, `keys` [nnz] uint32 and `work`
// [Q, k + 264] int32, zeroed, and checks shapes; nothing is allocated
// here and nothing is synchronised.  S is the number of slabs a query's
// list is cut into for the scan passes (grid.y, at most 65535).
extern "C" int topk_init_batched_launch(
    const void* plane, const void* offsets, const void* ids, void* heap,
    void* keys, void* work, int Q, int K, int k, int S, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || k <= 0 || k > kMaxK || S <= 0 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pl = static_cast<const float*>(plane);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int32_t* id = static_cast<const int32_t*>(ids);
  uint32_t* ky = static_cast<uint32_t*>(keys);
  int* wk = static_cast<int*>(work);
  const dim3 grid(static_cast<unsigned int>(Q), static_cast<unsigned int>(S));
  first_pass<<<grid, kThreads, 0, st>>>(pl, off, id, ky, wk, K, k, S);
  cudaError_t err = cudaGetLastError();
  for (int pass = 1; pass < 4 && err == cudaSuccess; ++pass) {
    next_pass<<<grid, kThreads, 0, st>>>(off, ky, wk, k, S, pass);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows<<<grid, kThreads, 0, st>>>(off, id, ky, wk, k, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (k - 1) rows of at most min(K, k) values, to a power of two
  const int most = (k - 1) * (K < k ? K : k);
  int m = 1;
  while (m < most) m <<= 1;
  const int smem = m * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(write_heap,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  write_heap<<<static_cast<unsigned int>(Q), kSortThreads, smem, st>>>(
      pl, wk, static_cast<float*>(heap), K, k);
  return static_cast<int>(cudaGetLastError());
}
