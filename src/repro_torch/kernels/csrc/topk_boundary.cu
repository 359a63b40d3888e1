// Top-k boundary scan on Hopper (sm_90a), on every SM.
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
// The carry is sequential, but the scan is exact on tiles.  A row skipped
// while the heap is full holds only values <= H (its head is <= H), so
// merging it would change no value of the heap; a row whose head is below
// B is always skipped.  So the heap before row j is the top-k of the rows
// i < j with head >= B, equal values in row order, whatever the scan
// skipped.  Three passes:
//   A. a block a tile of T rows runs the walk below from an empty heap;
//      its final heap, that top-k over the tile, goes to `work`;
//   B. the first n - 1 tile heaps become an inclusive scan, each pair
//      merged with the earlier list first, in two levels: a block a group
//      of about sqrt(n) consecutive heaps scans them in shared memory
//      (Hillis-Steele) and writes the group's total, then one block scans
//      the group totals;
//   C. a block a tile runs the walk again from the heap of the tiles
//      before it (its group's scanned heap merged behind the scanned
//      totals of the groups before), writing skip; the last tile's final
//      heap is the scan's.  Tile 0 starts from an empty heap, as in pass
//      A, so pass A's first block writes its skips and pass C starts at
//      tile 1.
// Every merge puts the earlier list's values first among equal values
// (-0.0 and +0.0 are equal), so skip and heap are the sequential scan's
// bit for bit (ref.topk_boundary_tiled_ref is this in plain torch).  With
// one tile (large k, small P) only pass C runs: the sequential scan in
// one block.
//
// The walk over a tile, in sub-tiles of kSub = 2048 rows, kPer
// consecutive rows a thread.  Between two merges the heap does not change,
// and the skip test is one threshold over the heads that only rises:
//   * the sub-tile's heads sit in registers; pass A reads each from its
//     row (one 32-byte sector a head; a warp's loads on 32 consecutive
//     rows, the next sub-tile's in flight during this one's walk, turned
//     to consecutive rows a thread in shared memory) and writes them to a
//     compact [P] array in `work`, which pass C reads 32 bytes a thread;
//   * a round counts the rows not skipped under the heap as it is, takes
//     the first m (<= kMaxStage) of them in order (a block scan of the
//     per-thread counts) and loads their rows into shared memory behind
//     the heap: one trip to memory for up to m merges;
//   * by the same argument as for tiles, the heap before staged row c is
//     the top-k of the heap and the staged rows before c, so row c is
//     skipped iff its head is below B or at least k of those values are
//     >= its head (at least k finite ones, for a -inf head): counted by
//     binary searches, all pairs at once, where merging one row at a
//     time is a chain of barriers a merge;
//   * the heap after the round is the top-k of the heap and every staged
//     row, merged in a tree of log2(m + 1) levels;
//   * the next round starts after the last staged row.
//
// What bounds it on the card: the heads (sectors in pass A), the merged
// rows and the skips, 0.011 ms at P = 2**20, k = 25.  The head sectors,
// one every 100 bytes at k = 25, come at ~0.85 TB/s on an H100, so pass
// A's reads set the pace (tools/per_query_variants.py).
//
// Shared memory (dynamic): walk_floats(k): the heap, the tree's first
// list, m staged rows and the tree's second buffer, at most 192 KB (k =
// kMaxK, m = 1: the heap, the row and the merge target); a pass B block
// holds two copies of its group's heaps, at most kScanFloats floats each.
// A single block scanning all 255 heaps of P = 2**20, k = 25 doubled the
// scan's time on an H100 (its merges on one SM): hence two levels.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // walk: threads a block
constexpr int kPer = 8;                 // consecutive rows a thread
constexpr int kSub = kThreads * kPer;   // rows a sub-tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStage = 32;           // rows staged at once, at most,
constexpr int kStageFloats = 8192;      // and floats staged, at most
constexpr int kMaxK = 16384;
constexpr int kScanThreads = 1024;
constexpr int kScanFloats = 24576;      // n - 1 tile heaps of pass B
static_assert(kPer == 8, "a thread's skips go out as two int4");

__host__ __device__ __forceinline__ int stage_rows(int k) {
  const int m = kStageFloats / k;
  return m < 1 ? 1 : (m > kMaxStage ? kMaxStage : m);
}

// Dynamic shared memory of the walk, in floats: the heap, the merge
// target and the staged rows, and with m >= 2 room for the first level
// of reduce_lists over [heap, m rows].
__host__ __device__ __forceinline__ int walk_floats(int k) {
  const int m = stage_rows(k);
  return (2 + m + (m >= 2 ? (m + 2) / 2 : 0)) * k;
}

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

// One merge-path candidate: c < k is a[c], else b[c - k]; writes it to
// out at its rank if that is below k.  a is the earlier list: its values
// go first among equal values.
__device__ __forceinline__ void merge_one(const float* a, const float* b,
                                          float* out, int k, int c) {
  float v;
  int rank;
  if (c < k) {
    v = a[c];
    rank = c + count_before(b, k, v, false);
  } else {
    v = b[c - k];
    rank = (c - k) + count_before(a, k, v, true);
  }
  if (rank < k) out[rank] = v;
}

__device__ __forceinline__ bool skipped(float head, float h, float b_init) {
  const bool full = h > -CUDART_INF_F;
  return (head < fmaxf(b_init, full ? h : -CUDART_INF_F)) |
         (full & (head <= h));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Top-k of the cnt >= 2 lists [cnt, k] at `x`, merged pairwise level by
// level (the earlier list first), ping-ponging with `y` (room for
// ceil(cnt / 2) lists); returns the buffer holding the one list left.
// Every thread of the block calls it; it ends with a barrier.
__device__ float* reduce_lists(float* x, float* y, int cnt, int k) {
  while (cnt > 1) {
    const int pairs = cnt >> 1;
    for (int e = threadIdx.x; e < pairs * 2 * k; e += kThreads) {
      const int p = e / (2 * k);
      merge_one(x + 2 * p * k, x + (2 * p + 1) * k, y + p * k, k,
                e - p * 2 * k);
    }
    if (cnt & 1)
      for (int i = threadIdx.x; i < k; i += kThreads)
        y[pairs * k + i] = x[(cnt - 1) * k + i];
    __syncthreads();
    float* tmp = x;
    x = y;
    y = tmp;
    cnt = pairs + (cnt & 1);
  }
  return x;
}

// Passes A (kReplay false) and C (true); a block per tile of T rows.  Pass
// A's first block walks tile 0 as pass C would (from an empty heap) and
// writes its skips, so pass C starts at tile `first` (1 when n > 1).
template <bool kReplay>
__global__ void __launch_bounds__(kThreads) walk_kernel(
    const float* __restrict__ rows,   // [P, k]
    float b_init,
    float* __restrict__ tile_heaps,   // [n, k]: A writes, C reads list t-1
    const float* __restrict__ totals, // [groups, k] scanned group totals
    int group,                        // heaps a pass B group (C)
    float* __restrict__ heads,        // [P] compact heads (if compact)
    int compact,                      // A writes them, C reads them
    int32_t* __restrict__ skip,       // [P] (C, and A for tile 0)
    float* __restrict__ heap_out,     // [k] (C, last tile)
    int P, int k, int T, int first) {
  // heap [k], next [k], stage [m][k], reduce_lists' second buffer
  extern __shared__ float s_mem[];
  __shared__ int s_idx[kMaxStage];
  __shared__ int s_warp[2][kWarps];
  __shared__ uint32_t s_merged[kSub / 32];
  __shared__ float4 s_heads[kSub / 4];
  __shared__ int s_cnt[kMaxStage];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m = stage_rows(k);
  float* heap = s_mem;
  float* next = s_mem + k;
  float* stage = s_mem + 2 * k;
  float* spare = stage + m * k;
  const int t = blockIdx.x + first;
  // skips are written by pass C and, for tile 0, by pass A; pass A's other
  // tiles need only their heap
  const bool replay = kReplay || t == 0;
  const int64_t r0 = static_cast<int64_t>(t) * T;
  const int64_t r1 = r0 + T < P ? r0 + T : static_cast<int64_t>(P);
  // the heap before the tile: pass B's list t - 1 (tiles up to t - 1 of
  // its group) merged behind the scanned totals of the groups before
  const int g = kReplay && t > 0 ? (t - 1) / group : 0;
  const float* local = tile_heaps + static_cast<int64_t>(t - 1) * k;
  for (int i = tid; i < k; i += kThreads) {
    if (!kReplay || t == 0) {
      heap[i] = -CUDART_INF_F;
    } else if (g == 0) {
      heap[i] = local[i];
    } else {
      next[i] = totals[static_cast<int64_t>(g - 1) * k + i];
      stage[i] = local[i];
    }
  }
  __syncthreads();
  if (g > 0) {
    for (int c = tid; c < 2 * k; c += kThreads)
      merge_one(next, stage, heap, k, c);
    __syncthreads();
  }
  float h = heap[k - 1];              // the same in every thread
  int parity = 0;

  // Heads from the rows (pass A, or pass C without the compact array):
  // a warp's loads read 32 consecutive rows' heads, the next sub-tile's
  // are in flight while this one is walked, and shared memory turns them
  // to kPer consecutive rows a thread.
  const bool from_rows = !kReplay || !compact;
  // the sub-tile row of this thread's r-th head load
  auto hrow = [&](int r) { return r * kThreads + tid; };
  float pre[kPer];
  auto prefetch = [&](int64_t s0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int64_t j = s0 + hrow(r);
      pre[r] = j < r1 ? __ldg(rows + j * k) : -CUDART_INF_F;
    }
  };
  if (from_rows) prefetch(r0);

  for (int64_t t0 = r0; t0 < r1; t0 += kSub) {
    const int n_sub = r1 - t0 < kSub ? static_cast<int>(r1 - t0) : kSub;
    const int base = tid * kPer;      // my first row, from t0
    const int mine = n_sub - base < kPer ? (n_sub - base > 0 ? n_sub - base
                                                             : 0)
                                         : kPer;
    float head[kPer];
    if (from_rows) {
      // the last sub-tile's heads were read before its walk's first
      // barrier, so s_heads is free
      float* sh = reinterpret_cast<float*>(s_heads);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        sh[hrow(r)] = pre[r];
        if (!kReplay && compact && hrow(r) < n_sub)
          heads[t0 + hrow(r)] = pre[r];
      }
      __syncthreads();
      const float4 a = s_heads[2 * tid];
      const float4 b = s_heads[2 * tid + 1];
      head[0] = a.x; head[1] = a.y; head[2] = a.z; head[3] = a.w;
      head[4] = b.x; head[5] = b.y; head[6] = b.z; head[7] = b.w;
      if (t0 + kSub < r1) prefetch(t0 + kSub);
    } else {
      const float* hsrc = heads + t0 + base;
      if (mine == kPer && aligned16(hsrc)) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(hsrc));
        const float4 b = __ldg(reinterpret_cast<const float4*>(hsrc) + 1);
        head[0] = a.x; head[1] = a.y; head[2] = a.z; head[3] = a.w;
        head[4] = b.x; head[5] = b.y; head[6] = b.z; head[7] = b.w;
      } else {
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          head[r] = r < mine ? __ldg(hsrc + r) : -CUDART_INF_F;
      }
    }
    if (replay)
      for (int i = tid; i < kSub / 32; i += kThreads) s_merged[i] = 0;
    // s_merged is cleared before the first scan's barrier below

    int start = 0;                    // rows before it are decided
    while (true) {
      unsigned int mask = 0;          // my rows not skipped as the heap is
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (base + r >= start && r < mine && !skipped(head[r], h, b_init))
          mask |= 1u << r;
      const int cnt = __popc(mask);
      int x = cnt;                    // inclusive scan over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) s_warp[parity][warp] = x;
      __syncthreads();
      int before = x - cnt, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int s = s_warp[parity][w];
        if (w < warp) before += s;
        total += s;
      }
      parity ^= 1;                    // the other copy next round: no
                                      // barrier between read and rewrite
      if (total == 0) break;          // the rest of the sub-tile skips
      const int ms = total < m ? total : m;
      for (unsigned int mm = mask; mm && before < ms; mm &= mm - 1)
        s_idx[before++] = base + __ffs(mm) - 1;
      if (replay)
        for (int c = tid; c < ms; c += kThreads) s_cnt[c] = 0;
      __syncthreads();
      for (int e = tid; e < ms * k; e += kThreads) {
        const int c = e / k;
        stage[e] = __ldg(rows + (t0 + s_idx[c]) * k + (e - c * k));
      }
      if (ms >= 2)                    // [heap, staged rows], contiguous
        for (int i = tid; i < k; i += kThreads) next[i] = heap[i];
      __syncthreads();
      if (replay) {
        // Staged row c is skipped iff its head is below b_init or the heap
        // before it is full with k-th value >= its head: at least k values
        // >= the head (finite values, for a -inf head) among the heap and
        // the staged rows before c.  A pair (c, j <= c) counts list j (0:
        // the heap, else staged row j - 1) against head c.
        for (int e = tid; e < ms * (ms + 1) / 2; e += kThreads) {
          int c = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
          while (c * (c + 1) / 2 > e) --c;
          while ((c + 1) * (c + 2) / 2 <= e) ++c;
          const int j = e - c * (c + 1) / 2;
          const float hd = stage[c * k];
          const float* list = j == 0 ? heap : stage + (j - 1) * k;
          atomicAdd(&s_cnt[c], hd == -CUDART_INF_F
                                   ? count_before(list, k, hd, false)
                                   : count_before(list, k, hd, true));
        }
        __syncthreads();
        for (int c = tid; c < ms; c += kThreads)
          if (!(stage[c * k] < b_init || s_cnt[c] >= k))
            atomicOr(&s_merged[s_idx[c] >> 5], 1u << (s_idx[c] & 31));
      }
      // the heap after the staged rows: all of them merged, in a tree of
      // log2(ms + 1) levels (a row the scan skips changes no bit of it)
      if (ms == 1) {
        for (int c = tid; c < 2 * k; c += kThreads)
          merge_one(heap, stage, next, k, c);
        __syncthreads();
        for (int i = tid; i < k; i += kThreads) heap[i] = next[i];
      } else {
        const float* top = reduce_lists(next, spare, ms + 1, k);
        for (int i = tid; i < k; i += kThreads) heap[i] = top[i];
      }
      __syncthreads();
      h = heap[k - 1];
      start = s_idx[ms - 1] + 1;
    }
    if (replay) {
      __syncthreads();                // every merged bit is set
      const uint32_t bits = (s_merged[base >> 5] >> (base & 31)) & 0xffu;
      int32_t* dst = skip + t0 + base;
      int s[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) s[r] = ((bits >> r) & 1u) ? 0 : 1;
      if (mine == kPer && aligned16(dst)) {
        reinterpret_cast<int4*>(dst)[0] = make_int4(s[0], s[1], s[2], s[3]);
        reinterpret_cast<int4*>(dst)[1] = make_int4(s[4], s[5], s[6], s[7]);
      } else {
        for (int r = 0; r < mine; ++r) dst[r] = s[r];
      }
      __syncthreads();                // s_merged is read before it clears
    }
  }
  if (!kReplay) {
    for (int i = tid; i < k; i += kThreads)
      tile_heaps[static_cast<int64_t>(t) * k + i] = heap[i];
  } else if (t == first + static_cast<int>(gridDim.x) - 1) {
    for (int i = tid; i < k; i += kThreads) heap_out[i] = heap[i];
  }
}

// Inclusive Hillis-Steele scan of the m lists [m, k] at `cur` (shared
// memory, kN threads), list i becoming the top-k of lists 0..i with the
// earlier list first in every merge; `nxt` is a second buffer of [m, k].
// Returns the buffer that holds the scan; ends with a barrier.
template <int kN>
__device__ float* scan_lists(float* cur, float* nxt, int m, int k) {
  for (int d = 1; d < m; d <<= 1) {
    for (int e = threadIdx.x; e < 2 * m * k; e += kN) {
      const int i = e / (2 * k);
      const int c = e - i * 2 * k;
      if (i >= d) {
        merge_one(cur + (i - d) * k, cur + i * k, nxt + i * k, k, c);
      } else if (c < k) {
        nxt[i * k + c] = cur[i * k + c];
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// Pass B: block g takes lists [g * group, g * group + m) of [n, k] and
// turns them into their inclusive scan, list i the top-k of the group's
// lists up to i (scan_lists).  With `totals`, its last list (the group's
// total) also goes to totals[g].
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    float* __restrict__ all, float* __restrict__ totals, int n, int k,
    int group) {
  extern __shared__ float s_mem[];    // two copies of [m, k]
  const int first = blockIdx.x * group;
  const int m = n - first < group ? n - first : group;
  float* lists = all + static_cast<int64_t>(first) * k;
  const int nk = m * k;
  for (int e = threadIdx.x; e < nk; e += kScanThreads) s_mem[e] = lists[e];
  __syncthreads();
  const float* cur = scan_lists<kScanThreads>(s_mem, s_mem + nk, m, k);
  for (int e = threadIdx.x; e < nk; e += kScanThreads) lists[e] = cur[e];
  if (totals != nullptr)
    for (int i = threadIdx.x; i < k; i += kScanThreads)
      totals[static_cast<int64_t>(blockIdx.x) * k + i] = cur[nk - k + i];
}

// Heaps a pass B group for m heaps: about sqrt(m), so that both levels
// are short.
int scan_group(int m) {
  int g = 1;
  while (g * g < m) ++g;
  return (m + g - 1) / g;
}

cudaError_t allow_smem() {
  static bool done = false;           // the attributes persist
  if (done) return cudaSuccess;
  const int walk = 3 * kMaxK * static_cast<int>(sizeof(float));
  const int scan = 2 * kScanFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, walk);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, walk);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scan);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).  The
// caller allocates `skip`, `heap` and `work`: 2 * n * k floats of tile
// heaps and group totals, n = ceil(P / T), then (n > 1) P floats of
// compact heads; nothing is allocated here and nothing is
// synchronised.  (n - 1) * k must not pass kScanFloats.
extern "C" int topk_boundary_launch(const void* rows, float b_init,
                                    void* skip, void* heap, void* work,
                                    int P, int k, int T,
                                    void* stream) {
  if (k <= 0 || k > kMaxK || P <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (static_cast<int64_t>(P) + T - 1) / T;
  if ((n - 1) * k > kScanFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = walk_floats(k) * static_cast<int>(sizeof(float));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  float* tile_heaps = static_cast<float*>(work);
  float* totals = tile_heaps + n * k;
  float* heads = totals + n * k;
  const int grid = static_cast<int>(n);
  const int use_heads = n > 1;              // pass A writes them
  const int m = static_cast<int>(n - 1);    // heaps pass B scans
  const int group = m > 1 ? scan_group(m) : 1;
  const int groups = m > 1 ? (m + group - 1) / group : 0;
  const int fsz = static_cast<int>(sizeof(float));
  if (n > 1) {
    walk_kernel<false><<<grid, kThreads, smem, s>>>(
        r, b_init, tile_heaps, nullptr, 1, heads, use_heads,
        static_cast<int32_t*>(skip), nullptr, P, k, T, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m > 1) {
    scan_kernel<<<groups, kScanThreads, 2 * group * k * fsz, s>>>(
        tile_heaps, totals, m, k, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (groups > 1) {
      scan_kernel<<<1, kScanThreads, 2 * groups * k * fsz, s>>>(
          totals, nullptr, groups, k, groups);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int first = n > 1 ? 1 : 0;          // pass A did tile 0
  walk_kernel<true><<<grid - first, kThreads, smem, s>>>(
      r, b_init, tile_heaps, totals, group, heads, use_heads,
      static_cast<int32_t*>(skip), static_cast<float*>(heap), P, k, T,
      first);
  return static_cast<int>(cudaGetLastError());
}
