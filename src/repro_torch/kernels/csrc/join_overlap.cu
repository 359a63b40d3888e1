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
// NaN-padded to its tiles).  Here the reference's searchsorted formulation
// is kept -- the first key at or above pmin[p] (a lower bound), tested
// against pmax[p] -- but only over the keys that can hit at all.  A binary
// search is right only on a sorted, NaN-free list; the wrapper
// (kernels/join_overlap.py) checks both before it launches.
//
// What bounds it on the card: memory.  The least traffic is the two f32
// interval rows (8 bytes a partition), the keys once and one int32
// verdict a partition.  The design (the batched kernel's, with one
// query):
//   * a block owns a tile of kTile = kThreads * kV partitions, and the
//     kernel keeps to 32 registers a thread so that 2,048 threads fit an
//     SM (P = 2**20 in one wave of 1,024 blocks); a thread
//     loads its kV consecutive bounds with 16-byte loads where the rows
//     allow (4-byte loads where P % 4 != 0 or a row is a view off 16
//     bytes) and writes its verdicts with 16-byte stores (4-byte ones
//     where the output row is off 16 bytes).  The grid holds the blocks
//     the card runs at once and strides over the tiles;
//   * the tile's key window: a key outside [min pmin, max pmax] of the
//     tile lies in no interval of it.  The block reduces the two bounds
//     (the empty sentinels (+inf, -inf) drop out by themselves) and two
//     warps find a = #keys < min pmin and b = #keys <= max pmax by 32-ary
//     searches; +inf keys against a +inf pmax stay exact (+inf <= +inf);
//   * an empty window (b <= a) stores the tile's zeros with no search;
//   * otherwise each warp narrows [a, b) to its own partitions' window (a
//     ballot where the window fits a warp's lanes, a 16-ary search by
//     each half-warp below kStageMin keys; a larger window, an
//     unclustered plane's, would narrow little and is searched whole),
//     stores zeros where that is empty, and searches only there: among
//     keys held one a lane by shuffles where it holds at most 32 keys,
//     else in memory by a branch-free bisection;
//   * a window of kStageMin to kStageKeys keys (an unclustered plane's) is
//     staged in shared memory by cp.async first; a smaller or a longer
//     one is searched in place through L1, so every D launches.
//
// Float semantics: build without --use_fast_math and without -ftz=true;
// the compares are IEEE f32, denormals included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads a block
constexpr int kV = 4;                  // consecutive partitions a thread
constexpr int kTile = kThreads * kV;   // partitions a block's tile
constexpr int kStageMin = 1024;        // keys a window needs to be staged
constexpr int kStageKeys = 4096;       // keys a staged window (0: none)
constexpr bool kWarpWindow = true;     // narrow to each warp's window
                                       // (below kStageMin keys)
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2048 / kThreads;   // a full SM: one wave
constexpr unsigned kAll = 0xffffffffu;
static_assert(kV == 4 || kV == 8 || kV == 16, "kV is 4, 8 or 16");
static_assert(kWarps >= 2, "two warps search the tile window");

__device__ __forceinline__ bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// x[e] = a[e] for e < n, `fill` beyond; 16-byte loads where it can.
__device__ __forceinline__ void load_v(const float* __restrict__ a, int n,
                                       float fill, float (&x)[kV]) {
  if (n == kV && aligned_to(a, 16)) {
#pragma unroll
    for (int j = 0; j < kV / 4; ++j) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(a) + j);
      x[4 * j] = t.x;
      x[4 * j + 1] = t.y;
      x[4 * j + 2] = t.z;
      x[4 * j + 3] = t.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) x[e] = e < n ? __ldg(a + e) : fill;
}

// a[e] = h[e] for e < n, 16-byte stores where it can.
__device__ __forceinline__ void store_v(int32_t* __restrict__ a, int n,
                                        const bool (&h)[kV]) {
  if (n == kV && aligned_to(a, 16)) {
#pragma unroll
    for (int j = 0; j < kV / 4; ++j)
      reinterpret_cast<int4*>(a)[j] = make_int4(h[4 * j], h[4 * j + 1],
                                                h[4 * j + 2], h[4 * j + 3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e)
    if (e < n) a[e] = h[e] ? 1 : 0;
}

// The number of keys[i], i < n, below x (strict) or at or below x, found
// by the kG lanes of one group together: a kG-ary search, ceil(log_kG(n +
// 1)) rounds of one load a lane.  Every lane of the warp calls it with the
// same n (the rounds depend on n alone).
template <int kG>
__device__ __forceinline__ int group_count(const float* keys, int n, float x,
                                           bool strict) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kG - 1);
  const int shift = lane & ~(kG - 1);
  const unsigned gmask = kG == 32 ? kAll : ((1u << kG) - 1u);
  int lo = 0;
  for (int r = n + 1; r > 1;) {        // the count is in [lo, lo + r)
    const int s = (r + kG - 1) / kG;
    const int pos = lo + (sub + 1) * s - 1;
    bool t = false;
    if (pos < n) {
      const float k = keys[pos];
      t = strict ? k < x : k <= x;
    }
    lo += __popc((__ballot_sync(kAll, t) >> shift) & gmask) * s;
    r = s;
  }
  return lo;
}

// h[e] for keys held one a lane (lane base + i holds key i, i < cnt):
// binary lifting for the first key at or above lo[e], by shuffles, then
// that key against hi[e].  Warp-uniform cnt >= 1.
__device__ __forceinline__ void search_lanes(float key, int base, int cnt,
                                             const float (&lo)[kV],
                                             const float (&hi)[kV],
                                             bool (&h)[kV]) {
  int f[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) f[e] = 0;
  for (int step = 1 << (31 - __clz(cnt)); step; step >>= 1) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int nxt = f[e] + step;
      const float k = __shfl_sync(kAll, key, (base + nxt - 1) & 31);
      if (nxt <= cnt && k < lo[e]) f[e] = nxt;
    }
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    const float k = __shfl_sync(kAll, key, (base + f[e]) & 31);
    h[e] = f[e] < cnt && k <= hi[e];
  }
}

// The same over keys[0, cnt) in memory (shared or global), kV searches
// interleaved: a branch-free bisection whose halves follow cnt, so every
// lane runs the same ceil(log2(cnt)) + 1 probes.  (Binary lifting, with
// its probes at multiples of powers of two, was timed 1.7x slower on a
// random plane: its hot keys crowd a few L1 sets.)
__device__ __forceinline__ void search_memory(const float* keys, int cnt,
                                              const float (&lo)[kV],
                                              const float (&hi)[kV],
                                              bool (&h)[kV]) {
  int f[kV];                           // the count below lo[e] is in
#pragma unroll                         // [f[e], f[e] + n]
  for (int e = 0; e < kV; ++e) f[e] = 0;
  for (int n = cnt; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int e = 0; e < kV; ++e)
      if (keys[f[e] + half - 1] < lo[e]) f[e] += half;
    n -= half;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    f[e] += keys[f[e]] < lo[e];
    const float k = keys[f[e] < cnt ? f[e] : cnt - 1];
    h[e] = f[e] < cnt && k <= hi[e];
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) join_overlap_kernel(
    const float* __restrict__ pmin,       // [P]
    const float* __restrict__ pmax,       // [P]
    const float* __restrict__ distinct,   // [D] sorted, no NaN
    int32_t* __restrict__ hit,            // [P]
    int D, int P) {
  __shared__ float s_red[2][kWarps];
  __shared__ int s_win[2];              // a, b
  __shared__ float s_keys[kStageKeys > 0 ? kStageKeys : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = static_cast<int>((static_cast<int64_t>(P) + kTile - 1) /
                                     kTile);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t p0 = static_cast<int64_t>(tile) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kV;
    const int n = P - p0 >= kV ? kV : (P > p0 ? static_cast<int>(P - p0) : 0);
    float lo[kV], hi[kV];
    load_v(pmin + p0, n, INFINITY, lo);
    load_v(pmax + p0, n, -INFINITY, hi);
    float wlo = INFINITY, whi = -INFINITY;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      wlo = fminf(wlo, lo[e]);
      whi = fmaxf(whi, hi[e]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      wlo = fminf(wlo, __shfl_xor_sync(kAll, wlo, o));
      whi = fmaxf(whi, __shfl_xor_sync(kAll, whi, o));
    }
    if (lane == 0) {
      s_red[0][warp] = wlo;
      s_red[1][warp] = whi;
    }
    __syncthreads();
    if (warp < 2) {                     // warp 0: a, warp 1: b
      float x = warp ? -INFINITY : INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x = warp ? fmaxf(x, s_red[1][w]) : fminf(x, s_red[0][w]);
      const int c = group_count<32>(distinct, D, x, warp == 0);
      if (lane == 0) s_win[warp] = c;
    }
    __syncthreads();
    const int a = s_win[0], m = s_win[1] - a;   // block-uniform
    bool h[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) h[e] = false;
    if (m > 0) {
      const float* kp = distinct + a;
      if (kStageKeys > 0 && m >= kStageMin && m <= kStageKeys) {
        for (int i = threadIdx.x; i < m; i += kThreads)
          cp_async4(s_keys + i, kp + i);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        kp = s_keys;
      }
      int aw = 0, bw = m;
      bool in_lanes = m <= 32;
      float key = 0.0f;
      if (in_lanes) {
        key = lane < m ? kp[lane] : 0.0f;
        if (kWarpWindow) {
          aw = __popc(__ballot_sync(kAll, lane < m && key < wlo));
          bw = __popc(__ballot_sync(kAll, lane < m && key <= whi));
        }
      } else if (kWarpWindow && m < kStageMin) {
        const bool upper = lane >= 16;
        const int c = group_count<16>(kp, m, upper ? whi : wlo, !upper);
        aw = __shfl_sync(kAll, c, 0);
        bw = __shfl_sync(kAll, c, 16);
        if (bw > aw && bw - aw <= 32) {
          in_lanes = true;
          key = lane < bw - aw ? kp[aw + lane] : 0.0f;
          bw -= aw;
          aw = 0;
        }
      }
      if (bw > aw) {                    // warp-uniform
        if (in_lanes) {
          search_lanes(key, aw, bw - aw, lo, hi, h);
        } else {
          search_memory(kp + aw, bw - aw, lo, hi, h);
        }
      }
    }
    if (n > 0) store_v(hit + p0, n, h);
    __syncthreads();                    // s_red, s_win and s_keys are free
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
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, join_overlap_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(P) + kTile - 1) / kTile;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      static_cast<unsigned int>(tiles < most ? tiles : most);
  join_overlap_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pmin), static_cast<const float*>(pmax),
      static_cast<const float*>(distinct), static_cast<int32_t*>(hit), D, P);
  return static_cast<int>(cudaGetLastError());
}
