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
// comparisons.  Here the reference's searchsorted formulation is kept --
// the first key at or above pmin[p] (a lower bound), tested against
// pmax[p] -- but only over the keys that can hit at all.
//
// What bounds it on the card: memory, and mostly the stores.  The least
// traffic is the plane's two f32 rows (8 bytes a partition, read once) and
// one verdict byte a (query, partition); the keys are a few hundred KB.
// The design:
//   * a block owns a tile of kTile = kThreads * kV partitions and serves
//     every query of the launch, kQChunk queries at a time; a thread loads
//     its kV consecutive partitions' bounds once (16-byte loads where the
//     row allows, 4-byte otherwise) and keeps them in registers, so the
//     plane moves from device memory once, not Q times.  The grid holds
//     the blocks the card runs at once and strides over the tiles;
//   * the tile's key window: a key outside [min pmin, max pmax] of the
//     tile lies in no interval of it.  The block reduces the two bounds
//     (the empty sentinels drop out by themselves) and finds, for every
//     query of the chunk, a = #keys < min pmin and b = #keys <= max pmax,
//     groups of kGroup lanes searching kGroup-ary, all queries at once;
//   * an empty window (b <= a, most (tile, query) pairs of clustered
//     traffic) stores the tile's zeros with no search;
//   * otherwise each warp narrows [a, b) to its own partitions' window
//     (a ballot where the window fits a warp's lanes, a 16-ary search by
//     each half-warp below kStageMin keys; a larger window, an
//     unclustered plane's, would narrow little and is searched whole),
//     stores zeros where that is empty, and searches only there: among
//     keys held one a lane by shuffles where the warp window holds at
//     most 32 keys, else in memory by a branch-free bisection;
//   * a window of kStageMin to kStageKeys keys (an unclustered plane's) is
//     staged in shared memory by cp.async, the next such query's window
//     loading while this one is searched; a smaller one is searched in
//     place through L1 (timed faster: a staged window costs two
//     barriers), and so is a longer one, so every Db launches;
//   * a thread writes its kV verdicts of a query row with one store of kV
//     bytes (4-byte or 1-byte stores where the row is off that alignment).
// A NaN bound (outside the plane's contract) widens its tile's and warp's
// window to the whole row, so the search is then the plain version's own.
//
// Float semantics: build without --use_fast_math and without -ftz=true;
// the compares are IEEE f32, denormals included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads a block
constexpr int kV = 8;                  // consecutive partitions a thread
constexpr int kTile = kThreads * kV;   // partitions a block's tile
constexpr int kGroup = 8;              // lanes of one tile-window search
constexpr int kQChunk = 64;            // queries whose windows a block holds
constexpr int kStageMin = 1024;        // keys a window needs to be staged
constexpr int kStageKeys = 4096;       // keys a staged window (0: none)
constexpr bool kWarpWindow = true;     // narrow to each warp's window
                                       // (below kStageMin keys)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kV == 4 || kV == 8 || kV == 16, "kV is 4, 8 or 16");
static_assert(kGroup >= 2 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "kGroup is a power of two up to a warp");

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

// a[e] = h[e] for e < n: one kV-byte store where it can, else 4-byte
// words, else bytes.
__device__ __forceinline__ void store_v(int8_t* __restrict__ a, int n,
                                        const bool (&h)[kV]) {
  uint32_t w[kV / 4];
#pragma unroll
  for (int j = 0; j < kV / 4; ++j)
    w[j] = static_cast<uint32_t>(h[4 * j]) |
           static_cast<uint32_t>(h[4 * j + 1]) << 8 |
           static_cast<uint32_t>(h[4 * j + 2]) << 16 |
           static_cast<uint32_t>(h[4 * j + 3]) << 24;
  if (n == kV && aligned_to(a, kV)) {
    if constexpr (kV == 4) {
      *reinterpret_cast<uint32_t*>(a) = w[0];
    } else if constexpr (kV == 8) {
      *reinterpret_cast<uint2*>(a) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(a) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  if (n == kV && aligned_to(a, 4)) {
#pragma unroll
    for (int j = 0; j < kV / 4; ++j) reinterpret_cast<uint32_t*>(a)[j] = w[j];
    return;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e)
    if (e < n) a[e] = h[e] ? 1 : 0;
}

// The number of keys[i], i < n, below x (strict) or at or below x, found
// by the kG lanes of one group together: a kG-ary search, ceil(log_kG(n +
// 1)) rounds of one load a lane.  Every lane of the warp calls it with the
// same n (the rounds depend on n alone); a group that is not `live`
// probes nothing and its result is not used.
template <int kG>
__device__ __forceinline__ int group_count(const float* keys, int n, float x,
                                           bool strict, bool live) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kG - 1);
  const int shift = lane & ~(kG - 1);
  const unsigned gmask = kG == 32 ? kAll : ((1u << kG) - 1u);
  int lo = 0;
  for (int r = n + 1; r > 1;) {        // the count is in [lo, lo + r)
    const int s = (r + kG - 1) / kG;
    const int pos = lo + (sub + 1) * s - 1;
    bool t = false;
    if (live && pos < n) {
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

__global__ void __launch_bounds__(kThreads) join_overlap_batched_kernel(
    const float* __restrict__ dist,   // [Q, Db] sorted keys, +inf padded
    const float* __restrict__ pmin,   // [Pc]
    const float* __restrict__ pmax,   // [Pc]
    int8_t* __restrict__ hit,         // [Q, P]
    int Q, int Db, int P) {
  __shared__ float s_red[2][kWarps];
  __shared__ int s_win[2][kQChunk];   // a, b of each query of the chunk
  __shared__ float s_keys[kStageKeys > 0 ? 2 * kStageKeys : 1];
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
      const bool nan = isnan(lo[e]) || isnan(hi[e]);
      wlo = fminf(wlo, nan ? -INFINITY : lo[e]);
      whi = fmaxf(whi, nan ? INFINITY : hi[e]);
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
    float tlo = INFINITY, thi = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tlo = fminf(tlo, s_red[0][w]);
      thi = fmaxf(thi, s_red[1][w]);
    }

    for (int q0 = 0; q0 < Q; q0 += kQChunk) {
      const int nq = Q - q0 < kQChunk ? Q - q0 : kQChunk;
      // the chunk's tile windows: (query, side) pairs, one a lane group
      for (int base = 0; base < 2 * nq; base += kThreads / kGroup) {
        if (base + warp * (32 / kGroup) >= 2 * nq) break;   // warp-uniform
        const int pair = base + static_cast<int>(threadIdx.x) / kGroup;
        const bool live = pair < 2 * nq;
        const int qi = pair >> 1, side = pair & 1;
        const float* row =
            dist + static_cast<int64_t>(q0 + (live ? qi : 0)) * Db;
        const int c = group_count<kGroup>(row, Db, side ? thi : tlo,
                                          side == 0, live);
        if (live && (lane & (kGroup - 1)) == 0) s_win[side][qi] = c;
      }
      __syncthreads();

      // windows of kStageMin..kStageKeys keys are staged in shared memory,
      // the next one loading (cp.async) while this one is searched
      auto staged = [&](int qi) {
        const int m = s_win[1][qi] - s_win[0][qi];
        return kStageKeys > 0 && m >= kStageMin && m <= kStageKeys;
      };
      auto next_staged = [&](int from) {
        while (from < nq && !staged(from)) ++from;
        return from;
      };
      auto fetch = [&](int qi, int buf) {
        const float* src = dist + static_cast<int64_t>(q0 + qi) * Db +
                           s_win[0][qi];
        float* dst = s_keys + buf * kStageKeys;
        const int m = s_win[1][qi] - s_win[0][qi];
        for (int i = threadIdx.x; i < m; i += kThreads)
          cp_async4(dst + i, src + i);
        asm volatile("cp.async.commit_group;\n" ::);
      };
      int nxt = next_staged(0);
      int buf = 0;
      if (nxt < nq) fetch(nxt, 0);

      for (int qi = 0; qi < nq; ++qi) {
        const int a = s_win[0][qi], m = s_win[1][qi] - a;   // block-uniform
        const float* row = dist + static_cast<int64_t>(q0 + qi) * Db;
        bool h[kV];
#pragma unroll
        for (int e = 0; e < kV; ++e) h[e] = false;
        if (m > 0) {
          const float* kp = row + a;
          if (qi == nxt) {              // a staged window
            const int after = next_staged(qi + 1);
            __syncthreads();            // the other buffer is read no more
            if (after < nq) {
              fetch(after, buf ^ 1);
              asm volatile("cp.async.wait_group 1;\n" ::);
            } else {
              asm volatile("cp.async.wait_group 0;\n" ::);
            }
            __syncthreads();            // this window is in shared memory
            kp = s_keys + buf * kStageKeys;
            nxt = after;
            buf ^= 1;
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
            const int c = group_count<16>(kp, m, upper ? whi : wlo, !upper,
                                          true);
            aw = __shfl_sync(kAll, c, 0);
            bw = __shfl_sync(kAll, c, 16);
            if (bw > aw && bw - aw <= 32) {
              in_lanes = true;
              key = lane < bw - aw ? kp[aw + lane] : 0.0f;
              bw -= aw;
              aw = 0;
            }
          }
          if (bw > aw) {                // warp-uniform
            if (in_lanes) {
              search_lanes(key, aw, bw - aw, lo, hi, h);
            } else {
              search_memory(kp + aw, bw - aw, lo, hi, h);
            }
          }
        }
        if (n > 0)
          store_v(hit + static_cast<int64_t>(q0 + qi) * P + p0, n, h);
      }
      __syncthreads();                  // s_win and s_keys are free
    }
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
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, join_overlap_batched_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(P) + kTile - 1) / kTile;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      static_cast<unsigned int>(tiles < most ? tiles : most);
  join_overlap_batched_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const float*>(pmin),
      static_cast<const float*>(pmax), static_cast<int8_t*>(hit), Q, Db, P);
  return static_cast<int>(cudaGetLastError());
}
