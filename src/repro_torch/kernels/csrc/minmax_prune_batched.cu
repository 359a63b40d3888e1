// Batched three-valued min/max range pruning on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/minmax_prune_batched.py
// (minmax_prune_batched, body _batched_kernel): Q queries, each a
// conjunction of Kb (cid, lo, hi) closed ranges, against the resident
// [C, Pc] mins / maxs / demote planes, giving tv[q, p] in
//   0 = NO       pmax < lo, pmin > hi, or pmin > pmax (empty interval)
//   2 = FULL     lo <= pmin, pmax <= hi, demote == 0 and not empty
//   1 = PARTIAL  otherwise
// combined over a query's constraints by min (AND).  A slot with
// lo == -inf and hi == +inf exactly is padding: it contributes 2, the AND
// identity.
//
// What bounds it on the card.  The least traffic is the referenced plane
// rows (12 bytes a column and partition) plus one verdict byte a (query,
// partition); at the main path's largest group (Q = 176, Kb = 2, three
// columns, P = 2**20) the verdict store alone is 0.055 ms at 3.35 TB/s,
// and PyTorch's fill_ of that [Q, P] output takes 0.061 ms on an H100.
// The first port loaded the plane triple once per (query, slot) and
// stored one byte a thread; it was bound by load and store instructions.
// This one is bound by instruction issue in the slot loop: the same
// kernel with every verdict stored over one L2-resident row takes as
// long as with [Q, P] written out, so device memory is not the limit
// (tools/prune_variants.py).  The design:
//   * a block owns a tile of kTile = kThreads * kV partitions and ALL Q
//     queries, walking the queries' slots in order, so each plane element
//     leaves device memory once per launch.  Blocks are persistent (at
//     most the resident blocks, from the occupancy API) and take tiles in
//     turn;
//   * a compact column map: each block ranks the distinct columns its
//     non-padding slots reference (C <= kDirect, in shared memory).  When
//     there are at most kCols of them, a thread copies its own kV
//     partitions' min and max of each into shared memory with 16-byte
//     cp.async (4-byte copies where either row is not 16-byte aligned or
//     ends inside the vector) and folds "empty" and "demote == 0 and not
//     empty" into one flag byte a partition.  With more referenced
//     columns, or C > kDirect, none is staged: every slot reads its plane
//     rows straight from global memory, float4 where aligned;
//   * per slot a thread reads its kV (min, max, flags) as 16-byte shared
//     loads; for every 4 partitions it keeps two words of running ANDs,
//     byte j of A 1 while partition j is not NO, of B while it is FULL;
//     FULL implies not NO for every slot, so the verdict byte is A + B;
//   * at each query's last slot the thread stores its kV verdicts with
//     one 16-byte store (8- or 4-byte where the row is only that aligned):
//     a warp writes 32 * kV contiguous bytes of the [Q, P] row.  A row
//     whose start is not 4-byte aligned (P % 4 != 0) is written by a
//     funnel shift of each lane's words with its left neighbour's (a
//     shuffle): aligned 4-byte stores, bytes at the warp's two edges and
//     past P;
//   * the queries' (code, lo, hi, end) slots are staged through a
//     kSlots-slot shared tile, read by every thread (a broadcast); longer
//     slot lists go through it in chunks.
// kV = 16 (tiles of 2,048 partitions at kThreads = 128) measured fastest
// at the main path's shapes, against kV = 4 and 8; 64 threads a block
// took as long (tools/prune_variants.py; PERF.md).  Shared memory
// (dynamic): kCols * kTile * 9 bytes of planes and flags, kSlots * 16
// bytes of slots, 2 * kDirect bytes of column map: 90 KB, two blocks an
// SM.  The TPU kernel's one-hot MXU gather and 8-row query tiles are TPU
// idioms and are not carried over.
//
// Float semantics: build without --use_fast_math and without -ftz=true.
// A flush-to-zero compare would treat denormal bounds and stats as 0 and
// change verdicts at denormal bounds; the comparisons below are IEEE f32,
// written exactly as the plain version's (NaN compares false).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kV = 16;            // consecutive partitions a thread
constexpr int kThreads = 128;     // threads a block
constexpr int kCols = 4;          // most referenced columns staged
constexpr int kDirect = 1024;     // largest C ranked in shared memory
constexpr int kSlots = 1024;      // slots staged at once
constexpr int kWords = kV / 4;    // 32-bit verdict words a thread
constexpr int kTile = kThreads * kV;
constexpr uint32_t kOnes = 0x01010101u;
static_assert(kV == 4 || kV == 8 || kV == 16, "kV is 4, 8 or 16");
static_assert(kDirect % kThreads == 0, "whole column-map runs a thread");

struct Smem {
  float4 mn[kCols * kWords * kThreads];     // [col][word][thread]
  float4 mx[kCols * kWords * kThreads];
  uint32_t fl[kCols * kWords * kThreads];   // bit 8j: empty; 8j+1: fullable
  int4 slot[kSlots];                        // code, lo, hi, q at its end
  int16_t rank[kDirect];                    // used column -> rank
  int16_t col[kCols];                       // rank -> staged column
  int warp_sum[kThreads / 32];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Exclusive prefix sum of one int a thread over the block; *total gets
// the sum.  Every thread must call it.
__device__ int block_exclusive_scan(Smem& s, int v, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s.warp_sum[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = s.warp_sum[w];
    if (w < warp) before += t;
    sum += t;
  }
  __syncthreads();                  // warp_sum may be reused
  *total = sum;
  return before + x - v;
}

// One float4 of a plane row at partitions p..p+3 (those below P).
__device__ __forceinline__ float4 load4(const float* row, int p, int P) {
  if (p + 4 <= P && aligned16(row + p))
    return __ldg(reinterpret_cast<const float4*>(row + p));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = p + e < P ? __ldg(row + p + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Flag bytes of four partitions: bit 0 empty (min > max), bit 1 FULL
// allowed (demote == 0 and not empty).
__device__ __forceinline__ uint32_t flags4(float4 n, float4 x, float4 d) {
  const float nn[4] = {n.x, n.y, n.z, n.w};
  const float xx[4] = {x.x, x.y, x.z, x.w};
  const float dd[4] = {d.x, d.y, d.z, d.w};
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool empty = nn[j] > xx[j];
    const bool fullable = (dd[j] == 0.0f) & !empty;
    f |= (static_cast<uint32_t>(empty) | (static_cast<uint32_t>(fullable)
                                          << 1)) << (8 * j);
  }
  return f;
}

// One slot against four partitions: clear byte j of a where partition j
// is NO, of b where it is not FULL.
__device__ __forceinline__ void eval4(float4 n, float4 x, uint32_t f,
                                      float l, float h, uint32_t& a,
                                      uint32_t& b) {
  a &= ~f;                  // empty: NO
  b &= f >> 1;              // demoted or empty: not FULL
  const float nn[4] = {n.x, n.y, n.z, n.w};
  const float xx[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((xx[j] < l) | (nn[j] > h)) a &= ~(1u << (8 * j));
    if (!((nn[j] >= l) & (xx[j] <= h))) b &= ~(1u << (8 * j));
  }
}

// Store a thread's kV verdict bytes (words v, little-endian) at
// partitions p0 .. p0 + kV - 1 of the row starting at `row`, those below P.
// Every lane of the warp must call it (the misaligned path shuffles).
__device__ __forceinline__ void store_verdicts(int8_t* row, int p0, int P,
                                               const uint32_t (&v)[kWords]) {
  const int lane = threadIdx.x & 31;
  int8_t* at = row + p0;
  // p0 % 4 == 0, so the shift is the row's and the same for the warp
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3);
  if (s == 0) {
    if (p0 + kV <= P) {
      if constexpr (kV == 16) {
        if (aligned16(at)) {
          *reinterpret_cast<uint4*>(at) = make_uint4(v[0], v[1], v[2], v[3]);
          return;
        }
      }
      if constexpr (kV >= 8) {
        if ((reinterpret_cast<uintptr_t>(at) & 7) == 0) {
#pragma unroll
          for (int k = 0; k < kWords; k += 2)
            reinterpret_cast<uint2*>(at)[k / 2] = make_uint2(v[k], v[k + 1]);
          return;
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        reinterpret_cast<uint32_t*>(at)[k] = v[k];
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j)
        if (p0 + j < P) at[j] = static_cast<int8_t>(v[j / 4] >> (8 * (j % 4)));
    }
    return;
  }
  // the row starts s bytes past a 4-byte boundary: word k of the output
  // covers partitions p0 + 4k - s .. p0 + 4k - s + 3, its first s bytes
  // from the lane's previous word (lane - 1's last word for k = 0)
  const uint32_t prev = __shfl_up_sync(0xffffffffu, v[kWords - 1], 1);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t lo = k ? v[k - 1] : prev;
    const uint32_t out = __funnelshift_r(lo, v[k], 8 * (4 - s));
    const int ps = p0 + 4 * k - s;
    if (k == 0 && lane == 0) {
      // bytes below s belong to the previous warp, which stores them
      for (int j = s; j < 4; ++j)
        if (ps + j < P) row[ps + j] = static_cast<int8_t>(out >> (8 * j));
    } else if (ps + 4 <= P) {
      *reinterpret_cast<uint32_t*>(row + ps) = out;
    } else {
      for (int j = 0; j < 4; ++j)
        if (ps + j < P) row[ps + j] = static_cast<int8_t>(out >> (8 * j));
    }
  }
  if (lane == 31) {                 // its last s bytes: no lane to its right
    for (int j = 4 - s; j < 4; ++j) {
      const int p = p0 + kV - 4 + j;
      if (p < P) row[p] = static_cast<int8_t>(v[kWords - 1] >> (8 * j));
    }
  }
}

__global__ void __launch_bounds__(kThreads) minmax_prune_batched_kernel(
    const int32_t* __restrict__ cids,    // [Q, Kb]
    const float* __restrict__ lo,        // [Q, Kb]
    const float* __restrict__ hi,        // [Q, Kb]
    const float* __restrict__ mins,      // [C, Pc]
    const float* __restrict__ maxs,      // [C, Pc]
    const float* __restrict__ demote,    // [C, Pc]
    int8_t* __restrict__ tv,             // [Q, P]
    int Q, int Kb, int P, int Pc, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t n_slots = static_cast<int64_t>(Q) * Kb;

  // the compact column map: rank the distinct columns the non-padding
  // slots name; they are staged when there are at most kCols of them
  int n_cols = kCols + 1;
  if (C <= kDirect) {
    for (int c = tid; c < C; c += kThreads) sm.rank[c] = 0;
    __syncthreads();
    for (int64_t i = tid; i < n_slots; i += kThreads) {
      const float l = __ldg(lo + i), h = __ldg(hi + i);
      const int c = __ldg(cids + i);
      if (!(l == -CUDART_INF_F && h == CUDART_INF_F) && c >= 0 && c < C)
        sm.rank[c] = 1;
    }
    __syncthreads();
    constexpr int kRun = kDirect / kThreads;   // columns a thread ranks
    const int c0 = tid * kRun;
    uint32_t used = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (c0 + j < C && sm.rank[c0 + j]) used |= 1u << j;
    int r = block_exclusive_scan(sm, __popc(used), &n_cols);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (c0 + j >= C) break;
      if (used >> j & 1) {
        sm.rank[c0 + j] = static_cast<int16_t>(r);
        if (r < kCols) sm.col[r] = static_cast<int16_t>(c0 + j);
        ++r;
      }
    }
    __syncthreads();
  }
  const bool staged = n_cols <= kCols;

  // a slot's code: its shared row when staged, -2 - c to read column c
  // from global memory, -1 to skip (padding or a column outside [0, C))
  auto stage_slots = [&](int64_t s0, int m) {
    for (int i = tid; i < m; i += kThreads) {
      const int64_t g = s0 + i;
      const float l = __ldg(lo + g), h = __ldg(hi + g);
      const int c = __ldg(cids + g);
      int code = -1;
      if (!(l == -CUDART_INF_F && h == CUDART_INF_F) && c >= 0 && c < C)
        code = staged ? sm.rank[c] : -2 - c;
      const int end = (g + 1) % Kb == 0 ? static_cast<int>(g / Kb) : -1;
      sm.slot[i] = make_int4(code, __float_as_int(l), __float_as_int(h), end);
    }
  };
  const bool resident = n_slots <= kSlots;
  if (resident) {
    stage_slots(0, static_cast<int>(n_slots));
    __syncthreads();
  }

  const int n_tiles = (P + kTile - 1) / kTile;
  const int rows = staged ? n_cols : 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile + tid * kV;
    // the referenced columns: a thread stages its own kV partitions, so
    // only its own cp.async wait stands between the copy and the use
    if (p0 < P) {
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        if (r >= rows) break;
        const int64_t off = static_cast<int64_t>(sm.col[r]) * Pc;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int p = p0 + 4 * k;
          const int at = (r * kWords + k) * kThreads + tid;
          const float* gn = mins + off + p;
          const float* gx = maxs + off + p;
          if (p + 4 <= P && aligned16(gn) && aligned16(gx)) {
            cp_async16(&sm.mn[at], gn);
            cp_async16(&sm.mx[at], gx);
          } else {
            for (int e = 0; e < 4 && p + e < P; ++e) {
              cp_async4(reinterpret_cast<float*>(&sm.mn[at]) + e, gn + e);
              cp_async4(reinterpret_cast<float*>(&sm.mx[at]) + e, gx + e);
            }
          }
        }
      }
      float4 dem[kCols * kWords];
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        if (r >= rows) break;
        const int64_t off = static_cast<int64_t>(sm.col[r]) * Pc;
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          dem[r * kWords + k] = load4(demote + off, p0 + 4 * k, P);
      }
      cp_async_wait_all();
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        if (r >= rows) break;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int at = (r * kWords + k) * kThreads + tid;
          sm.fl[at] = flags4(sm.mn[at], sm.mx[at], dem[r * kWords + k]);
        }
      }
    }

    uint32_t a[kWords], b[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) a[k] = b[k] = kOnes;
    for (int64_t s0 = 0; s0 < n_slots; s0 += kSlots) {
      const int m = n_slots - s0 < kSlots ? static_cast<int>(n_slots - s0)
                                          : kSlots;
      if (!resident) {
        __syncthreads();                // the previous slots have been read
        stage_slots(s0, m);
        __syncthreads();
      }
      for (int i = 0; i < m; ++i) {
        const int4 sl = sm.slot[i];
        const float l = __int_as_float(sl.y), h = __int_as_float(sl.z);
        if (sl.x >= 0) {
#pragma unroll
          for (int k = 0; k < kWords; ++k) {
            const int at = (sl.x * kWords + k) * kThreads + tid;
            eval4(sm.mn[at], sm.mx[at], sm.fl[at], l, h, a[k], b[k]);
          }
        } else if (sl.x <= -2) {        // not staged: straight from global
          const int64_t off = static_cast<int64_t>(-2 - sl.x) * Pc;
#pragma unroll
          for (int k = 0; k < kWords; ++k) {
            const int p = p0 + 4 * k;
            const float4 n = load4(mins + off, p, P);
            const float4 x = load4(maxs + off, p, P);
            const float4 d = load4(demote + off, p, P);
            eval4(n, x, flags4(n, x, d), l, h, a[k], b[k]);
          }
        }
        if (sl.w >= 0) {                // the query's last slot
          uint32_t v[kWords];
#pragma unroll
          for (int k = 0; k < kWords; ++k) v[k] = a[k] + b[k];
          store_verdicts(tv + static_cast<int64_t>(sl.w) * P, p0, P, v);
#pragma unroll
          for (int k = 0; k < kWords; ++k) a[k] = b[k] = kOnes;
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;
int g_grid[kMaxDevices];   // resident blocks a device, set at its first launch

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `tv` and checks shapes; nothing is allocated here and
// nothing is synchronised.
extern "C" int minmax_prune_batched_launch(
    const void* cids, const void* lo, const void* hi, const void* mins,
    const void* maxs, const void* demote, void* tv, int Q, int Kb, int P,
    int Pc, int C, void* stream) {
  if (Q <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (Kb <= 0 || C <= 0 || Pc < P) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(
             minmax_prune_batched_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, minmax_prune_batched_kernel, kThreads, smem)) !=
            cudaSuccess)
      return static_cast<int>(e);
    g_grid[dev] = std::max(1, sms * per_sm);
  }
  const int n_tiles = (P + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned int>(std::min(n_tiles, g_grid[dev])));
  minmax_prune_batched_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cids), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(mins),
      static_cast<const float*>(maxs), static_cast<const float*>(demote),
      static_cast<int8_t*>(tv), Q, Kb, P, Pc, C);
  return static_cast<int>(cudaGetLastError());
}
