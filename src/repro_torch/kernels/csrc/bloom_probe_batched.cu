// Batched blocked-Bloom JOIN pruning on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/bloom_probe.py
// (bloom_probe_batched, body _bloom_probe_kernel): Q build-side blocked
// Bloom filters against the resident [Pc] enumeration plane of the probe
// table (integer-snapped pmin and candidate count `width`, int32), giving
// for the first P partitions
//   hit[q, p] = 1  if width[p] <= 0 (not enumerable: keep), else
//   hit[q, p] = 1  iff some candidate pmin[p] + j, j < width[p], is in
//                  query q's filter.
// The caller zeroes the widths above its enumeration limit.
//
// The hash is core/prune_join.py's (_fold_key, _probe_coords) bit for bit,
// in plain uint32 arithmetic (shifts are logical on uint32):
//   h0 = mix32(lo32(c) ^ mix32(hi32(c)))  -- the int64 fold of c; the high
//        word of a candidate is its sign extension
//   h1 = mix32(h0 ^ 0x9E3779B9), h2 = mix32(h1 ^ 0x7F4A7C15)
//   block = h0 & (n_blocks - 1); probe i tests word (h1 >> 8i) & 15 of the
//   block at bit (h2 >> 8i) & 31, for i < 4.
// Filters arrive as their uint32 words, [Q, n_blocks * 16], word index
// block * 16 + w, each tiled periodically up to the launch's common
// power-of-two n_blocks (a tiled filter probes the same words under the
// larger block mask).
//
// What bounds it on the card.  A candidate costs three mixes; testing it
// against one filter costs four scattered 4-byte loads.  Tested query by
// query, as the first port did, that is four L1/L2 sector requests a
// (candidate, query): 1.117 ms at the main path's Bloom group (Q = 16,
// 256 blocks, P = 2**20) on an H100, 9x its count of 28 operations a
// test.  The design:
//   * a bit-sliced table, built on the card by a small transpose kernel
//     launched by the same entry point: for a chunk of qc queries (qc = 8,
//     16 or 32, the bits of the table's entry type), entry
//     [blk][word][bit] is the mask of the chunk's queries whose filter has
//     that bit set.  A candidate's hits for the whole chunk are the AND of
//     four entry loads: four loads a candidate, not four a (candidate,
//     query).  The table is the filters' own size, qc / 8 bytes an entry.
//     The wrapper takes the narrowest entry that covers min(Q, 32)
//     queries (ceil(Q / 32) chunks above 32): a second chunk hashes every
//     candidate again (two 8-query tables took 1.7x one 16-query table at
//     the main path's Bloom group, tools/prune_variants.py).  The table is
//     read through L1/L2 (the main path's 16 x 256 table is 256 KB, over
//     the 227 KB of shared memory a block may hold);
//   * a warp owns 32 consecutive partitions and balances their candidates
//     over its lanes: it prefix-sums the widths, lane l takes candidate
//     base + l of the warp's list, finds its partition by a binary search
//     over the 33 prefix ends, and ORs its hits into that partition's
//     found mask in shared memory (atomicOr, only when a candidate hits).
//     No lane waits on the widest partition of its warp.  A candidate
//     whose partition has already found every query of the chunk is not
//     hashed (the early stop).  A warp whose widths sum past INT32_MAX
//     walks each partition in its own lane instead;
//   * blocks of kThreads are persistent (grid x sized by occupancy, grid
//     y over query chunks);
//   * verdicts are int8 in the logical [Q, P] output, coalesced across
//     the partitions of a warp.
// The TPU kernel's f32 16-bit-half word planes and its one-hot MXU gather
// of the block are TPU idioms and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;          // threads a block, 32 partitions a warp
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 16;             // 32-bit words per Bloom block
constexpr int kProbes = 4;
constexpr int kBlockEntries = kWords * 32;   // table entries a Bloom block
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// mix32 of the high word of a negative candidate; a non-negative one's
// high word is 0, and mix32(0) == 0
constexpr uint32_t kNegFold = mix32(0xFFFFFFFFu);

// The chunk's queries whose filter holds candidate c (all four probes).
template <typename M>
__device__ __forceinline__ uint32_t probe(const M* tab, int64_t c,
                                          uint32_t bmask) {
  const uint32_t h0 = mix32(static_cast<uint32_t>(c) ^ (c < 0 ? kNegFold
                                                               : 0u));
  const uint32_t h1 = mix32(h0 ^ 0x9E3779B9u);
  const uint32_t h2 = mix32(h1 ^ 0x7F4A7C15u);
  const uint32_t base = (h0 & bmask) * kBlockEntries;
  uint32_t m = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < kProbes; ++i)
    m &= __ldg(tab + base + ((h1 >> (8 * i)) & 15u) * 32u +
               ((h2 >> (8 * i)) & 31u));
  return m;
}

// table[chunk][pos * 32 + bit] = the queries q0 + qi (qi < qc) of the chunk
// whose filter word pos has `bit` set.
template <typename M>
__global__ void bitslice_kernel(const uint32_t* __restrict__ words,
                                M* __restrict__ table, int Q, int qc,
                                int n_words, int64_t n_entries) {
  const int64_t per_chunk = static_cast<int64_t>(n_words) * 32;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_entries; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int chunk = static_cast<int>(i / per_chunk);
    const int64_t e = i - chunk * per_chunk;
    const int64_t pos = e >> 5;
    const int bit = static_cast<int>(e & 31);
    const int q0 = chunk * qc;
    const int nq = min(qc, Q - q0);
    uint32_t m = 0;
    for (int qi = 0; qi < nq; ++qi)
      m |= ((__ldg(words + static_cast<int64_t>(q0 + qi) * n_words + pos) >>
             bit) & 1u) << qi;
    table[i] = static_cast<M>(m);
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads) bloom_probe_batched_kernel(
    const M* __restrict__ table,          // [chunks, n_blocks * 512]
    const int32_t* __restrict__ pmin,     // [Pc]
    const int32_t* __restrict__ width,    // [Pc], <= 0 = keep
    int8_t* __restrict__ hit,             // [Q, P]
    int Q, int qc, int n_blocks, int P) {
  __shared__ int s_end[kWarps][33];       // prefix ends of the widths
  __shared__ uint32_t s_found[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Q - q0);
  const uint32_t all = nq == 32 ? 0xFFFFFFFFu : ((1u << nq) - 1u);
  const M* tab = table + static_cast<int64_t>(blockIdx.y) * n_blocks *
                             kBlockEntries;
  const uint32_t bmask = static_cast<uint32_t>(n_blocks - 1);
  const int n_groups = (P >> 5) + ((P & 31) != 0);
  if (lane == 0) s_end[warp][0] = 0;
  for (int g = blockIdx.x * kWarps + warp; g < n_groups;
       g += gridDim.x * kWarps) {
    const int p = g * 32 + lane;
    const bool valid = p < P;
    const int w = valid ? __ldg(width + p) : 0;
    const int32_t first = valid ? __ldg(pmin + p) : 0;
    const uint32_t wp = w > 0 ? static_cast<uint32_t>(w) : 0u;
    uint32_t found = valid && w <= 0 ? all : 0u;
    unsigned long long end = wp;          // inclusive prefix of the widths
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += y;
    }
    const unsigned long long total = __shfl_sync(0xffffffffu, end, 31);
    if (total > 0x7fffffffull) {
      // too many candidates to number in int32: each lane its own
      for (uint32_t j = 0; j < wp && found != all; ++j)
        found |= probe<M>(tab, static_cast<int64_t>(first) + j, bmask) & all;
    } else {
      s_end[warp][lane + 1] = static_cast<int>(end);
      s_found[warp][lane] = found;
      __syncwarp();
      const int n = static_cast<int>(total);
      for (int base = 0; base < n; base += 32) {
        const int c = base + lane;
        // the partition owning candidate c: the last one whose list
        // starts at or before c
        int own = 0;
#pragma unroll
        for (int step = 16; step; step >>= 1)
          if (s_end[warp][own + step] <= c) own += step;
        const int32_t f = __shfl_sync(0xffffffffu, first, own);
        const uint32_t todo = c < n ? all & ~s_found[warp][own] : 0u;
        if (todo) {
          const int64_t cand = static_cast<int64_t>(f) + (c - s_end[warp][own]);
          const uint32_t hits = probe<M>(tab, cand, bmask) & todo;
          if (hits) atomicOr(&s_found[warp][own], hits);
        }
        __syncwarp();
      }
      found = s_found[warp][lane];
    }
    if (valid) {
      for (int qi = 0; qi < nq; ++qi)
        hit[static_cast<int64_t>(q0 + qi) * P + p] =
            static_cast<int8_t>((found >> qi) & 1u);
    }
    __syncwarp();                         // s_end, s_found reused
  }
}

struct Config {       // per device and entry width, set at first use
  int sms = 0;
  int blocks_per_sm = 0;
};
Config g_config[kMaxDevices][3];

template <typename M>
cudaError_t launch(const void* words, const void* pmin, const void* width,
                   void* hit, void* table, int Q, int n_blocks, int P,
                   int ci, cudaStream_t stream) {
  constexpr int qc = 8 * static_cast<int>(sizeof(M));
  const int n_chunks = (Q + qc - 1) / qc;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Config& cfg = g_config[dev][ci];
  if (cfg.sms == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, bloom_probe_batched_kernel<M>, kThreads, 0)) !=
            cudaSuccess)
      return e;
    cfg.blocks_per_sm = per_sm;
    cfg.sms = sms;
  }
  const int64_t n_entries =
      static_cast<int64_t>(n_blocks) * kBlockEntries * n_chunks;
  const int t_threads = 256;
  const int64_t t_blocks = std::min<int64_t>(
      (n_entries + t_threads - 1) / t_threads,
      static_cast<int64_t>(cfg.sms) * 16);
  bitslice_kernel<M><<<static_cast<unsigned int>(t_blocks), t_threads, 0,
                       stream>>>(static_cast<const uint32_t*>(words),
                                 static_cast<M*>(table), Q, qc,
                                 n_blocks * kWords, n_entries);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n_groups = (P >> 5) + ((P & 31) != 0);
  const int need = (n_groups + kWarps - 1) / kWarps;
  const int resident =
      std::max(1, cfg.sms * std::max(cfg.blocks_per_sm, 1) / n_chunks);
  const dim3 grid(static_cast<unsigned int>(std::min(need, resident)),
                  static_cast<unsigned int>(n_chunks));
  bloom_probe_batched_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const M*>(table), static_cast<const int32_t*>(pmin),
      static_cast<const int32_t*>(width), static_cast<int8_t*>(hit), Q, qc,
      n_blocks, P);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`: the bit-sliced transpose of `words` into `table`
// (ceil(Q / bits) chunks of n_blocks * 512 entries of bits / 8 bytes,
// allocated by the caller), then the probe.  Returns the first CUDA error
// (0 on success).  The caller checks shapes; nothing is allocated here and
// nothing is synchronised.  n_blocks must be a power of two, bits 8, 16
// or 32.
extern "C" int bloom_probe_batched_launch(
    const void* words, const void* pmin, const void* width, void* hit,
    void* table, int Q, int n_blocks, int P, int bits, void* stream) {
  if (Q <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (n_blocks <= 0 || (n_blocks & (n_blocks - 1)) ||
      n_blocks > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((Q + bits - 1) / bits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bits) {
    case 8: e = launch<uint8_t>(words, pmin, width, hit, table, Q, n_blocks, P, 0, s); break;
    case 16: e = launch<uint16_t>(words, pmin, width, hit, table, Q, n_blocks, P, 1, s); break;
    case 32: e = launch<uint32_t>(words, pmin, width, hit, table, Q, n_blocks, P, 2, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
