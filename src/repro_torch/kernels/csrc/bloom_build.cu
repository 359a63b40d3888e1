// Build-side JOIN summaries on Hopper (sm_90a): the distinct count, the
// range and either the distinct keys or the blocked Bloom words of G
// build sides at once.
//
// Replaces no TPU kernel: the JAX package summarises the build side on
// the host with numpy (src/repro/core/prune_join.py summarize_build, as
// src/repro_torch/core/prune_join.py does).  It was added because that
// host summary -- np.unique over ~250,000 sparse int64 order keys and four
// np.bitwise_or.at scatters into an 8,192-block filter -- took 71% of a
// TPC-H batch on the card's host (250.14 of ~354 ms).
//
// Input: the plan [G, 8] int64 (key0, n, slot0, cap, word0, n_words: the
// segment's keys, its hash-set slots, a power of two >= 2n, and its
// filter's words, the most n keys can need; 0 where n <= ndv_limit)
// followed by the concatenated int64 keys, one buffer and one H2D.
// Output, per segment g:
//   header[g] = (ndv, min, max, n_blocks, flag of key -1, 0, 0, 0), int64;
//   distinct[g, :min(ndv, limit)] = the distinct keys in no order (the
//     host sorts them), valid where ndv <= limit;
//   words[word0 + ...] = the filter's n_blocks * 16 uint32 words, where
//     ndv > limit.  n_blocks is core.prune_join.bloom_blocks(ndv): the least
//     power of two with n_blocks * 512 >= ndv * bits_per_key.
// The hash is core/prune_join.py's (_fold_key, _probe_coords) bit for bit,
// as in bloom_probe_batched.cu: h0 = mix32(lo32(k) ^ mix32(hi32(k))),
// h1 = mix32(h0 ^ 0x9E3779B9), h2 = mix32(h1 ^ 0x7F4A7C15); block
// h0 & (n_blocks - 1), probe i sets word (h1 >> 8i) & 15 of the block at
// bit (h2 >> 8i) & 31.
//
// What bounds it on the card.  The data needs the keys read once (2 MB
// for a TPC-H Q3) and the words written once (512 KB): under a
// microsecond at 3.35 TB/s.  The work is ~3 hash-set probes and 4 atomic
// ORs a key, scattered: atomics on 4 x NDV words that L2 resolves.  The
// design:
//   * dedupe_kernel: an open-addressing set in device memory (linear
//     probing, load factor <= 1/2, atomicCAS on 64-bit slots, empty = -1;
//     the key -1 itself is counted by an atomicExch on a flag).  A key's
//     first insert is counted and appended by one atomicAdd a warp (a
//     ballot of the warp's first inserts), so the NDV and the first
//     `limit` distinct keys come out of one pass; min and max reduce over
//     the warp and meet in one atomicMin / atomicMax a warp.  The NDV is
//     order-independent, so it is deterministic;
//   * bloom_set_kernel: reads the NDV on the card, so no host round trip
//     sits between the two launches; where it exceeds the limit, each key
//     (duplicates too) sets its four bits with atomicOr.  OR is
//     order-independent and idempotent, so the words are deterministic;
//   * the set is cleared by cudaMemsetAsync (0xFF bytes: every slot -1),
//     the words too (0); grid y is the segment, so one launch of each
//     kernel serves a whole batch of build sides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeysPerThread = 4;      // keys a thread, on average
constexpr int kMaxBlocksX = 1024;
constexpr int kCols = 8;               // plan and header row width
constexpr int kWords = 16;             // 32-bit words per Bloom block
constexpr int kProbes = 4;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// splitmix64's finalizer: the slot of a key in the set (sparse order keys
// in 1..6e9 spread evenly)
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

// true iff this call inserted `key` first
__device__ __forceinline__ bool insert(unsigned long long* tab, uint64_t mask,
                                       int64_t key, int64_t* flag) {
  const unsigned long long k = static_cast<unsigned long long>(key);
  if (k == kEmpty)
    return atomicExch(reinterpret_cast<unsigned long long*>(flag), 1ull) ==
           0ull;
  uint64_t s = mix64(k) & mask;
  while (true) {
    // a slot goes from empty to its key once: a stale read can only show
    // it empty, and the CAS then returns what is there
    unsigned long long cur = __ldcg(tab + s);
    if (cur == k) return false;
    if (cur == kEmpty) {
      cur = atomicCAS(tab + s, kEmpty, k);
      if (cur == kEmpty) return true;
      if (cur == k) return false;
    }
    s = (s + 1) & mask;
  }
}

__global__ void init_kernel(int64_t* __restrict__ header, int G) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    int64_t* h = header + static_cast<int64_t>(g) * kCols;
    h[0] = 0;
    h[1] = INT64_MAX;
    h[2] = INT64_MIN;
    for (int c = 3; c < kCols; ++c) h[c] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
dedupe_kernel(const int64_t* __restrict__ plan,
              const int64_t* __restrict__ keys,
              unsigned long long* __restrict__ table,
              int64_t* __restrict__ header, int64_t* __restrict__ distinct,
              int limit) {
  const int g = blockIdx.y;
  const int64_t* pl = plan + static_cast<int64_t>(g) * kCols;
  const int64_t k0 = pl[0], n = pl[1];
  unsigned long long* tab = table + pl[2];
  const uint64_t mask = static_cast<uint64_t>(pl[3]) - 1;
  int64_t* h = header + static_cast<int64_t>(g) * kCols;
  int64_t* out = distinct + static_cast<int64_t>(g) * limit;
  const int lane = threadIdx.x & 31;
  long long lo = INT64_MAX, hi = INT64_MIN;
  // the trip count is the block's, so every lane of a warp takes part in
  // each ballot
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t i = base + threadIdx.x;
    int64_t k = 0;
    bool fresh = false;
    if (i < n) {
      k = keys[k0 + i];
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
      fresh = insert(tab, mask, k, h + 4);
    }
    const unsigned m = __ballot_sync(kFull, fresh);
    if (m) {
      const int leader = __ffs(m) - 1;
      unsigned long long at = 0;
      if (lane == leader)
        at = atomicAdd(reinterpret_cast<unsigned long long*>(h),
                       static_cast<unsigned long long>(__popc(m)));
      at = __shfl_sync(kFull, at, leader);
      if (fresh) {
        const unsigned long long pos = at + __popc(m & ((1u << lane) - 1u));
        if (pos < static_cast<unsigned long long>(limit)) out[pos] = k;
      }
    }
  }
  for (int o = 16; o; o >>= 1) {
    const long long l = __shfl_xor_sync(kFull, lo, o);
    const long long u = __shfl_xor_sync(kFull, hi, o);
    lo = l < lo ? l : lo;
    hi = u > hi ? u : hi;
  }
  if (lane == 0 && lo <= hi) {
    atomicMin(reinterpret_cast<long long*>(h + 1), lo);
    atomicMax(reinterpret_cast<long long*>(h + 2), hi);
  }
}

__global__ void __launch_bounds__(kThreads)
bloom_set_kernel(const int64_t* __restrict__ plan,
                 const int64_t* __restrict__ keys,
                 int64_t* __restrict__ header, uint32_t* __restrict__ words,
                 int limit, int bits_per_key) {
  const int g = blockIdx.y;
  int64_t* h = header + static_cast<int64_t>(g) * kCols;
  const int64_t ndv = h[0];
  if (ndv <= limit) return;
  // core.prune_join.bloom_blocks
  const int64_t want = ndv * bits_per_key;
  int64_t n_blocks = 1;
  while (n_blocks * kWords * 32 < want) n_blocks *= 2;
  if (blockIdx.x == 0 && threadIdx.x == 0) h[3] = n_blocks;
  const int64_t* pl = plan + static_cast<int64_t>(g) * kCols;
  const int64_t k0 = pl[0], n = pl[1];
  uint32_t* w = words + pl[4];
  const uint32_t bmask = static_cast<uint32_t>(n_blocks - 1);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint64_t k = static_cast<uint64_t>(keys[k0 + i]);
    const uint32_t h0 = mix32(static_cast<uint32_t>(k) ^
                              mix32(static_cast<uint32_t>(k >> 32)));
    const uint32_t h1 = mix32(h0 ^ 0x9E3779B9u);
    const uint32_t h2 = mix32(h1 ^ 0x7F4A7C15u);
    uint32_t* blk = w + static_cast<int64_t>(h0 & bmask) * kWords;
#pragma unroll
    for (int p = 0; p < kProbes; ++p)
      atomicOr(blk + ((h1 >> (8 * p)) & 15u), 1u << ((h2 >> (8 * p)) & 31u));
  }
}

}  // namespace

// plan_keys: the plan [G, 8] then the keys, int64; table: n_slots int64
// scratch; header [G, 8] int64; distinct [G, limit] int64; words n_words
// int32.  n_max is the largest segment's key count.
extern "C" int bloom_build_launch(const void* plan_keys, void* table,
                                  void* header, void* distinct, void* words,
                                  int G, int n_max, int n_slots, int n_words,
                                  int limit, int bits_per_key, void* stream) {
  if (G <= 0) return static_cast<int>(cudaSuccess);
  if (G > 65535 || n_max < 0 || n_slots <= 0 || n_words < 0 || limit <= 0 ||
      bits_per_key <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* plan = static_cast<const int64_t*>(plan_keys);
  const int64_t* keys = plan + static_cast<int64_t>(G) * kCols;
  auto* tab = static_cast<unsigned long long*>(table);
  auto* hdr = static_cast<int64_t*>(header);
  cudaError_t e = cudaMemsetAsync(tab, 0xFF, sizeof(uint64_t) * n_slots, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_words > 0 &&
      (e = cudaMemsetAsync(words, 0, sizeof(uint32_t) * n_words, s)) !=
          cudaSuccess)
    return static_cast<int>(e);
  init_kernel<<<1, 32, 0, s>>>(hdr, G);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int per_block = kThreads * kKeysPerThread;
  int bx = (n_max + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > kMaxBlocksX ? kMaxBlocksX : bx);
  const dim3 grid(bx, G);
  dedupe_kernel<<<grid, kThreads, 0, s>>>(
      plan, keys, tab, hdr, static_cast<int64_t*>(distinct), limit);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (n_words > 0) {
    bloom_set_kernel<<<grid, kThreads, 0, s>>>(
        plan, keys, hdr, static_cast<uint32_t*>(words), limit, bits_per_key);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
