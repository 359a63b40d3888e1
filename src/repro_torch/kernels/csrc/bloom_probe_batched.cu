// Batched blocked-Bloom JOIN pruning on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/bloom_probe.py
// (bloom_probe_batched, body _bloom_probe_kernel): Q build-side blocked
// Bloom filters against the resident [Pc] enumeration plane of the probe
// table (integer-snapped pmin and candidate count `width`, int32), giving
// for the first P partitions
//   hit[q, p] = 1  if width[p] == 0 (not enumerable: keep), else
//   hit[q, p] = 1  iff some candidate pmin[p] + j, j < width[p], is in
//                  query q's filter.
// The caller zeroes the widths above its enumeration limit.
//
// The hash is core/prune_join.py's (_fold_key, _probe_coords) bit for bit,
// in plain uint32 arithmetic (shifts are logical on uint32):
//   h0 = mix32(lo32(c) ^ mix32(hi32(c)))  -- the int64 fold of c; the high
//        word of an int32 candidate is its sign extension
//   h1 = mix32(h0 ^ 0x9E3779B9), h2 = mix32(h1 ^ 0x7F4A7C15)
//   block = h0 & (n_blocks - 1); probe i tests word (h1 >> 8i) & 15 of the
//   block at bit (h2 >> 8i) & 31, for i < 4.
// Filters arrive as their uint32 words, [Q, n_blocks * 16], word index
// block * 16 + w, each tiled periodically up to the launch's common
// power-of-two n_blocks (a tiled filter probes the same words under the
// larger block mask).
//
// What bounds it on the card: operations.  Reads are small (the plane's
// two int32 rows, the filters) but each candidate costs four mixes and up
// to Q probes.  The design:
//   * one thread per partition, up to kQueries queries per block
//     (grid.y over query chunks): a candidate's hash is computed once and
//     tested against every query of the chunk that has not hit yet;
//   * each thread loops over its own partition's width -- no padding to a
//     fixed enumeration width -- and stops once every query of its chunk
//     has hit;
//   * filters are read through L1/L2 with __ldg, never staged in shared
//     memory: a 1024-block filter is 64 KB, over the 48 KB static limit,
//     and a launch's filters fit the 50 MB L2 many times over;
//   * verdicts are int8 in the logical [Q, P] output, coalesced across
//     the partitions of a warp.
// The TPU kernel's f32 16-bit-half word planes and its one-hot MXU gather
// of the block are TPU idioms and are not carried over: here a word is an
// indexed load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // partitions per block
constexpr int kQueries = 32;     // queries per block (bits of one mask)
constexpr int kWords = 16;       // 32-bit words per Bloom block
constexpr int kProbes = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void bloom_probe_batched_kernel(
    const uint32_t* __restrict__ words,  // [Q, n_blocks * 16]
    const int32_t* __restrict__ pmin,    // [Pc]
    const int32_t* __restrict__ width,   // [Pc], 0 = keep
    int8_t* __restrict__ hit,            // [Q, P]
    int Q, int n_blocks, int P) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, Q - q0);
  const uint32_t all = nq == 32 ? 0xFFFFFFFFu : ((1u << nq) - 1u);
  const int w = __ldg(width + p);
  uint32_t found = 0;   // bit qi set: query q0 + qi has a candidate
  if (w <= 0) {
    found = all;
  } else {
    const int32_t first = __ldg(pmin + p);
    const int64_t stride = static_cast<int64_t>(n_blocks) * kWords;
    const uint32_t* chunk = words + static_cast<int64_t>(q0) * stride;
    const uint32_t mask = static_cast<uint32_t>(n_blocks - 1);
    for (int j = 0; j < w && found != all; ++j) {
      const int32_t c = first + j;
      const uint32_t h0 = mix32(static_cast<uint32_t>(c) ^
                                mix32(c < 0 ? 0xFFFFFFFFu : 0u));
      const uint32_t h1 = mix32(h0 ^ 0x9E3779B9u);
      const uint32_t h2 = mix32(h1 ^ 0x7F4A7C15u);
      const int64_t blk = static_cast<int64_t>(h0 & mask) * kWords;
      uint32_t todo = all & ~found;
      while (todo) {
        const int qi = __ffs(todo) - 1;
        todo &= todo - 1;
        const uint32_t* b = chunk + qi * stride + blk;
        bool in = true;
#pragma unroll
        for (int i = 0; i < kProbes; ++i) {
          const uint32_t word = __ldg(b + ((h1 >> (8 * i)) & 15u));
          in = in && ((word >> ((h2 >> (8 * i)) & 31u)) & 1u);
        }
        if (in) found |= 1u << qi;
      }
    }
  }
  for (int qi = 0; qi < nq; ++qi) {
    hit[static_cast<int64_t>(q0 + qi) * P + p] =
        static_cast<int8_t>((found >> qi) & 1u);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `hit` and checks shapes; nothing is allocated here and
// nothing is synchronised.  n_blocks must be a power of two.
extern "C" int bloom_probe_batched_launch(
    const void* words, const void* pmin, const void* width, void* hit, int Q,
    int n_blocks, int P, void* stream) {
  if (Q <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (n_blocks <= 0 || (n_blocks & (n_blocks - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int qchunks = (Q + kQueries - 1) / kQueries;
  if (qchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((P + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(qchunks));
  bloom_probe_batched_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(pmin),
      static_cast<const int32_t*>(width), static_cast<int8_t*>(hit), Q,
      n_blocks, P);
  return static_cast<int>(cudaGetLastError());
}
