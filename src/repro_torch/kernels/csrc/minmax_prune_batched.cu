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
// What bounds it on the card: memory.  Each plane element is read once
// per query block and each verdict written once, so the least traffic is
// the referenced plane rows (3 * 4 bytes per column and partition) plus
// one verdict byte per (query, partition); at Q=256, P=1M the verdict
// store dominates.  The design follows from that:
//   * one thread per partition p, a block over a tile of partitions, so
//     the plane loads of a warp are 32 consecutive floats (coalesced);
//   * a block's queries' (cid, lo, hi) slots are staged through a
//     fixed kSlots-slot shared-memory tile, read by every thread of the
//     block; when a block holds more slots than that (a conjunction of
//     more than kSlots ranges) they go through the tile in chunks, so
//     shared memory stays at 24 KB for any Kb;
//   * query blocks are the fastest grid dimension: the blocks that share a
//     partition tile run next to each other and re-read its plane rows
//     from L2, not from device memory;
//   * verdicts are int8 stored straight into the logical [Q, P] output,
//     not the capacity: a quarter of the bytes of an int32 [Q, Pc] tile.
// The TPU kernel's one-hot MXU gather and 8-row query tiles are TPU
// idioms and are not carried over: here the row is an indexed load.
//
// Float semantics: build without --use_fast_math and without -ftz=true.
// A flush-to-zero compare would treat denormal bounds and stats as 0 and
// change verdicts at denormal bounds; the comparisons below are IEEE f32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // partitions per block
constexpr int kSlots = 2048;    // (cid, lo, hi) slots in shared memory

__global__ void minmax_prune_batched_kernel(
    const int32_t* __restrict__ cids,    // [Q, Kb]
    const float* __restrict__ lo,        // [Q, Kb]
    const float* __restrict__ hi,        // [Q, Kb]
    const float* __restrict__ mins,      // [C, Pc]
    const float* __restrict__ maxs,      // [C, Pc]
    const float* __restrict__ demote,    // [C, Pc]
    int8_t* __restrict__ tv,             // [Q, P]
    int Q, int Kb, int P, int Pc, int block_q) {
  __shared__ int32_t s_cid[kSlots];
  __shared__ float s_lo[kSlots];
  __shared__ float s_hi[kSlots];

  // 1-D grid, query blocks fastest: block b covers query block
  // b % n_qblocks and partition tile b / n_qblocks
  const int n_qblocks = (Q + block_q - 1) / block_q;
  const int q0 = (blockIdx.x % n_qblocks) * block_q;
  const int64_t tile = blockIdx.x / n_qblocks;
  const int nq = min(block_q, Q - q0);
  const int64_t n = static_cast<int64_t>(nq) * Kb;   // the block's slots
  const int64_t p64 = tile * blockDim.x + threadIdx.x;
  // threads past P stage slots and meet every barrier, but store nothing
  const bool active = p64 < P;
  const int p = active ? static_cast<int>(p64) : 0;

  int qi = 0;   // query of the next slot, relative to q0
  int k = 0;    // its constraint index
  int v = 2;    // running AND over the query's constraints
  for (int64_t c0 = 0; c0 < n; c0 += kSlots) {
    const int m = n - c0 < kSlots ? static_cast<int>(n - c0) : kSlots;
    if (c0 > 0) __syncthreads();     // the previous chunk has been read
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int64_t g = static_cast<int64_t>(q0) * Kb + c0 + i;
      s_cid[i] = cids[g];
      s_lo[i] = lo[g];
      s_hi[i] = hi[g];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < m; ++i) {
      const float l = s_lo[i];
      const float h = s_hi[i];
      if (!(l == -CUDART_INF_F && h == CUDART_INF_F)) {   // else padding
        const int64_t off = static_cast<int64_t>(s_cid[i]) * Pc + p;
        const float pmin = __ldg(mins + off);
        const float pmax = __ldg(maxs + off);
        const float pdem = __ldg(demote + off);
        const bool empty = pmin > pmax;
        const bool no = (pmax < l) | (pmin > h) | empty;
        const bool full = (pmin >= l) & (pmax <= h) & (pdem == 0.0f) & !empty;
        v = min(v, no ? 0 : (full ? 2 : 1));
      }
      if (++k == Kb) {                 // the query's last constraint
        tv[static_cast<int64_t>(q0 + qi) * P + p] = static_cast<int8_t>(v);
        v = 2;
        k = 0;
        ++qi;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `tv` and checks shapes; nothing is allocated here and
// nothing is synchronised.
extern "C" int minmax_prune_batched_launch(
    const void* cids, const void* lo, const void* hi, const void* mins,
    const void* maxs, const void* demote, void* tv, int Q, int Kb, int P,
    int Pc, int block_q, void* stream) {
  if (Q <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (Kb <= 0 || block_q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>((Q + block_q - 1) / block_q) *
                         ((P + kThreads - 1) / kThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  minmax_prune_batched_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cids), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(mins),
      static_cast<const float*>(maxs), static_cast<const float*>(demote),
      static_cast<int8_t*>(tv), Q, Kb, P, Pc, block_q);
  return static_cast<int>(cudaGetLastError());
}
