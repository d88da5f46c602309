// Single-pass decoupled look-back and a block-wide exclusive scan, shared
// by the kernels that compact or pack a variable amount of output per
// tile in one launch (uvarint_pack64 in delta_encode.cu, row_run_starts
// in grammar_stats.cu; digram_counts uses the block scan).
//
// A block takes its tile from an atomic counter (not from blockIdx), so
// every tile it waits for belongs to a block that already runs: blocks
// start in no order.  Each tile publishes its own count (kAggregate), then,
// once it knows the counts of every tile before it, their sum plus its own
// (kPrefix), in one 64-bit status word whose top two bits say which.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The tile's index from the counter at ``*counter``, read by thread 0 and
// handed to the block through ``slot`` (shared memory).
__device__ __forceinline__ int64_t take_tile(unsigned long long* counter,
                                             long long* slot) {
  if (threadIdx.x == 0) *slot = (long long)atomicAdd(counter, 1ull);
  __syncthreads();
  return *slot;
}

// Called by all 32 lanes of one warp: publishes ``agg``, the count of tile
// ``tile``, in ``words[tile]``, adds up the words of the tiles before it,
// 32 a load, from the nearest back to the first that holds a prefix (each
// word up to that one must be published, non-zero, else the window is
// read again), publishes the inclusive prefix, and returns the exclusive
// one to every lane.  ``words`` must start zeroed; agg < 2^62.
__device__ __forceinline__ unsigned long long tile_prefix(
    unsigned long long* words, int64_t tile, unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(words, kPrefix | agg);
    return 0;
  }
  if (lane == 0) store_status(words + tile, kAggregate | agg);
  unsigned long long prefix = 0;
  for (int64_t j0 = tile - 1;;) {
    const int64_t j = j0 - lane;
    // before tile 0 (which holds a prefix): a prefix of 0
    const unsigned long long w = j >= 0 ? load_status(words + j) : kPrefix;
    const unsigned pmask = __ballot_sync(0xffffffffu, (w & kPrefix) != 0);
    const unsigned zmask = __ballot_sync(0xffffffffu, w == 0);
    // lanes 0 .. the first holding a prefix (all 32 if none does)
    const unsigned upto =
        pmask ? (pmask & (0u - pmask)) * 2u - 1u : 0xffffffffu;
    if (zmask & upto) continue;
    unsigned long long part = (upto >> lane) & 1u ? w & kValue : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    prefix += __shfl_sync(0xffffffffu, part, 0);
    if (pmask) break;
    j0 -= 32;
  }
  if (lane == 0) store_status(words + tile, kPrefix | (prefix + agg));
  return prefix;
}

// Exclusive prefix of ``x`` over a block of ``kThreads`` threads, and the
// block's total in ``*total``: a warp scan by shuffles, then one over the
// warp totals in ``warp_incl`` (kThreads / 32 ints of shared memory).
// Every thread of the block must call it; it synchronises the block.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_incl,
                                                    int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_incl[warp - 1] : 0;
  *total = warp_incl[kWarps - 1];
  __syncthreads();  // warp_incl may be written again by the next call
  return before + incl - x;
}

}  // namespace lookback
