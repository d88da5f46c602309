// Hopper kernels of the symbol-stream statistics, with a plain C interface
// for ctypes (built by kernels/_build.py).
//
//   row_boundaries  replaces row_boundaries_pallas
//                   (src/repro/kernels/grammar_stats/grammar_stats.py:48)
//   row_run_starts  the same function through to the indices of the rows
//                   that start a run (optionally over the rows' first
//                   difference): the one the encode path launches
//   histogram       replaces histogram_pallas (same file, :79)
//   digram_codes    replaces digram_codes_pallas (same file, :113)
//   digram_counts   the same function through to the distinct pair codes
//                   and their counts, for T up to the dense limit (241 on
//                   the H100): the one the read side launches
//
// All of them are bound by memory traffic: each reads its int64 input once
// (a left neighbour is read a second time, from L1/L2) and writes its
// output once, with a few integer operations per element.  At the
// tracer's sizes the time is launch latency and the host<->device copies,
// so the two the encode and read paths launch (row_run_starts and
// digram_counts) do the work that followed the Pallas kernels on the host
// -- the flatnonzero of the mask, the row differences, the count of the
// pair codes -- on the card, in one launch each, and send back only their
// short results.
//
// The TPU versions walk a sequential grid: row_boundaries and
// digram_codes carry the previous block's last element in VMEM, and
// histogram accumulates into one output tile across grid steps.  Here
// blocks run in any order, so each thread reads element i-1 straight from
// global memory, histogram blocks add their partial counts into the
// output with atomics (integer counts, so the order of the adds does not
// change the result), row_run_starts finds its tile's offset in the output
// by the decoupled look-back of lookback.cuh, and digram_counts leaves the
// compaction of the summed counts to the last block to finish.  Fixed
// blocks with a masked tail replace the Pallas shrink-to-a-divisor block
// loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void row_boundaries_kernel(const int64_t* __restrict__ V,
                                      uint8_t* __restrict__ out, int64_t n,
                                      int64_t k) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i == 0) {
    out[0] = 1;
    return;
  }
  const int64_t* row = V + i * k;
  const int64_t* prev = row - k;
  uint8_t diff = 0;
  for (int64_t c = 0; c < k; ++c) diff |= row[c] != prev[c];
  out[i] = diff;
}

// Pair codes s[i-1] * T + s[i] of a terminal stream; position 0 has no
// predecessor and gets -1.  Unsigned arithmetic, so a product past 2^63
// wraps as the int64 plain version does instead of being undefined.
__global__ void digram_codes_kernel(const int64_t* __restrict__ s,
                                    int64_t* __restrict__ out, int64_t n,
                                    int64_t t) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i == 0) {
    out[0] = -1;
    return;
  }
  out[i] = (int64_t)((uint64_t)s[i - 1] * (uint64_t)t + (uint64_t)s[i]);
}

// Counts of the values in [0, n_bins); anything else (negative or too
// large) is skipped -- one unsigned compare covers both.  Each block keeps
// its own uint32 histogram in shared memory over a grid-stride loop, then
// adds its nonzero bins into the global int64 counts.  A block sees far
// fewer than 2^32 elements at any size that fits on the card.
__global__ void histogram_shared_kernel(const int64_t* __restrict__ s,
                                        unsigned long long* __restrict__ out,
                                        int64_t n, int64_t n_bins) {
  extern __shared__ uint32_t hist[];
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t v = (uint64_t)s[i];
    if (v < (uint64_t)n_bins) atomicAdd(&hist[v], 1u);
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) {
    uint32_t c = hist[b];
    if (c) atomicAdd(&out[b], (unsigned long long)c);
  }
}

// The same counts when n_bins does not fit in a block's shared memory:
// every in-range element adds straight into the global counts.
__global__ void histogram_global_kernel(const int64_t* __restrict__ s,
                                        unsigned long long* __restrict__ out,
                                        int64_t n, int64_t n_bins) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t v = (uint64_t)s[i];
    if (v < (uint64_t)n_bins) atomicAdd(&out[v], 1ull);
  }
}


// ---------------------------------------------------------------------------
// row_run_starts: the rows that start a run, compacted in one launch
// ---------------------------------------------------------------------------

// (n, k) int64 rows -> the indices i of the rows that differ from row i-1
// (row 0 always), in order.  With ``diff`` the rows compared are those of
// the first difference D[i] = V[i+1] - V[i] (n - 1 of them), taken here in
// wrapping unsigned arithmetic, as NumPy's int64 subtraction wraps.
//
// A block takes a tile of kRunTile compared rows from the tile counter, 4
// a thread.  With k = K in 1..2 (the template argument) a thread holds V's
// rows base-1 .. base+4 in registers: its own 4 rows by 2K 16-byte loads
// where V is 16-byte aligned and the rows lie inside it, the row before
// and (with diff) the row after by scalar loads from global memory -- a
// run that starts at a tile's first row is found from that halo row, never
// from a neighbour's shared memory.  Any other k (K = 0) reads each value
// from global memory.  The flags are counted with __popc, scanned over the
// block, and the tile's offset comes from the look-back; the last tile
// writes the total.
//
// status (from the wrapper, zeroed): [0] the tile counter, [1] the total,
// [2 + t] the look-back word of tile t.
constexpr int kRunRows = 4;
constexpr int kRunTile = kThreads * kRunRows;
constexpr int kWarps = kThreads / 32;

template <int K>
__global__ void __launch_bounds__(kThreads)
    row_run_starts_kernel(const int64_t* __restrict__ V, int64_t n,
                          int64_t k_any, int diff,
                          unsigned long long* status,
                          int64_t* __restrict__ out, int vec) {
  __shared__ int warp_incl[kWarps];
  __shared__ long long tile_s;
  __shared__ unsigned long long prefix_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t rows = diff ? n - 1 : n;
  const int64_t tile = lookback::take_tile(status, &tile_s);
  const int64_t base = tile * kRunTile + (int64_t)tid * kRunRows;
  const uint64_t* v = reinterpret_cast<const uint64_t*>(V);

  unsigned flags = 0;
  if constexpr (K > 0) {
    // r[j] is V's row base - 1 + j
    uint64_t r[6][K];
    if (vec && base + kRunRows <= n) {
      const ulonglong2* p = reinterpret_cast<const ulonglong2*>(v + base * K);
#pragma unroll
      for (int w = 0; w < 2 * K; ++w) {
        const ulonglong2 t = p[w];
        r[1 + 2 * w / K][2 * w % K] = t.x;
        r[1 + (2 * w + 1) / K][(2 * w + 1) % K] = t.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRunRows; ++j)
#pragma unroll
        for (int c = 0; c < K; ++c)
          r[1 + j][c] = base + j < n ? v[(base + j) * K + c] : 0;
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      r[0][c] = base >= 1 && base <= n ? v[(base - 1) * K + c] : 0;
      r[5][c] = diff && base + kRunRows < n ? v[(base + kRunRows) * K + c]
                                            : 0;
    }
#pragma unroll
    for (int q = 0; q < kRunRows; ++q) {
      bool f = base + q == 0;
#pragma unroll
      for (int c = 0; c < K; ++c)
        f |= diff ? r[q + 2][c] - r[q + 1][c] != r[q + 1][c] - r[q][c]
                  : r[q + 1][c] != r[q][c];
      if (base + q < rows && f) flags |= 1u << q;
    }
  } else {
    const int64_t k = k_any;
    for (int q = 0; q < kRunRows; ++q) {
      const int64_t i = base + q;
      if (i >= rows) break;
      bool f = i == 0;
      for (int64_t c = 0; c < k && !f; ++c) {
        const uint64_t a = v[(i - 1) * k + c], b = v[i * k + c];
        f = diff ? v[(i + 1) * k + c] - b != b - a : b != a;
      }
      if (f) flags |= 1u << q;
    }
  }

  int agg;
  const int excl =
      lookback::block_exclusive_scan<kThreads>(__popc(flags), warp_incl, &agg);
  if (warp == 0) {
    const unsigned long long prefix =
        lookback::tile_prefix(status + 2, tile, (unsigned)agg);
    if (lane == 0) {
      prefix_s = prefix;
      if (tile == (int64_t)gridDim.x - 1) status[1] = prefix + (unsigned)agg;
    }
  }
  __syncthreads();
  int64_t o = (int64_t)prefix_s + excl;
#pragma unroll
  for (int q = 0; q < kRunRows; ++q)
    if (flags >> q & 1u) out[o++] = base + q;
}

// ---------------------------------------------------------------------------
// digram_counts: the distinct pair codes and their counts
// ---------------------------------------------------------------------------

// The kernel walks the stream with a grid stride, 4 values a thread (two
// 16-byte loads where the stream is 16-byte aligned and the 4 lie inside
// it); the left neighbour of a thread's first value is the previous
// lane's last, by shuffle, and only lane 0 of a warp reads it from global
// memory.  Pair i (1 <= i < n) has the code s[i-1] * T + s[i], formed in
// registers.  A value outside [0, T) counts in no pair and sets the bad
// flag in status[0], so the wrapper raises instead of returning wrong
// counts.  The loop bound is the warp's first group, so whole warps stay
// in the loop and every lane takes part in the shuffle.
//
// IOR's stream puts almost every pair on two codes (lseek -> write and
// write -> lseek).  In shared memory that costs nothing measurable: on the
// H100 a warp's atomics on one counter ran as fast as on 32, while grouping
// the lanes by code with __match_any_sync ran slower wherever a warp holds
// many codes (PERF.md), so the kernel adds one per pair.
constexpr int kDgThreads = 1024;
constexpr int kDgVals = 4;
constexpr int kDgWarps = kDgThreads / 32;
// shared words the dense kernel needs besides its bins after the flush:
// the "last block" flag and the scan's warp totals
constexpr int kDgScratch = 1 + kDgWarps;

struct Group4 {
  int64_t v[kDgVals];  // the thread's values (0 past the end)
  int64_t left;        // the value before v[0] (0 where there is none)
  int64_t i0;          // the index of v[0]
};

__device__ __forceinline__ Group4 load_group(const int64_t* __restrict__ s,
                                             int64_t n, int64_t w, int vec) {
  const int lane = threadIdx.x & 31;
  Group4 g;
  g.i0 = kDgVals * (w + lane);
  // lane 0's left neighbour, loaded beside the values
  const int64_t left =
      (lane == 0 && g.i0 > 0 && g.i0 < n) ? s[g.i0 - 1] : 0;
  if (vec && g.i0 + kDgVals <= n) {
    const longlong2* p = reinterpret_cast<const longlong2*>(s + g.i0);
    const longlong2 a = p[0], b = p[1];
    g.v[0] = a.x;
    g.v[1] = a.y;
    g.v[2] = b.x;
    g.v[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < kDgVals; ++k)
      g.v[k] = g.i0 + k < n ? s[g.i0 + k] : 0;
  }
  const int64_t up = __shfl_up_sync(0xffffffffu, g.v[kDgVals - 1], 1);
  g.left = lane == 0 ? left : up;
  return g;
}

// While T^2 uint32 counters fit in a block's opt-in shared memory (T <=
// 241 on the H100; the wrapper counts a larger T with digram_codes and a
// sort on the card).  Each block counts into its own shared histogram,
// then adds its nonzero bins into the zeroed global table; the last block
// to finish (an atomic counter, after a fence) compacts the nonzero bins
// in code order into (codes, counts) and writes m.  Blocks of
// 1,024 threads keep enough loads in flight when T^2 counters leave room
// for one block an SM.  At T = 200 (40,000 bins) the flush, a global
// atomic a bin a block, and the compaction take longer than the count.
//
// status (zeroed): [0] bad flag, [1] blocks done, [2] m; table: T^2 zeroed
// u64 counts.
__global__ void __launch_bounds__(kDgThreads)
    digram_counts_dense_kernel(const int64_t* __restrict__ s, int64_t n,
                               int64_t t, unsigned long long* status,
                               unsigned long long* table,
                               int64_t* __restrict__ codes,
                               int64_t* __restrict__ counts, int vec) {
  extern __shared__ uint32_t hist[];  // max(T^2, kDgScratch) words
  const int tid = threadIdx.x, lane = tid & 31;
  const int bins = (int)(t * t);
  const uint64_t ut = (uint64_t)t;
  for (int b = tid; b < bins; b += kDgThreads) hist[b] = 0;
  __syncthreads();

  const int64_t groups = (n + kDgVals - 1) / kDgVals;
  const int64_t stride = (int64_t)gridDim.x * kDgThreads;
  bool bad = false;
  for (int64_t w = (int64_t)blockIdx.x * kDgThreads + tid - lane;
       w < groups; w += stride) {
    const Group4 g = load_group(s, n, w, vec);
    int64_t prev = g.left;
#pragma unroll
    for (int k = 0; k < kDgVals; ++k) {
      const int64_t i = g.i0 + k;
      const bool ok = (uint64_t)g.v[k] < ut;
      bad |= i < n && !ok;
      if (i < n && i > 0 && ok && (uint64_t)prev < ut)
        atomicAdd(&hist[prev * t + g.v[k]], 1u);
      prev = g.v[k];
    }
  }
  if (bad) atomicOr(status, 1ull);
  __syncthreads();
  for (int b = tid; b < bins; b += kDgThreads) {
    const uint32_t c = hist[b];
    if (c) atomicAdd(&table[b], (unsigned long long)c);
  }
  __threadfence();
  __syncthreads();  // the bins are read: their words are free now
  int* last = reinterpret_cast<int*>(hist);
  if (tid == 0) last[0] = atomicAdd(status + 1, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last[0]) return;
  __threadfence();

  int* warp_incl = last + 1;
  int64_t m = 0;
  for (int b0 = 0; b0 < bins; b0 += kDgThreads * kDgVals) {
    const int b = b0 + kDgVals * tid;
    unsigned long long c[kDgVals];
    int nz = 0;
#pragma unroll
    for (int k = 0; k < kDgVals; ++k) {
      c[k] = b + k < bins ? lookback::load_status(table + b + k) : 0;
      nz += c[k] != 0;
    }
    int total;
    int64_t o = m + lookback::block_exclusive_scan<kDgThreads>(
                        nz, warp_incl, &total);
#pragma unroll
    for (int k = 0; k < kDgVals; ++k)
      if (c[k]) {
        codes[o] = b + k;
        counts[o] = (int64_t)c[k];
        ++o;
      }
    m += total;
  }
  if (tid == 0) status[2] = (unsigned long long)m;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Blocks for a grid-stride kernel over ``groups`` groups of values: enough
// for all of them, at most as many as fit on the card at once.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            int64_t groups, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t want = (groups + threads - 1) / threads;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (unsigned)(want < 1 ? 1 : (want < most ? want : most));
  return cudaSuccess;
}

// Shared memory bytes of the dense route for T terminals.
int64_t dense_smem(int64_t t) {
  const int64_t words = t * t > kDgScratch ? t * t : kDgScratch;
  return words * (int64_t)sizeof(uint32_t);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int row_boundaries(const void* V, void* out, int64_t n, int64_t k,
                   void* stream) {
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  row_boundaries_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)V, (uint8_t*)out, n, k);
  return (int)cudaGetLastError();
}

int digram_codes(const void* s, void* out, int64_t n, int64_t t,
                 void* stream) {
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  digram_codes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)s, (int64_t*)out, n, t);
  return (int)cudaGetLastError();
}

// status: n_status >= 2 + ceil(rows / kRunTile) zeroed u64 (see
// row_run_starts_kernel), rows = n - 1 with diff, else n (>= 1); out: room
// for rows indices; the count lands in status[1]
int row_run_starts(const void* V, int64_t n, int64_t k, int64_t diff,
                   void* status, int64_t n_status, void* out, void* stream) {
  const int64_t rows = diff ? n - 1 : n;
  const int64_t tiles = (rows + kRunTile - 1) / kRunTile;
  if (rows < 1 || k < 1 || n_status < 2 + tiles)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(V);
  const unsigned blocks = (unsigned)tiles;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* v = (const int64_t*)V;
  unsigned long long* stat = (unsigned long long*)status;
  int64_t* o = (int64_t*)out;
  const int d = diff != 0;
  switch (k) {
    case 1:
      row_run_starts_kernel<1><<<blocks, kThreads, 0, st>>>(v, n, k, d, stat,
                                                            o, vec);
      break;
    case 2:
      row_run_starts_kernel<2><<<blocks, kThreads, 0, st>>>(v, n, k, d, stat,
                                                            o, vec);
      break;
    default:
      row_run_starts_kernel<0><<<blocks, kThreads, 0, st>>>(v, n, k, d, stat,
                                                            o, vec);
  }
  return (int)cudaGetLastError();
}

// The largest T the dense route of digram_counts takes on the current
// device: T^2 uint32 counters (and the kernel's own shared memory) within
// a block's opt-in shared memory.
int digram_dense_max_t(int64_t* max_t) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, digram_counts_dense_kernel);
  if (err != cudaSuccess) return (int)err;
  const int64_t room = (int64_t)smem_max - (int64_t)attr.sharedSizeBytes;
  int64_t t = 1;
  while (dense_smem(t + 1) <= room) ++t;
  *max_t = t;
  return (int)cudaSuccess;
}

// The distinct pair codes of a stream with values in [0, T) and their
// counts, for T <= digram_dense_max_t.  status: 3 zeroed u64, [0] the bad
// flag and [2] m when the launch ends; table: T^2 zeroed u64; codes and
// counts: room for min(n - 1, T^2) each.
int digram_counts(const void* s, int64_t n, int64_t t, void* status,
                  void* table, void* codes, void* counts, void* stream) {
  const int64_t smem = dense_smem(t);
  unsigned blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      digram_counts_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = resident_blocks((const void*)digram_counts_dense_kernel, kDgThreads,
                          (size_t)smem, (n + kDgVals - 1) / kDgVals, &blocks);
  if (err != cudaSuccess) return (int)err;
  digram_counts_dense_kernel<<<blocks, kDgThreads, (size_t)smem,
                               (cudaStream_t)stream>>>(
      (const int64_t*)s, n, t, (unsigned long long*)status,
      (unsigned long long*)table, (int64_t*)codes, (int64_t*)counts,
      aligned16(s));
  return (int)cudaGetLastError();
}

// ``out`` must hold n_bins zeros.  The shared-memory kernel runs while
// n_bins uint32 counters fit in the block's opt-in shared memory (227 KB
// on Hopper, 58,112 bins), the global one above that.  At most four blocks
// per SM walk the stream, so a block's zeroing and flush of its n_bins
// counters is paid a bounded number of times.
int histogram(const void* s, void* out, int64_t n, int64_t n_bins,
              void* stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t want = (n + kThreads - 1) / kThreads;
  unsigned blocks = (unsigned)(want < 4 * sms ? want : 4 * sms);
  int64_t smem = n_bins * (int64_t)sizeof(uint32_t);
  if (smem <= smem_max) {
    err = cudaFuncSetAttribute(histogram_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    histogram_shared_kernel<<<blocks, kThreads, (size_t)smem,
                              (cudaStream_t)stream>>>(
        (const int64_t*)s, (unsigned long long*)out, n, n_bins);
  } else {
    histogram_global_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)s, (unsigned long long*)out, n, n_bins);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
