// Hopper kernels of the symbol-stream statistics, with a plain C interface
// for ctypes (built by kernels/_build.py).
//
//   row_boundaries  replaces row_boundaries_pallas
//                   (src/repro/kernels/grammar_stats/grammar_stats.py:48)
//   histogram       replaces histogram_pallas (same file, :79)
//   digram_codes    replaces digram_codes_pallas (same file, :113)
//
// All three are bound by memory traffic: each reads its int64 input once
// (a left neighbour is read a second time, from L1/L2) and writes its
// output once, with a few integer operations per element.  At the
// tracer's sizes the time is launch latency and the host<->device copies.
//
// The TPU versions walk a sequential grid: row_boundaries and
// digram_codes carry the previous block's last element in VMEM, and
// histogram accumulates into one output tile across grid steps.  Here
// blocks run in any order, so each thread reads element i-1 straight from
// global memory, and histogram blocks add their partial counts into the
// output with atomics (integer counts, so the order of the adds does not
// change the result).  Fixed 256-thread blocks with a masked tail replace
// the Pallas shrink-to-a-divisor block loop.

#include <cuda_runtime.h>
#include <stdint.h>

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
