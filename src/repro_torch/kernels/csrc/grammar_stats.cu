// Hopper kernel of the run-boundary scan, with a plain C interface for
// ctypes (built by kernels/_build.py).
//
//   row_boundaries  replaces row_boundaries_pallas
//                   (src/repro/kernels/grammar_stats/grammar_stats.py:48)
//
// Bound by memory traffic: n*k int64 reads (each row read by its own
// thread and, as the left neighbour, by the next one -- the second read
// hits L1/L2) and n one-byte writes.  At the tracer's sizes the time is
// launch latency and the host<->device copies.
//
// The TPU version carries the previous block's last row in VMEM across a
// sequential grid; here each thread compares its row with row i-1 straight
// from global memory, so blocks are independent.  Row 0 is always 1.

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

}  // extern "C"
