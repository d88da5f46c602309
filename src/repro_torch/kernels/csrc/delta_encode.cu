// Hopper kernels of the timestamp and varint encode paths, with a plain C
// interface for ctypes (built by kernels/_build.py).
//
//   delta_zigzag      replaces delta_zigzag_pallas
//                     (src/repro/kernels/delta_encode/delta_encode.py:40)
//   uvarint_encode64  replaces uvarint_encode64_pallas (same file, :155)
//   fit_columns       replaces fit_columns_pallas (same file, :202)
//
// All three are bound by memory traffic: each reads its input once and
// writes its output once, with a handful of integer operations per byte.
// At the tracer's sizes (tens of thousands of elements per call) the time
// is launch latency and the host<->device copies, not HBM bandwidth.
//
// The TPU versions walk the grid in order and carry the previous block's
// last element in VMEM scratch; here blocks run in any order, so every
// thread reads its left neighbour straight from global memory instead.
// Fixed 256-thread blocks with a masked tail replace the Pallas
// shrink-to-a-divisor block loop.  Each entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// flat u32 ticks -> zigzag of the first-order delta, wrapped mod 2^32
// (element 0 is taken against 0, i.e. kept).  All arithmetic is unsigned:
// signed overflow and left shifts of negative values are UB in C++.
__global__ void delta_zigzag_kernel(const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t prev = i ? x[i - 1] : 0u;
  uint32_t d = x[i] - prev;
  out[i] = (d << 1) ^ (0u - (d >> 31));
}

// u64 values -> varint byte counts and (10, n) byte planes: plane j holds
// bits 7j..7j+6 of every value, with the continuation bit set when the
// value needs more bytes.  The host scatters the planes into the stream.
__global__ void uvarint_encode64_kernel(const uint64_t* __restrict__ v,
                                        int32_t* __restrict__ lens,
                                        uint8_t* __restrict__ planes,
                                        int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t x = v[i];
  int len = 1;
#pragma unroll
  for (int k = 1; k < 10; ++k) len += x >= (1ull << (7 * k));
  lens[i] = len;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    uint32_t b = (uint32_t)((x >> (7 * j)) & 0x7Full);
    if (j < len - 1) b |= 0x80u;
    planes[(int64_t)j * n + i] = (uint8_t)b;
  }
}

// (C, R) int64 matrix -> per row: flag 1 if every first-order delta is 0,
// 2 if every delta equals a nonzero first delta, else 0; and the first
// delta.  One warp per row; lanes stride over the deltas and two warp
// votes reduce them.  Rows past C exit as whole warps.
__global__ void fit_columns_kernel(const int64_t* __restrict__ V,
                                   int32_t* __restrict__ flags,
                                   int64_t* __restrict__ d0_out, int64_t c,
                                   int64_t r) {
  int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= c) return;
  const uint64_t* v = reinterpret_cast<const uint64_t*>(V) + row * r;
  uint64_t d0 = v[1] - v[0];
  bool zero = true, same = true;
  for (int64_t j = 1 + lane; j < r; j += 32) {
    uint64_t d = v[j] - v[j - 1];
    zero &= d == 0;
    same &= d == d0;
  }
  zero = __all_sync(0xffffffffu, zero);
  same = __all_sync(0xffffffffu, same);
  if (lane == 0) {
    flags[row] = zero ? 1 : ((same && d0 != 0) ? 2 : 0);
    d0_out[row] = (int64_t)d0;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int delta_zigzag(const void* x, void* out, int64_t n, void* stream) {
  delta_zigzag_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int uvarint_encode64(const void* v, void* lens, void* planes, int64_t n,
                     void* stream) {
  uvarint_encode64_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint64_t*)v, (int32_t*)lens, (uint8_t*)planes, n);
  return (int)cudaGetLastError();
}

int fit_columns(const void* V, void* flags, void* d0, int64_t c, int64_t r,
                void* stream) {
  int64_t threads = c * 32;  // one warp per row
  unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  fit_columns_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)V, (int32_t*)flags, (int64_t*)d0, c, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
