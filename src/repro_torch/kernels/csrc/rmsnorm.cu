// Hopper kernel of the row-wise RMSNorm, with a plain C interface for
// ctypes (built by kernels/_build.py).
//
//   rmsnorm  replaces rmsnorm_pallas (src/repro/kernels/rmsnorm/rmsnorm.py:25)
//
// y = x * rsqrt(mean(x^2) + eps) * w, with the statistics in f32 and one
// cast back to x's type at the end (bf16 or f32 in, same type out, w f32).
// The function is bound by memory traffic: it reads every element once
// and writes it once, with a few flops each (at the serving path's
// prefill q, 262,144 rows x 128 bf16: 67 MB in + 67 MB out, 40 us at
// 3.35 TB/s).  Design: one warp per row and eight rows per 256-thread
// block, so any row count runs with a masked tail instead of the Pallas
// search for a divisor block; 16-byte loads and stores where the row
// length and the pointers allow, scalar ones otherwise; the sum of
// squares is a warp-shuffle reduction.  The row is read twice (sum, then
// scale); the second read of a row of up to a few KB hits L1/L2, so
// device memory sees it once.  Any d works; the loops stride by the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC > 1: x, out and w are 16-byte aligned and d % VEC == 0, so each lane
// moves VEC elements of x (16 bytes) per load; VEC == 1: scalar loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int64_t rows, int64_t d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* yr = out + row * d;
  float ss = 0.f;
  if constexpr (VEC > 1) {
    const int64_t nv = d / VEC;
    for (int64_t c = lane; c < nv; c += 32) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const float f = to_f(e[t]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int64_t c = lane; c < d; c += 32) {
      const float f = to_f(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
  if constexpr (VEC > 1) {
    const int64_t nv = d / VEC;
    for (int64_t c = lane; c < nv; c += 32) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
      float wv[VEC];
#pragma unroll
      for (int t = 0; t < VEC; t += 4) {
        const float4 w4 = reinterpret_cast<const float4*>(w + c * VEC)[t / 4];
        wv[t] = w4.x;
        wv[t + 1] = w4.y;
        wv[t + 2] = w4.z;
        wv[t + 3] = w4.w;
      }
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int t = 0; t < VEC; ++t) put(&o[t], to_f(e[t]) * r * wv[t]);
      reinterpret_cast<uint4*>(yr)[c] = res;
    }
  } else {
    for (int64_t c = lane; c < d; c += 32) put(&yr[c], to_f(xr[c]) * r * w[c]);
  }
}

template <typename T>
cudaError_t launch_rmsnorm(const void* x, const void* w, void* out,
                           int64_t rows, int64_t d, float eps,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)w % 16 == 0;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (vec)
    rmsnorm_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const float*)w, (T*)out, rows, d, eps);
  else
    rmsnorm_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const float*)w, (T*)out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x and out: (rows, d) row-major; w: (d,) f32.  dtype 0: float32,
// 1: bfloat16.
int rmsnorm(const void* x, const void* w, void* out, int64_t rows, int64_t d,
            float eps, int64_t dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_rmsnorm<float>(x, w, out, rows, d, eps, s);
  if (dtype == 1)
    return (int)launch_rmsnorm<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
