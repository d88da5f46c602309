// Hopper kernel of forward flash attention, with a plain C interface for
// ctypes (built by kernels/_build.py).
//
//   flash_attention  replaces flash_attention_pallas
//                    (src/repro/kernels/flash_attention/flash_attention.py:72)
//
// The math is the Pallas kernel's (_attn_kernel, same file :30-69): f32
// scores scaled by 1/sqrt(D), masked entries set to -1e30 and their p
// zeroed explicitly (never left to exp underflow), a running max and
// denominator in f32, p kept in f32 for p @ v, and the output
// acc / max(l, 1e-30) cast to the input type.  GQA: query head h reads KV
// head h / group directly; k and v are never repeated.
//
// Bound: compute.  At the serving path's prefill (B 4, S 1024, H 64, KVH 8,
// D 128, causal, bf16) the work is 68.7 GFLOP -- 69 us at the 989 TFLOP/s
// of bf16 tensor cores -- against about 151 MB moved, 45 us at 3.35 TB/s.
// This first kernel does not use the tensor cores: it runs f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), so its floor is about 1 ms there.
// Tensor cores (wgmma), TMA loads and warp specialisation are left for a
// later redesign.
//
// Design.  Pallas walks kv blocks as the sequential minor grid axis and
// carries (acc, m, l) in VMEM scratch across grid steps.  Here one thread
// block owns one (batch, head, 64-row q tile) and loops over 32-key kv
// tiles itself; nothing carries across blocks.  The q tile and each k, v
// tile are converted to f32 into shared memory (rows padded by 4 floats so
// the float4 reads of a score's dot product hit distinct banks).  256
// threads: thread (ty, tx) owns rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 2) and output columns tx + 16 j (j < D/16); a row's max
// and sum are shuffles over the 16 lanes that share it.  p goes through
// shared memory for p @ v.  Fixed tiles with masked tails replace the
// Pallas search for a divisor block, so a prime S costs no more than its
// neighbours.  kv tiles that the causal or window mask empties for every
// row of the q tile are skipped (they would add exactly nothing), and the
// q tiles with the most causal work are scheduled first.  The inputs are
// read through their strides in the (B, S, H, D) layout, so the wrapper
// makes no transposed copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per kv tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int D>
struct Tile {
  static constexpr int kDP = D + 4;    // padded q/k row, floats
  static constexpr int kPP = kBK + 4;  // padded p row, floats
  static constexpr int kFloats = kBQ * kDP + kBK * kDP + kBK * D + kBQ * kPP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Skv, int H, int group, int64_t qsb,
                           int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                           int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                           float scale, int causal, int window) {
  static_assert(D % 4 == 0 && D <= 128, "D must be a multiple of 4, <= 128");
  constexpr int kDP = Tile<D>::kDP, kPP = Tile<D>::kPP;
  constexpr int kCols = (D + 15) / 16;  // output columns per thread
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // kBQ x kDP
  float* Ks = Qs + kBQ * kDP;                  // kBK x kDP
  float* Vs = Ks + kBK * kDP;                  // kBK x D
  float* Ps = Vs + kBK * D;                    // kBQ x kPP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * kDP + d] = s < Sq ? to_f(qb[s * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the kv range some row of this q tile can see
  const int q_end = min(q0 + kBQ, Sq);
  const int kv_end = causal ? min(Skv, q_end) : Skv;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin -= kv_begin % kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < Skv;
      Ks[r * kDP + d] = in ? to_f(kb[s * kss + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kDP + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kDP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = sc[i][j];
          s = fmaf(a[i].x, c[j].x, s);
          s = fmaf(a[i].y, c[j].y, s);
          s = fmaf(a[i].z, c[j].z, s);
          s = fmaf(a[i].w, c[j].w, s);
          sc[i][j] = s;
        }
    }

    // online softmax: rows ty + 16 i, their 32 columns spread over 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[2];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Skv && (!causal || qi >= kj) &&
                (window <= 0 || kj > qi - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p @ v
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * D;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;
          const float vv = col < D ? vrow[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(lane_of(p4[i], cc), vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < D) put(&orow[col], acc[i][j] / denom);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int64_t B, Sq, Skv, H, KVH;
  int64_t qs[3], ks[3], vs[3];
  float scale;
  int causal, window;
};

template <typename T, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)a.H,
                  (unsigned)a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, (int)a.Sq,
      (int)a.Skv, (int)a.H, (int)(a.H / a.KVH), a.qs[0], a.qs[1], a.qs[2],
      a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, int64_t D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_d<T, 8>(a, stream);
    case 16: return launch_d<T, 16>(a, stream);
    case 32: return launch_d<T, 32>(a, stream);
    case 64: return launch_d<T, 64>(a, stream);
    case 128: return launch_d<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), each with unit stride in D and
// the given element strides for (B, S, H); out (B, Sq, H, D) contiguous.
// dtype 0: float32, 1: bfloat16.  D in {8, 16, 32, 64, 128}.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                    int64_t KVH, int64_t D, int64_t qsb, int64_t qss,
                    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, float scale,
                    int64_t causal, int64_t window, int64_t dtype,
                    void* stream) {
  const Args a{q,   k,   v,   out, B,     Sq,        Skv,
               H,   KVH, {qsb, qss, qsh}, {ksb, kss, ksh},
               {vsb, vss, vsh}, scale, (int)causal, (int)window};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_t<float>(a, D, s);
  if (dtype == 1) return (int)launch_t<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
