// Hopper kernel of the Mamba-2 SSD chunk scan, with a plain C interface for
// ctypes (built by kernels/_build.py).
//
//   ssd_scan  replaces ssd_scan_pallas
//             (src/repro/kernels/ssd_scan/ssd_scan.py:63)
//
// The math is the Pallas kernel's (_ssd_kernel, same file :25-60), per
// (batch, head) and chunk, with cs the cumulative sum of da over the chunk
// and tot = cs[Q-1]:
//
//   y[q] = exp(cs_q) (c_q . h)
//          + sum_{p <= q} (c_q . b_p) exp(cs_q - cs_p) dt_p x_p
//   h'   = exp(tot) h  +  sum_q b_q (outer) (dt_q exp(tot - cs_q) x_q)
//
// all in f32, y cast to x's type (f32 or bf16) at the end.  The decay
// exp(cs_q - cs_p) overflows to inf above the diagonal (q < p; cs falls as
// da <= 0), so it is computed only where q >= p and is never multiplied by
// a 0/1 mask (inf * 0 = NaN).  Besides y the kernel writes the state after
// the last chunk when it is asked for it (the prefill's decode cache); the
// Pallas kernel writes y only.
//
// Bound: bytes, narrowly.  At the mamba2-370m serve prefill (B 4, nc 8,
// Q 256, nh 32, hd 64, ns 128, bf16) the function moves 77.6 MB, 0.023 ms
// at 3.35 TB/s, and needs 21.5 GFLOP -- the causal triangle, Q(Q+1)/2
// pairs a chunk, plus c . h and the state update -- 0.022 ms at the
// 989 TFLOP/s of bf16 tensor cores, 0.32 ms at the 67 TFLOP/s f32
// CUDA-core peak.  (Pallas computes the full Q x Q tiles, 34.4 GFLOP; this
// kernel skips the tiles above the diagonal and executes 24.7 GFLOP.)
// This first kernel runs f32 FMAs on the CUDA cores; tensor cores (wgmma),
// TMA and a parallel pass over the chunk states are left for a later
// redesign.
//
// Design.  Pallas carries h in VMEM across the sequential minor grid axis
// nc.  Here one block owns one (batch, head) and walks the chunks itself,
// in order, with h in shared memory: B * nh blocks (128 at the mamba2
// prefill, 200 at hymba's), about one wave on the 132 SMs.  A chunk of
// Q = 256 rows does not fit in shared memory whole ((Q, Q) scores alone are
// 256 KB), so its rows and key columns are cut into 64-row tiles with
// masked tails: any Q from 1 up works (the model's divisor search gives
// Q = 1 for a prime prompt length).  For each 64-row query tile: the
// inter-chunk term from h, then for every key tile up to the diagonal the
// (64, 64) scores c . b (float4 reads along ns), the decay-weighted masked
// weights into shared memory, and their product with the x tile.  When
// every query tile has read h, h is scaled by exp(tot) and the chunk's
// outer products are added, one key tile at a time.  256 threads: thread
// (ty, tx) owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < J,
// J = ceil(hd / 16) rounded up to 1, 2, 4 or 8) of a tile, and state rows
// ty + 16 i.  b and c are shared by all heads (group 1) and are read again
// by every head's block, as in Pallas; L2 serves the repeats.  x, b and c
// are read through their strides (the model passes column slices of the
// convolution's output, viewed as chunks), so the wrapper makes no copies;
// dt and da are contiguous (B, nc, Q, nh).  The block needs 50-144 KB of
// shared memory at the serve shapes, above the 48 KB default, so the
// launch raises the limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;  // query rows and key columns per tile
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Dims {
  int nc, Q, nh, hd, ns;
  int64_t xsb, xsc, xsq, xsh;  // x strides in elements (unit along hd)
  int64_t bsb, bsc, bsq;       // b strides (unit along ns)
  int64_t csb, csc, csq;       // c strides (unit along ns)
};

// Shared-memory layout, in floats.  b and c rows are padded to a multiple
// of 4 plus 4, so the float4 reads of 8 rows in a quarter warp hit
// distinct banks; state rows to 16 J plus 16 when J is even, so the two
// rows a warp touches sit 16 banks apart.
__host__ __device__ constexpr int ns_pad(int ns) {
  return (ns + 3) / 4 * 4 + 4;
}
template <int J>
__host__ __device__ constexpr int h_pad() { return 16 * J + (J % 2 ? 0 : 16); }
template <int J>
__host__ __device__ inline size_t smem_floats(int Q, int ns) {
  return 2 * (size_t)kT * ns_pad(ns)  // c tile, b tile
         + (size_t)ns * h_pad<J>()    // state
         + (size_t)kT * 16 * J        // x tile
         + (size_t)kT * (kT + 1)      // weights
         + 2 * (size_t)Q;             // cs, dt
}

// rows r0 .. r0 + 63 of an (R, n) matrix (row r at src + r * stride, unit
// stride along n) into dst (64, ld) as f32, zero past R rows and n columns
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int r0, int R,
                                          int n) {
  for (int e = threadIdx.x; e < kT * ld; e += kThreads) {
    const int r = e / ld, s = e - r * ld;
    const int q = r0 + r;
    dst[e] = (q < R && s < n) ? to_f(src[(int64_t)q * stride + s]) : 0.f;
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ b,
                    const T* __restrict__ c, const float* __restrict__ dt,
                    const float* __restrict__ da, T* __restrict__ y,
                    float* __restrict__ hfin, Dims d) {
  extern __shared__ float4 smem4[];
  const int Q = d.Q, ns = d.ns, hd = d.hd;
  const int nsp = ns_pad(ns), ns4 = (ns + 3) / 4 * 4;
  constexpr int HP = h_pad<J>(), XP = 16 * J;
  float* Cs = reinterpret_cast<float*>(smem4);  // (64, nsp)
  float* Bs = Cs + kT * nsp;                     // (64, nsp)
  float* Hs = Bs + kT * nsp;                     // (ns, HP)
  float* Xs = Hs + ns * HP;                      // (64, XP)
  float* Ws = Xs + kT * XP;                      // (64, 65)
  float* cs = Ws + kT * (kT + 1);                // (Q,)
  float* dts = cs + Q;                           // (Q,)

  const int head = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < ns * HP; e += kThreads) Hs[e] = 0.f;

  for (int ch = 0; ch < d.nc; ++ch) {
    const int64_t row0 = ((int64_t)bi * d.nc + ch) * Q;  // dt/da row of q=0
    const T* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
    const T* bc = b + bi * d.bsb + ch * d.bsc;
    const T* cc = c + bi * d.csb + ch * d.csc;
    for (int q = tid; q < Q; q += kThreads)
      dts[q] = dt[(row0 + q) * d.nh + head];
    if (warp == 0) {  // inclusive scan of da, 32 rows at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int q = base + lane;
        float v = q < Q ? da[(row0 + q) * d.nh + head] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += n;
        }
        v += carry;
        if (q < Q) cs[q] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float tot = cs[Q - 1];

    for (int q0 = 0; q0 < Q; q0 += kT) {
      load_rows(Cs, nsp, cc, d.csq, q0, Q, ns);
      __syncthreads();
      float inter[4][J], intra[4][J];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) inter[i][j] = intra[i][j] = 0.f;
      // inter-chunk: c_q . h (columns of Hs past hd hold 0)
      for (int s = 0; s < ns; ++s) {
        float hv[J];
#pragma unroll
        for (int j = 0; j < J; ++j) hv[j] = Hs[s * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cv = Cs[(ty + 16 * i) * nsp + s];
#pragma unroll
          for (int j = 0; j < J; ++j)
            inter[i][j] = fmaf(cv, hv[j], inter[i][j]);
        }
      }
      // intra-chunk: key tiles up to the diagonal
      const int kend = min(q0 + kT, Q);
      for (int p0 = 0; p0 < kend; p0 += kT) {
        load_rows(Bs, nsp, bc, d.bsq, p0, Q, ns);
        load_rows(Xs, XP, xc, d.xsq, p0, Q, hd);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[i][k] = 0.f;
        for (int s = 0; s < ns4; s += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(
                &Cs[(ty + 16 * i) * nsp + s]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            bv[k] = *reinterpret_cast<const float4*>(
                &Bs[(tx + 16 * k) * nsp + s]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float a = sc[i][k];
              a = fmaf(cv[i].x, bv[k].x, a);
              a = fmaf(cv[i].y, bv[k].y, a);
              a = fmaf(cv[i].z, bv[k].z, a);
              sc[i][k] = fmaf(cv[i].w, bv[k].w, a);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = q0 + ty + 16 * i, p = p0 + tx + 16 * k;
            // select, never mask: exp(cs_q - cs_p) is inf for q < p
            Ws[(ty + 16 * i) * (kT + 1) + tx + 16 * k] =
                (q < Q && p <= q) ? sc[i][k] * expf(cs[q] - cs[p]) * dts[p]
                                  : 0.f;
          }
        __syncthreads();
        const int np = min(kT, Q - p0);
        for (int pp = 0; pp < np; ++pp) {
          float xv[J];
#pragma unroll
          for (int j = 0; j < J; ++j) xv[j] = Xs[pp * XP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = Ws[(ty + 16 * i) * (kT + 1) + pp];
#pragma unroll
            for (int j = 0; j < J; ++j)
              intra[i][j] = fmaf(w, xv[j], intra[i][j]);
          }
        }
        __syncthreads();  // Bs, Xs, Ws and Cs are rewritten next
      }
      T* yc = y + (row0 * d.nh + head) * (int64_t)hd;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
        const float e = expf(cs[q]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int col = tx + 16 * j;
          if (col < hd)
            put(&yc[(int64_t)q * d.nh * hd + col],
                e * inter[i][j] + intra[i][j]);
        }
      }
    }

    // state update; every query tile has read h (synced above).  Thread
    // (ty, tx) owns state rows ty + 16 i, columns tx + 16 j.
    const float etot = expf(tot);
    for (int s = ty; s < ns; s += 16)
#pragma unroll
      for (int j = 0; j < J; ++j) Hs[s * HP + tx + 16 * j] *= etot;
    for (int p0 = 0; p0 < Q; p0 += kT) {
      load_rows(Bs, nsp, bc, d.bsq, p0, Q, ns);
      load_rows(Xs, XP, xc, d.xsq, p0, Q, hd);
      __syncthreads();
      // x_p scaled by dt_p exp(tot - cs_p), in that order (as Pallas)
      for (int e = tid; e < kT * XP; e += kThreads) {
        const int p = p0 + e / XP;
        if (p < Q) Xs[e] = dts[p] * expf(tot - cs[p]) * Xs[e];
      }
      __syncthreads();
      const int np = min(kT, Q - p0);
      for (int s = ty; s < ns; s += 16) {
        float acc[J];
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = 0.f;
        for (int pp = 0; pp < np; ++pp) {
          const float bv = Bs[pp * nsp + s];
#pragma unroll
          for (int j = 0; j < J; ++j)
            acc[j] = fmaf(bv, Xs[pp * XP + tx + 16 * j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) Hs[s * HP + tx + 16 * j] += acc[j];
      }
      __syncthreads();
    }
  }

  if (hfin != nullptr) {
    float* hb = hfin + ((int64_t)bi * d.nh + head) * ns * hd;
    for (int e = tid; e < ns * hd; e += kThreads) {
      const int s = e / hd, col = e - s * hd;
      hb[e] = Hs[s * HP + col];
    }
  }
}

template <typename T, int J>
cudaError_t launch_j(const void* x, const void* b, const void* c,
                     const void* dt, const void* da, void* y, void* hfin,
                     int64_t B, const Dims& d, cudaStream_t stream) {
  const size_t bytes = smem_floats<J>(d.Q, d.ns) * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)d.nh, (unsigned)B);
  ssd_scan_kernel<T, J><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, (const T*)b, (const T*)c, (const float*)dt,
      (const float*)da, (T*)y, (float*)hfin, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* b, const void* c,
                     const void* dt, const void* da, void* y, void* hfin,
                     int64_t B, const Dims& d, cudaStream_t s) {
  if (d.hd <= 16) return launch_j<T, 1>(x, b, c, dt, da, y, hfin, B, d, s);
  if (d.hd <= 32) return launch_j<T, 2>(x, b, c, dt, da, y, hfin, B, d, s);
  if (d.hd <= 64) return launch_j<T, 4>(x, b, c, dt, da, y, hfin, B, d, s);
  if (d.hd <= 128) return launch_j<T, 8>(x, b, c, dt, da, y, hfin, B, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, nc, Q, nh, hd) and y (contiguous, same shape); b, c (B, nc, Q, ns);
// dt, da (B, nc, Q, nh) f32 contiguous; hfin (B, nh, ns, hd) f32 or null.
// Strides are in elements; x, b and c have unit stride in their last
// dimension.  dtype (of x, b, c and y) 0: float32, 1: bfloat16.
int ssd_scan(const void* x, const void* b, const void* c, const void* dt,
             const void* da, void* y, void* hfin, int64_t B, int64_t nc,
             int64_t Q, int64_t nh, int64_t hd, int64_t ns, int64_t xsb,
             int64_t xsc, int64_t xsq, int64_t xsh, int64_t bsb, int64_t bsc,
             int64_t bsq, int64_t csb, int64_t csc, int64_t csq,
             int64_t dtype, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || nh < 1 || hd < 1 || ns < 1 || B > 65535 ||
      nh > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Dims d{(int)nc, (int)Q,  (int)nh, (int)hd, (int)ns, xsb, xsc, xsq,
               xsh,     bsb,     bsc,     bsq,     csb,     csc, csq};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_t<float>(x, b, c, dt, da, y, hfin, B, d, s);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(x, b, c, dt, da, y, hfin, B, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
