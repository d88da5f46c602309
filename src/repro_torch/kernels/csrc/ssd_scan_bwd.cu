// The gradient of the Mamba-2 SSD chunk scan (ssd_scan.cu's function), in
// f32 on the CUDA cores, with a plain C interface for ctypes (built by
// kernels/_build.py).  The JAX package trains through XLA's autodiff and
// has no backward kernel; this one computes the gradient of the plain
// chunked version (ssd_scan/ref.py:ssd_scan_chunked_ref) in the passes of
// ssd_scan/ref.py:ssd_scan_bwd_passes_ref.  Per (batch, head) and chunk,
// with cs the cumulative sum of da over the chunk, tot = cs[Q-1], H_c the
// state entering chunk c and D_c the gradient of the state leaving it:
//
//   a  ssdbwd_state  one block per (batch, chunk, head): cs and tot into
//      scratch, S_c = sum_q b_q (outer) dt_q exp(tot - cs_q) x_q and
//      R_c = sum_q c_q (outer) exp(cs_q) dy_q, (ns, hd) each.
//   b  ssdbwd_walk   one thread per (batch, head, state entry): the walk
//      H_0 = h_in, H_{c+1} = exp(tot_c) H_c + S_c forward over the chunks
//      and D_{nc-1} = d_in, D_{c-1} = exp(tot_c) D_c + R_c backward, in
//      place (S_c becomes H_c, R_c becomes D_c).
//   c1 ssdbwd_pairs  one block per (batch, chunk, 64 x 64 tile pair on or
//      below the diagonal): the scores c b^T and, summed over the heads in
//      order, M = dy x^T exp(cs_q - cs_p) dt_p on p <= q; both into
//      scratch (B, nc, pairs, 64, 64).  They are shared by the heads, so
//      no (B, nh, Q, Q) tensor exists.
//   c2 ssdbwd_chunk  one block per (batch, chunk, head): with
//      W = (c b^T) exp(cs_q - cs_p) dt_p and dW = dy x^T on p <= q,
//      u_p = b_p . D_c and s_p = dt_p exp(tot - cs_p) u_p . x_p,
//        dx_p  = sum_q W_qp dy_q + dt_p exp(tot - cs_p) u_p
//        ddt_p = sum_q dW_qp (c_q . b_p) exp(cs_q - cs_p)
//                + exp(tot - cs_p) u_p . x_p
//        dcs_q = exp(cs_q) (c_q . H_c) . dy_q + sum_p dW_qp W_qp
//                - sum_q' dW_q'q W_q'q - s_q
//        dcs_{Q-1} += exp(tot) <D_c, H_c> + sum_q s_q
//      and dda, the reverse cumulative sum of dcs over the chunk.
//   c3 ssdbwd_bc     one block per (batch, chunk, 64-row tile) and each of
//      dc and db: the heads' sums
//      dc_q = sum_p M_qp b_p + sum_h exp(cs_q) H_c dy_q  and
//      db_p = sum_q M_qp c_q + sum_h dt_p exp(tot - cs_p) D_c x_p.
//
// Every product and sum is an f32 FMA on the CUDA cores, as the plain
// version computes with TF32 off; x, b, c and dy are read as bf16 or f32
// and dx, db, dc written in their type, ddt and dda in f32.  The decay
// exp(cs_q - cs_p) is computed only where p <= q (above the diagonal it
// overflows when da is strongly negative), so the gradient there is 0,
// never NaN.  Every sum runs in a fixed order inside one block and no
// block adds into another's output: the same inputs give the same bits.
//
// The wrapper (ssd_scan/ops.py) bounds the scratch by running the passes
// over groups of at most G chunks, the last group first: when there is
// more than one group, a first walk over the groups (passes a and b
// without dy) keeps the state entering each, and D crosses a group
// boundary in f32 as it crosses a chunk boundary.  One call counts as one
// ssd_scan_bwd launch.  The device kernels' names start with ssdbwd_, so
// the profile tells them from the forward kernels' (ssd_chunk_state,
// ssd_state_pass, ssd_chunk_out, ssd_scan_kernel).
//
// Tiles: 256 threads a block; thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16 a (a < 4) and columns tx + 16 j of a 64-row tile, J = 1, 4
// or 8 as hd is at most 16, 64 or 128 (in c3, JS from ns alike), or, in
// the products that read their operands along those rows, the blocks
// blk(ty, a) and blk(tx, j) below.  Tiles are zero past Q rows.  Bound
// (mamba2-370m's training step, B 16, nc 8, Q 256, nh 32, hd 64, ns 128,
// bf16): twice the forward's 52.7 GFLOP at the 67 TFLOP/s of f32 CUDA
// cores, 1.575 ms, against 453 MB at 3.35 TB/s, 0.135 ms; PERF.md has
// the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kT = 64;            // rows of a tile
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kTileF = kT * kT;   // floats of one stored 64 x 64 tile
constexpr int kWP = kT + 1;       // row stride of a 64 x 64 tile in smem
constexpr int kWP4 = kT + 4;      // the same, read 16 bytes at a time

struct Dims {
  int nc, Q, nh, hd, ns;       // nc: chunks of this group
  int64_t xsb, xsc, xsq, xsh;  // x strides in elements (unit along hd)
  int64_t bsb, bsc, bsq;       // b strides (unit along ns)
  int64_t csb, csc, csq;       // c strides (unit along ns)
  int ncs;                     // chunks of the call: batch stride of dy,
                               // dt, da and the outputs
  int nt, npairs;              // 64-row tiles of a chunk; tile pairs
};

// Scratch of one group, in floats: the scores and M (B, nc, npairs, 64,
// 64), the entering states H and the leaving states' gradients D (B, nc,
// nh, ns, hd), cs (B, nc, nh, Q), tot (B, nc, nh); in that order, so that
// the regions read 16 bytes at a time start 16-byte aligned.
struct Scratch {
  float *H, *D, *cs, *tot, *sc, *m;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ T out_as(float v);
template <>
__device__ __forceinline__ float out_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 out_as<bf16>(float v) {
  return __float2bfloat16(v);
}

// a row stride of f32 values read as float4 by 8 rows at once: a
// multiple of 4 plus 4, so that the rows hit distinct banks
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4 + 4; }

// two adjacent values of a row, as f32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// rows r0 .. r0 + rows - 1 of an (R, n) matrix (row r at src + r *
// stride, unit stride along n) into dst (rows, ld) as f32, row r0 + r times
// scale[r] when scale is given; zero past R rows and n columns, up to n
// rounded up to 4 (the columns past that are left as they are: no product
// reads them into an output that is kept).  A warp takes 8 rows at a time,
// its lanes the columns, two at a time where the addresses allow, and
// each lane issues its 8 loads before it stores any.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld_, const T* src,
                                          int64_t stride, int r0, int R,
                                          int n, int rows,
                                          const float* scale = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = (n + 3) / 4 * 4;
  const bool two = n % 2 == 0 && stride % 2 == 0 && ld_ % 2 == 0 &&
                   (uintptr_t)src % (2 * sizeof(T)) == 0;
  for (int rb = 0; rb < rows; rb += 64) {
    if (two) {
      for (int col = 2 * lane; col < n4; col += 64) {
        float2 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rb + warp + 8 * i, q = r0 + r;
          v[i] = (r < rows && q < R && col < n)
                     ? ld2(src + (int64_t)q * stride + col)
                     : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rb + warp + 8 * i;
          if (r >= rows) continue;
          // the scale holds the rows below R only
          const float f = scale != nullptr && r0 + r < R ? scale[r] : 1.f;
          *reinterpret_cast<float2*>(dst + r * ld_ + col) =
              make_float2(f * v[i].x, f * v[i].y);
        }
      }
    } else {
      for (int col = lane; col < n4; col += 32) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rb + warp + 8 * i, q = r0 + r;
          v[i] = (r < rows && q < R && col < n)
                     ? ld(src + (int64_t)q * stride + col)
                     : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rb + warp + 8 * i;
          if (r < rows)
            dst[r * ld_ + col] =
                scale != nullptr && r0 + r < R ? scale[r] * v[i] : v[i];
        }
      }
    }
  }
}

// a 64-row tile: rows r0 .. r0 + 63
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld_, const T* src,
                                          int64_t stride, int r0, int R,
                                          int n,
                                          const float* scale = nullptr) {
  load_tile(dst, ld_, src, stride, r0, R, n, kT, scale);
}

// rows 0 .. rows - 1 of an (R, n) f32 matrix of row stride src_ld into dst
// (rows, ld), zero past R rows and n columns: 16 bytes a load when n and
// src_ld are multiples of 4 (src is 16-byte aligned: the scratch's rows)
__device__ __forceinline__ void load_f32(float* dst, int ld_,
                                         const float* src, int src_ld, int R,
                                         int n, int rows) {
  if (n % 4 || src_ld % 4) {
    load_tile(dst, ld_, src, (int64_t)src_ld, 0, R, n, rows);
    return;
  }
  constexpr int kN = 8;
  const int n4 = (ld_ + 3) / 4, total = rows * n4;
  for (int base = threadIdx.x; base < total; base += kThreads * kN) {
    float4 v[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = base + kThreads * i;
      const int r = e / n4, c = 4 * (e - r * n4);
      v[i] = (e < total && r < R && c < n)
                 ? *reinterpret_cast<const float4*>(src + (int64_t)r * src_ld
                                                    + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = base + kThreads * i;
      const int r = e / n4, c = 4 * (e - r * n4);
      if (e >= total) continue;
      float* o = dst + r * ld_ + c;
      o[0] = v[i].x;
      if (c + 1 < ld_) o[1] = v[i].y;
      if (c + 2 < ld_) o[2] = v[i].z;
      if (c + 3 < ld_) o[3] = v[i].w;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src to dst (shared memory) in the background, or 16 zero
// bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an (ns, hd) f32 state into dst (rows, ld), zero past ns rows and hd
// columns
__device__ __forceinline__ void load_state(float* dst, int ld_,
                                           const float* src, int ns, int hd,
                                           int rows) {
  load_f32(dst, ld_, src, hd, ns, hd, rows);
}

// acc[a][j] += sum_k A[k][ty + 16 a] B[k][tx + 16 j]   (A^T B)
template <int I, int J>
__device__ __forceinline__ void mm_tn(float (&acc)[I][J], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float bv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < I; ++a) {
      const float av = A[k * lda + ty + 16 * a];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[a][j] = fmaf(av, bv[j], acc[a][j]);
    }
  }
}

// acc[a][j] += sum_k A[ty + 16 a][k] B[k][tx + 16 j]   (A B)
template <int I, int J>
__device__ __forceinline__ void mm_nn(float (&acc)[I][J], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float bv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < I; ++a) {
      const float av = A[(ty + 16 * a) * lda + k];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[a][j] = fmaf(av, bv[j], acc[a][j]);
    }
  }
}

// acc[a][j] += sum_k A[ty + 16 a][k] B[tx + 16 j][k]   (A B^T), K a
// multiple of 4 and both strides multiples of 4 (float4 reads)
template <int I, int J>
__device__ __forceinline__ void mm_nt(float (&acc)[I][J], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; k += 4) {
    float4 av[I], bv[J];
#pragma unroll
    for (int a = 0; a < I; ++a)
      av[a] = *reinterpret_cast<const float4*>(&A[(ty + 16 * a) * lda + k]);
#pragma unroll
    for (int j = 0; j < J; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * ldb + k]);
#pragma unroll
    for (int a = 0; a < I; ++a)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float s = acc[a][j];
        s = fmaf(av[a].x, bv[j].x, s);
        s = fmaf(av[a].y, bv[j].y, s);
        s = fmaf(av[a].z, bv[j].z, s);
        acc[a][j] = fmaf(av[a].w, bv[j].w, s);
      }
  }
}

// The products below whose operands are read along the rows they own
// (A^T B, A B) give each thread a block of rows and of columns instead,
// so that its values of one row of A or B are adjacent and are read 16
// bytes at a time: blk<N>(t, i), for t = ty or tx and i < N, is
// 4 t + i % 4 + 64 (i / 4) for N >= 4 (16-byte groups 64 apart), else
// N t + i.
template <int N>
__device__ __forceinline__ int blk(int t, int i) {
  return N >= 4 ? 4 * t + (i & 3) + 64 * (i >> 2) : N * t + i;
}

// v[i] = p[blk<N>(0, i)]; p 16-byte aligned for N >= 4, 8 for N = 2
template <int N>
__device__ __forceinline__ void ldv(float (&v)[N], const float* p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(p + 64 * g);
      v[4 * g] = q.x;
      v[4 * g + 1] = q.y;
      v[4 * g + 2] = q.z;
      v[4 * g + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// acc[a][j] += sum_k A[k][blk(ty, a)] B[k][blk(tx, j)]   (A^T B), the
// strides multiples of 4
template <int I, int J>
__device__ __forceinline__ void mm_tn_b(float (&acc)[I][J], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ap = A + blk<I>(ty, 0);
  const float* bp = B + blk<J>(tx, 0);
  for (int k = 0; k < K; ++k) {
    float av[I], bv[J];
    ldv<I>(av, ap + k * lda);
    ldv<J>(bv, bp + k * ldb);
#pragma unroll
    for (int a = 0; a < I; ++a)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[a][j] = fmaf(av[a], bv[j], acc[a][j]);
  }
}

// acc[a][j] += sum_k A[blk(ty, a)][k] B[k][blk(tx, j)]   (A B), K and the
// strides multiples of 4
template <int I, int J>
__device__ __forceinline__ void mm_nn_b(float (&acc)[I][J], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* bp = B + blk<J>(tx, 0);
  for (int k = 0; k < K; k += 4) {
    float4 av[I];
    float bv[4][J];
#pragma unroll
    for (int a = 0; a < I; ++a)
      av[a] = *reinterpret_cast<const float4*>(&A[blk<I>(ty, a) * lda + k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldv<J>(bv[kk], bp + (k + kk) * ldb);
#pragma unroll
    for (int a = 0; a < I; ++a)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float s = acc[a][j];
        s = fmaf(av[a].x, bv[0][j], s);
        s = fmaf(av[a].y, bv[1][j], s);
        s = fmaf(av[a].z, bv[2][j], s);
        acc[a][j] = fmaf(av[a].w, bv[3][j], s);
      }
  }
}

template <int I, int J>
__device__ __forceinline__ void zero(float (&acc)[I][J]) {
#pragma unroll
  for (int a = 0; a < I; ++a)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[a][j] = 0.f;
}

// sum over the 16 lanes of a half warp (the threads of one ty), in a
// fixed order; every lane gets the sum
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// tile pair k -> (i, j), j <= i, k = i (i + 1) / 2 + j
__device__ __forceinline__ void pair_of(int k, int& i, int& j) {
  i = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= k) ++i;
  while (i * (i + 1) / 2 > k) --i;
  j = k - i * (i + 1) / 2;
}

// ---------------------------------------------------------------------------
// a: chunk states
// ---------------------------------------------------------------------------

// smem: a (64, 16 JS) tile of b or c and a (64, 16 J) tile of the scaled
// x or dy, then cs, dt and a row scale (Q each)
template <int J, int JS>
__host__ __device__ inline size_t state_floats(int Q) {
  return 3 * (size_t)Q + (size_t)kT * 16 * JS + (size_t)kT * 16 * J;
}

// out (ns, hd) = sum_q A_q (outer) Y_q, A (b or c) with row stride asq
// and Y (x or dy) scaled by the row scale; thread (ty, tx) owns rows
// blk(ty, a) and columns blk(tx, j) of out
template <typename T, int J, int JS>
__device__ void outer_sum(float* out, const T* A, int64_t asq, const T* Y,
                          int64_t ysq, const float* scale, float* At,
                          float* Yt, const Dims& d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[JS][J];
  zero(acc);
  for (int p0 = 0; p0 < d.Q; p0 += kT) {
    load_rows(At, 16 * JS, A, asq, p0, d.Q, d.ns);
    load_rows(Yt, 16 * J, Y, ysq, p0, d.Q, d.hd, scale + p0);
    __syncthreads();
    mm_tn_b<JS, J>(acc, At, 16 * JS, Yt, 16 * J, min(kT, d.Q - p0));
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < JS; ++a) {
    const int s = blk<JS>(ty, a);
    if (s >= d.ns) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = blk<J>(tx, j);
      if (col < d.hd) out[(int64_t)s * d.hd + col] = acc[a][j];
    }
  }
}

template <typename T, int J, int JS>
__global__ void __launch_bounds__(kThreads)
    ssdbwd_state(const T* __restrict__ x, const T* __restrict__ b,
                 const T* __restrict__ c, const float* __restrict__ dt,
                 const float* __restrict__ da, const T* __restrict__ dy,
                 Scratch sc, Dims d) {
  extern __shared__ float4 smem4[];
  const int Q = d.Q;
  float* At = reinterpret_cast<float*>(smem4);  // (64, 16 JS)
  float* Yt = At + kT * 16 * JS;                 // (64, 16 J)
  float* cs = Yt + kT * 16 * J;                  // (Q,)
  float* dts = cs + Q;                           // (Q,)
  float* scl = dts + Q;                          // (Q,)
  const int head = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;  // dt row of q = 0
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
  const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;
  for (int q = tid; q < Q; q += kThreads) {
    sc.cs[bch * Q + q] = cs[q];
    scl[q] = dts[q] * expf(tot - cs[q]);
  }
  if (tid == 0) sc.tot[bch] = tot;
  __syncthreads();
  const int64_t nsd = (int64_t)d.ns * d.hd;
  const T* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
  outer_sum<T, J, JS>(sc.H + bch * nsd, b + bi * d.bsb + ch * d.bsc, d.bsq, xc,
                  d.xsq, scl, At, Yt, d);
  if (dy == nullptr) return;  // the first walk over the groups: states only
  for (int q = tid; q < Q; q += kThreads) scl[q] = expf(cs[q]);
  __syncthreads();
  outer_sum<T, J, JS>(sc.D + bch * nsd, c + bi * d.csb + ch * d.csc, d.csq,
                  dy + (row0 * d.nh + head) * d.hd, (int64_t)d.nh * d.hd,
                  scl, At, Yt, d);
}

// ---------------------------------------------------------------------------
// b: the walks over the chunks
// ---------------------------------------------------------------------------

// One thread per (batch, head, state entry).  Forward: H[c] holds S_c and
// becomes the state entering chunk c, from hin (zero when null); the state
// after the last chunk goes to hout when it is given.  Backward (dcarry
// given): D[c] holds R_c and becomes the gradient of the state leaving
// chunk c, from dcarry, which ends as the gradient of the state entering
// the group.
__global__ void __launch_bounds__(256)
    ssdbwd_walk(Scratch sc, const float* __restrict__ hin,
                float* __restrict__ hout, float* __restrict__ dcarry, int B,
                int nc, int nh, int64_t nsd) {
  constexpr int kC = 8;  // chunks whose values are loaded at once
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (int64_t)B * nh * nsd) return;
  const int64_t e = n % nsd, bh = n / nsd;
  const int head = (int)(bh % nh), bi = (int)(bh / nh);
  const int64_t step = (int64_t)nh * nsd;  // from one chunk to the next
  const int64_t at0 = (((int64_t)bi * nc) * nh + head) * nsd + e;
  const float* tot = sc.tot + (int64_t)bi * nc * nh + head;
  float* __restrict__ H = sc.H + at0;
  float* __restrict__ D = sc.D + at0;
  float h = hin != nullptr ? hin[n] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kC) {
    float v[kC], g[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i)
      if (c0 + i < nc) {
        v[i] = H[(c0 + i) * step];
        g[i] = expf(tot[(int64_t)(c0 + i) * nh]);
      }
#pragma unroll
    for (int i = 0; i < kC; ++i)
      if (c0 + i < nc) {
        H[(c0 + i) * step] = h;
        h = g[i] * h + v[i];
      }
  }
  if (hout != nullptr) hout[n] = h;
  if (dcarry == nullptr) return;
  float dg = dcarry[n];
  for (int c1 = nc; c1 > 0; c1 -= kC) {  // chunks c1 - 1 down to c1 - kC
    float v[kC], g[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i)
      if (c1 - 1 - i >= 0) {
        v[i] = D[(c1 - 1 - i) * step];
        g[i] = expf(tot[(int64_t)(c1 - 1 - i) * nh]);
      }
#pragma unroll
    for (int i = 0; i < kC; ++i)
      if (c1 - 1 - i >= 0) {
        D[(c1 - 1 - i) * step] = dg;
        dg = g[i] * dg + v[i];
      }
  }
  dcarry[n] = dg;
}

// ---------------------------------------------------------------------------
// c1: scores and M, per tile pair, summed over the heads
// ---------------------------------------------------------------------------

// smem: two (64, max(pad4(ns), pad4(hd))) tiles, cs of the pair's rows
// and columns, dt of its columns
__host__ __device__ inline size_t pairs_floats(int ns, int hd) {
  const int w = pad4(ns) > pad4(hd) ? pad4(ns) : pad4(hd);
  return 2 * (size_t)kT * w + 3 * kT;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ssdbwd_pairs(const T* __restrict__ x, const T* __restrict__ b,
                 const T* __restrict__ c, const float* __restrict__ dt,
                 const T* __restrict__ dy, Scratch sc, Dims d) {
  extern __shared__ float4 smem4[];
  const int Q = d.Q;
  const int w = pad4(d.ns) > pad4(d.hd) ? pad4(d.ns) : pad4(d.hd);
  float* At = reinterpret_cast<float*>(smem4);  // (64, w): c, then dy
  float* Bt = At + kT * w;                       // (64, w): b, then x
  float* csq = Bt + kT * w;                      // (64,) cs of the rows
  float* csp = csq + kT;                         // (64,) cs of the columns
  float* dtp = csp + kT;                         // (64,) dt of the columns
  const int pk = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  int ti, tj;
  pair_of(pk, ti, tj);
  const int q0 = ti * kT, p0 = tj * kT;
  const int64_t tile = (((int64_t)bi * d.nc + ch) * d.npairs + pk) * kTileF;

  // the scores c_q . b_p of the pair
  {
    const int nsp = pad4(d.ns), ns4 = (d.ns + 3) / 4 * 4;
    load_rows(At, nsp, c + bi * d.csb + ch * d.csc, d.csq, q0, Q, d.ns);
    load_rows(Bt, nsp, b + bi * d.bsb + ch * d.bsc, d.bsq, p0, Q, d.ns);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm_nt<4, 4>(s, At, nsp, Bt, nsp, ns4);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sc.sc[tile + (ty + 16 * a) * kT + tx + 16 * k] = s[a][k];
    __syncthreads();
  }

  // M, over the heads in order
  const int hdp = pad4(d.hd), hd4 = (d.hd + 3) / 4 * 4;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;
  float m[4][4];
  zero(m);
  for (int head = 0; head < d.nh; ++head) {
    const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;
    load_rows(At, hdp, dy + (row0 * d.nh + head) * d.hd,
              (int64_t)d.nh * d.hd, q0, Q, d.hd);
    load_rows(Bt, hdp, x + bi * d.xsb + ch * d.xsc + head * d.xsh, d.xsq, p0,
              Q, d.hd);
    if (tid < kT) {
      csq[tid] = q0 + tid < Q ? sc.cs[bch * Q + q0 + tid] : 0.f;
    } else if (tid < 2 * kT) {
      const int p = p0 + tid - kT;
      csp[tid - kT] = p < Q ? sc.cs[bch * Q + p] : 0.f;
      dtp[tid - kT] = p < Q ? dt[(row0 + p) * d.nh + head] : 0.f;
    }
    __syncthreads();
    float dw[4][4];
    zero(dw);
    mm_nt<4, 4>(dw, At, hdp, Bt, hdp, hd4);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = ty + 16 * a, col = tx + 16 * k;
        const int q = q0 + r, p = p0 + col;
        if (q < Q && p <= q)
          m[a][k] += dw[a][k] * expf(csq[r] - csp[col]) * dtp[col];
      }
    __syncthreads();  // the tiles are loaded again for the next head
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sc.m[tile + (ty + 16 * a) * kT + tx + 16 * k] = m[a][k];
}

// ---------------------------------------------------------------------------
// c2: the chunk, per head: dx, ddt, dda
// ---------------------------------------------------------------------------

// smem: a tile of b, c or dy (64, max(pad4(ns), pad4(hd))); the x tile
// (64, pad4(hd)); a 64 x 64 tile of W, then of G = dW (c b^T)
// exp(cs_q - cs_p); the state (ns rounded up to 4, 16 J); cs, dt, dcs (Q
// each); per column tile ddt's state part, s and the column sums of G
// (64 each); the column sums of G by row group (16, 64)
template <int J>
__host__ __device__ inline size_t chunk_floats(int Q, int ns, int hd) {
  const int w = pad4(ns) > pad4(hd) ? pad4(ns) : pad4(hd);
  return 3 * (size_t)Q + 3 * kT + (size_t)(ns + 3) / 4 * 4 * 16 * J +
         (size_t)kT * w + (size_t)kT * pad4(hd) + (size_t)kT * kWP4 + 8 +
         16 * kT;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads, J <= 4 ? 2 : 1)
    ssdbwd_chunk(const T* __restrict__ x, const T* __restrict__ b,
                 const T* __restrict__ c, const float* __restrict__ dt,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dda, Scratch sc,
                 Dims d) {
  extern __shared__ float4 smem4[];
  const int Q = d.Q, ns = d.ns, hd = d.hd;
  const int nsp = pad4(ns), hdp = pad4(hd), hd4 = (hd + 3) / 4 * 4;
  const int ns4 = (ns + 3) / 4 * 4;
  const int w = nsp > hdp ? nsp : hdp;
  constexpr int SP = 16 * J;
  float* Yt = reinterpret_cast<float*>(smem4);  // (64, w): c, b or dy
  float* Xt = Yt + kT * w;                       // (64, hdp): dy, then x
  float* Wt = Xt + kT * hdp;                     // (64, 68): W
  float* St = Wt + kT * kWP4;                    // (ns4, SP): H, then D
  float* cs = St + ns4 * SP;                     // (Q,)
  float* dts = cs + Q;                           // (Q,)
  float* dcs = dts + Q;                          // (Q,)
  float* ddtv = dcs + Q;                         // (64,)
  float* ss = ddtv + kT;                         // (64,)
  float* cg = ss + kT;                           // (64,)
  float* red = cg + kT;                          // (8,)
  float* Gp = red + 8;                           // (16, 64)
  const int head = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;
  const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;
  const int64_t nsd = (int64_t)ns * hd;
  const float* H = sc.H + bch * nsd;
  const float* D = sc.D + bch * nsd;
  const T* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
  const T* bc = b + bi * d.bsb + ch * d.bsc;
  const T* cc = c + bi * d.csb + ch * d.csc;
  const T* dyc = dy + (row0 * d.nh + head) * hd;
  const int64_t dys = (int64_t)d.nh * hd;  // dy and dx row stride
  for (int q = tid; q < Q; q += kThreads) {
    cs[q] = sc.cs[bch * Q + q];
    dts[q] = dt[(row0 + q) * d.nh + head];
  }
  load_state(St, SP, H, ns, hd, ns4);
  // <D, H>, summed by thread then warp then block, in order
  float dh = 0.f;
  for (int64_t e = tid; e < nsd; e += kThreads) dh = fmaf(D[e], H[e], dh);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dh += __shfl_xor_sync(0xffffffffu, dh, off);
  if (lane == 0) red[warp] = dh;
  __syncthreads();
  const float tot = cs[Q - 1];

  // dcs_q = exp(cs_q) (c_q . H) . dy_q, the first of its terms
  for (int q0 = 0; q0 < Q; q0 += kT) {
    load_rows(Yt, nsp, cc, d.csq, q0, Q, ns);
    load_rows(Xt, hdp, dyc, dys, q0, Q, hd);
    __syncthreads();
    float v[4][J];
    zero(v);
    mm_nn_b<4, J>(v, Yt, nsp, St, SP, ns4);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = blk<4>(ty, a);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = blk<J>(tx, j);
        if (col < hd) part = fmaf(v[a][j], Xt[r * hdp + col], part);
      }
      part = half_warp_sum(part);
      if (tx == 0 && q0 + r < Q) dcs[q0 + r] = expf(cs[q0 + r]) * part;
    }
    __syncthreads();
  }
  load_state(St, SP, D, ns, hd, ns4);
  float stot = 0.f;  // sum of s, kept by thread 0
  __syncthreads();

  for (int tj = 0; tj < d.nt; ++tj) {
    const int p0 = tj * kT, np = min(kT, Q - p0);
    load_rows(Yt, nsp, bc, d.bsq, p0, Q, ns);
    load_rows(Xt, hdp, xc, d.xsq, p0, Q, hd);
    if (tid < kT) cg[tid] = 0.f;
    __syncthreads();
    // the state's part: u = b . D, then dx, ddt and s of each row
    float dxa[4][J];  // rows blk(ty, a), columns blk(tx, j)
    zero(dxa);
    mm_nn_b<4, J>(dxa, Yt, nsp, St, SP, ns4);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = blk<4>(ty, a), p = p0 + r;
      const float e = p < Q ? expf(tot - cs[p]) : 0.f;
      const float scale = p < Q ? dts[p] * e : 0.f;
      float ux = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = blk<J>(tx, j);
        if (col < hd) ux = fmaf(dxa[a][j], Xt[r * hdp + col], ux);
        dxa[a][j] *= scale;
      }
      ux = half_warp_sum(ux);
      if (tx == 0) {
        ddtv[r] = e * ux;
        ss[r] = scale * ux;
      }
    }
    __syncthreads();  // Yt is loaded with dy next
    for (int ti = tj; ti < d.nt; ++ti) {
      const int q0 = ti * kT;
      load_rows(Yt, hdp, dyc, dys, q0, Q, hd);
      __syncthreads();
      float dw[4][4];
      zero(dw);
      mm_nt<4, 4>(dw, Yt, hdp, Xt, hdp, hd4);
      const float* sct =
          sc.sc + ((((int64_t)bi * d.nc + ch) * d.npairs) +
                   ti * (ti + 1) / 2 + tj) * kTileF;
      float gcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a, q = q0 + r;
        float grow = 0.f;  // sum_p G_qp dt_p over this thread's columns
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = tx + 16 * k, p = p0 + col;
          float wv = 0.f;
          if (q < Q && p <= q) {
            const float s = sct[r * kT + col];
            const float dec = expf(cs[q] - cs[p]);
            const float gv = dw[a][k] * s * dec;
            wv = s * dec * dts[p];
            grow = fmaf(gv, dts[p], grow);
            gcol[k] += gv;
          }
          Wt[r * kWP4 + col] = wv;
        }
        grow = half_warp_sum(grow);
        if (tx == 0 && q < Q) dcs[q] += grow;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) Gp[ty * kT + tx + 16 * k] = gcol[k];
      __syncthreads();
      // dx_p += sum_q W_qp dy_q; the columns' sums of G over the rows
      mm_tn_b<4, J>(dxa, Wt, kWP4, Yt, hdp, min(kT, Q - q0));
      if (tid < kT) {
        float sum = 0.f;
        for (int r = 0; r < 16; ++r) sum += Gp[r * kT + tid];
        cg[tid] += sum;
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = p0 + blk<4>(ty, a);
      if (p >= Q) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = blk<J>(tx, j);
        if (col < hd) dx[(row0 + p) * dys + head * hd + col] =
            out_as<T>(dxa[a][j]);
      }
    }
    if (tid < np) {
      const int p = p0 + tid;
      ddt[(row0 + p) * d.nh + head] = ddtv[tid] + cg[tid];
      dcs[p] -= ss[tid] + dts[p] * cg[tid];
    }
    if (tid == 0)
      for (int k = 0; k < np; ++k) stot += ss[k];
    __syncthreads();
  }
  if (tid == 0) {
    float dhs = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) dhs += red[k];
    dcs[Q - 1] += expf(tot) * dhs + stot;
  }
  __syncthreads();
  if (warp == 0) {  // dda_r = sum_{q >= r} dcs_q, 32 rows at a time
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int q = Q - 1 - base - lane;
      float v = q >= 0 ? dcs[q] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      v += carry;
      if (q >= 0) dda[(row0 + q) * d.nh + head] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// ---------------------------------------------------------------------------
// c3: db and dc, per 64-row tile, summed over the heads
// ---------------------------------------------------------------------------

// smem: two states (16 JS, pad4(hd)), one head's and the next one's, and
// a row tile (64, pad4(hd)), or a 64 x 64 tile of M and a (64, 16 JS) tile
// of b or c; then a row scale of the tile (64)
template <int JS>
__host__ __device__ inline size_t bc_floats(int hd) {
  const size_t st = (size_t)(2 * 16 * JS + kT) * pad4(hd);
  const size_t mt = (size_t)kT * kWP + (size_t)kT * 16 * JS;
  return (st > mt ? st : mt) + kT;
}

// Block (t + nt w, chunk, batch): w 0 gives rows t of dc, w 1 rows t of db
template <typename T, int JS>
__global__ void __launch_bounds__(kThreads, 2)
    ssdbwd_bc(const T* __restrict__ x, const T* __restrict__ b,
              const T* __restrict__ c, const float* __restrict__ dt,
              const T* __restrict__ dy, T* __restrict__ db,
              T* __restrict__ dc, Scratch sc, Dims d) {
  extern __shared__ float4 smem4[];
  const int Q = d.Q, ns = d.ns, hd = d.hd;
  const int hdp = pad4(hd), hd4 = (hd + 3) / 4 * 4;
  constexpr int SP = 16 * JS;
  float* base = reinterpret_cast<float*>(smem4);
  float* Mt = base;                 // (64, 65)
  float* Ct = base + kT * kWP;      // (64, SP)
  float* Hs = base;                 // 2 x (SP, hdp)
  float* Rt = base + 2 * SP * hdp;  // (64, hdp)
  const size_t st = (size_t)(2 * SP + kT) * hdp;
  const size_t mt = (size_t)kT * kWP + (size_t)kT * SP;
  float* rs = base + (st > mt ? st : mt);  // (64,) row scale
  const bool for_c = blockIdx.x < (unsigned)d.nt;
  const int t = for_c ? blockIdx.x : blockIdx.x - d.nt;
  const int ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = t * kT;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;
  const int64_t pairs = ((int64_t)bi * d.nc + ch) * d.npairs;
  float g[4][JS];
  zero(g);
  if (for_c) {  // dc_q += sum_p M_qp b_p over the tiles j <= t
    for (int tj = 0; tj <= t; ++tj) {
      load_f32(Mt, kWP, sc.m + (pairs + t * (t + 1) / 2 + tj) * kTileF, kT,
               kT, kT, kT);
      load_rows(Ct, SP, b + bi * d.bsb + ch * d.bsc, d.bsq, tj * kT, Q, ns);
      __syncthreads();
      mm_nn<4, JS>(g, Mt, kWP, Ct, SP, kT);
      __syncthreads();
    }
  } else {  // db_p += sum_q M_qp c_q over the tiles i >= t
    for (int ti = t; ti < d.nt; ++ti) {
      load_f32(Mt, kWP, sc.m + (pairs + ti * (ti + 1) / 2 + t) * kTileF, kT,
               kT, kT, kT);
      load_rows(Ct, SP, c + bi * d.csb + ch * d.csc, d.csq, ti * kT, Q, ns);
      __syncthreads();
      mm_tn<4, JS>(g, Mt, kWP, Ct, SP, kT);
      __syncthreads();
    }
  }
  // the states' parts, head by head: dc_q += exp(cs_q) H dy_q, or
  // db_p += dt_p exp(tot - cs_p) D x_p; the next head's state is copied
  // in the background (cp.async, when hd is a multiple of 4 and so the
  // scratch's rows are 16-byte aligned) while this head's is used
  const int64_t nsd = (int64_t)ns * hd;
  const float* S = (for_c ? sc.H : sc.D) + ((int64_t)bi * d.nc + ch) *
                                               d.nh * nsd;
  auto fetch = [&](int head) {
    float* dst = Hs + (head & 1) * SP * hdp;
    const float* src = S + head * nsd;
    if (hd % 4 == 0) {
      const int n4 = hdp / 4;
      for (int e = tid; e < SP * n4; e += kThreads) {
        const int r = e / n4, c4 = 4 * (e - r * n4);
        const bool ok = r < ns && c4 < hd;
        cp_async16(dst + r * hdp + c4, ok ? src + (int64_t)r * hd + c4 : src,
                   ok);
      }
    } else {
      load_state(dst, hdp, src, ns, hd, SP);
    }
    cp_async_commit();
  };
  fetch(0);
  for (int head = 0; head < d.nh; ++head) {
    const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;
    const float* csh = sc.cs + bch * Q;
    if (head + 1 < d.nh)
      fetch(head + 1);
    else
      cp_async_commit();  // an empty group: one group a head, to wait on
    if (tid < kT) {
      const int q = r0 + tid;
      rs[tid] = q >= Q ? 0.f
                : for_c ? expf(csh[q])
                        : dt[(row0 + q) * d.nh + head] *
                              expf(sc.tot[bch] - csh[q]);
    }
    __syncthreads();
    if (for_c)
      load_rows(Rt, hdp, dy + (row0 * d.nh + head) * hd, (int64_t)d.nh * hd,
                r0, Q, hd, rs);
    else
      load_rows(Rt, hdp, x + bi * d.xsb + ch * d.xsc + head * d.xsh, d.xsq,
                r0, Q, hd, rs);
    cp_async_wait<1>();  // this head's state has landed
    __syncthreads();
    mm_nt<4, JS>(g, Rt, hdp, Hs + (head & 1) * SP * hdp, hdp, hd4);
    __syncthreads();
  }
  T* out = for_c ? dc : db;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = r0 + ty + 16 * a;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int s = tx + 16 * j;
      if (s < ns) out[(row0 + q) * ns + s] = out_as<T>(g[a][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *x, *b, *c, *dt, *da, *dy;
  void *dx, *db, *dc, *ddt, *dda;
};

// passes a and b (and, with dy, c1 to c3) over the chunks of one group,
// whose pointers the caller has offset to the group's first chunk
template <typename T, int J, int JS>
cudaError_t group_passes(const Args& g, Scratch sc, const float* hin,
                         float* hout, float* dcarry, int64_t B, const Dims& d,
                         cudaStream_t s) {
  const dim3 grid_h((unsigned)d.nh, (unsigned)d.nc, (unsigned)B);
  const T *x = (const T*)g.x, *b = (const T*)g.b, *c = (const T*)g.c;
  const T* dy = (const T*)g.dy;
  const float* dt = (const float*)g.dt;
  size_t bytes = state_floats<J, JS>(d.Q) * sizeof(float);
  cudaError_t err = smem_attr(ssdbwd_state<T, J, JS>, bytes);
  if (err != cudaSuccess) return err;
  ssdbwd_state<T, J, JS><<<grid_h, kThreads, bytes, s>>>(
      x, b, c, dt, (const float*)g.da, dy, sc, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t nsd = (int64_t)d.ns * d.hd, n = B * d.nh * nsd;
  ssdbwd_walk<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      sc, hin, hout, dy != nullptr ? dcarry : nullptr, (int)B, d.nc, d.nh,
      nsd);
  if ((err = cudaGetLastError()) != cudaSuccess || dy == nullptr) return err;
  bytes = pairs_floats(d.ns, d.hd) * sizeof(float);
  if ((err = smem_attr(ssdbwd_pairs<T, J>, bytes)) != cudaSuccess) return err;
  ssdbwd_pairs<T, J><<<dim3((unsigned)d.npairs, (unsigned)d.nc, (unsigned)B),
                       kThreads, bytes, s>>>(x, b, c, dt, dy, sc, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = chunk_floats<J>(d.Q, d.ns, d.hd) * sizeof(float);
  if ((err = smem_attr(ssdbwd_chunk<T, J>, bytes)) != cudaSuccess) return err;
  ssdbwd_chunk<T, J><<<grid_h, kThreads, bytes, s>>>(
      x, b, c, dt, dy, (T*)g.dx, (float*)g.ddt, (float*)g.dda, sc, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = bc_floats<JS>(d.hd) * sizeof(float);
  if ((err = smem_attr(ssdbwd_bc<T, JS>, bytes)) != cudaSuccess) return err;
  const dim3 grid_bc((unsigned)(2 * d.nt), (unsigned)d.nc, (unsigned)B);
  ssdbwd_bc<T, JS><<<grid_bc, kThreads, bytes, s>>>(x, b, c, dt, dy,
                                                    (T*)g.db, (T*)g.dc, sc, d);
  return cudaGetLastError();
}

template <typename T, int J>
cudaError_t group_js(const Args& g, Scratch sc, const float* hin, float* hout,
                     float* dcarry, int64_t B, const Dims& d, cudaStream_t s) {
  if (d.ns <= 16)
    return group_passes<T, J, 1>(g, sc, hin, hout, dcarry, B, d, s);
  if (d.ns <= 64)
    return group_passes<T, J, 4>(g, sc, hin, hout, dcarry, B, d, s);
  return group_passes<T, J, 8>(g, sc, hin, hout, dcarry, B, d, s);
}

template <typename T>
cudaError_t group_t(const Args& g, Scratch sc, const float* hin, float* hout,
                    float* dcarry, int64_t B, const Dims& d, cudaStream_t s) {
  if (d.hd <= 16) return group_js<T, 1>(g, sc, hin, hout, dcarry, B, d, s);
  if (d.hd <= 64) return group_js<T, 4>(g, sc, hin, hout, dcarry, B, d, s);
  return group_js<T, 8>(g, sc, hin, hout, dcarry, B, d, s);
}

template <typename T>
cudaError_t run(const Args& a, float* scratch, float* bounds, float* dcarry,
                int64_t B, Dims d, int64_t group, cudaStream_t s) {
  const int64_t nc = d.ncs, Q = d.Q, nh = d.nh, hd = d.hd, ns = d.ns;
  const int64_t G = group, ng = (nc + G - 1) / G;
  const int64_t nsd = ns * hd, rows = Q * nh;
  // the scratch of one group of G chunks
  Scratch sc;
  sc.sc = scratch;
  sc.m = sc.sc + B * G * d.npairs * kTileF;
  sc.H = sc.m + B * G * d.npairs * kTileF;
  sc.D = sc.H + B * G * nh * nsd;
  sc.cs = sc.D + B * G * nh * nsd;
  sc.tot = sc.cs + B * G * nh * Q;
  auto at = [&](int64_t gi, Dims& dg) {
    const int64_t c0 = gi * G;
    dg = d;
    dg.nc = (int)(nc - c0 < G ? nc - c0 : G);
    Args o = a;
    o.x = (const T*)a.x + c0 * d.xsc;
    o.b = (const T*)a.b + c0 * d.bsc;
    o.c = (const T*)a.c + c0 * d.csc;
    o.dt = (const float*)a.dt + c0 * rows;
    o.da = (const float*)a.da + c0 * rows;
    o.dy = (const T*)a.dy + c0 * rows * hd;
    o.dx = (T*)a.dx + c0 * rows * hd;
    o.db = (T*)a.db + c0 * Q * ns;
    o.dc = (T*)a.dc + c0 * Q * ns;
    o.ddt = (float*)a.ddt + c0 * rows;
    o.dda = (float*)a.dda + c0 * rows;
    return o;
  };
  const int64_t bstate = B * nh * nsd;
  cudaError_t err = cudaSuccess;
  // the state entering each group after the first, into bounds
  for (int64_t gi = 0; gi + 1 < ng && err == cudaSuccess; ++gi) {
    Dims dg;
    Args o = at(gi, dg);
    o.dy = nullptr;
    err = group_t<T>(o, sc, gi ? bounds + (gi - 1) * bstate : nullptr,
                     bounds + gi * bstate, nullptr, B, dg, s);
  }
  for (int64_t gi = ng - 1; gi >= 0 && err == cudaSuccess; --gi) {
    Dims dg;
    Args o = at(gi, dg);
    err = group_t<T>(o, sc, gi ? bounds + (gi - 1) * bstate : nullptr,
                     nullptr, dcarry, B, dg, s);
  }
  return err;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, nc, Q, nh, hd); b, c (B, nc, Q, ns), strided with unit stride in
// their last dimension; dt, da (B, nc, Q, nh) f32 and dy (x's shape)
// contiguous.  Out, contiguous: dx like x, db and dc like b, ddt and dda
// like dt (f32).  dtype (of x, b, c, dy, dx, db, dc) 0: float32, 1:
// bfloat16.  The chunks go in groups of at most ``group`` (B <= 65535,
// group <= 65535); scratch holds B * group * (nh * (2 ns hd + Q + 1) +
// 2 * 4096 * npairs) floats, npairs = nt (nt + 1) / 2 with nt = ceil(Q /
// 64); bounds holds (ceil(nc / group) - 1) * B * nh * ns * hd floats (may
// be null with one group); dcarry (B, nh, ns, hd) f32 holds the final
// state's gradient (zeros when there is none) and is overwritten.
int ssd_scan_bwd(const void* x, const void* b, const void* c, const void* dt,
                 const void* da, const void* dy, void* dx, void* db, void* dc,
                 void* ddt, void* dda, void* scratch, void* bounds,
                 void* dcarry, int64_t B, int64_t nc, int64_t Q, int64_t nh,
                 int64_t hd, int64_t ns, int64_t xsb, int64_t xsc,
                 int64_t xsq, int64_t xsh, int64_t bsb, int64_t bsc,
                 int64_t bsq, int64_t csb, int64_t csc, int64_t csq,
                 int64_t group, int64_t dtype, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || nh < 1 || hd < 1 || ns < 1 || B > 65535 ||
      nh > 65535 || Q > 4096 || hd > 128 || ns > 128 || group < 1 ||
      group > 65535 || scratch == nullptr || dcarry == nullptr ||
      (group < nc && bounds == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int nt = (int)((Q + kT - 1) / kT);
  const Dims d{(int)nc, (int)Q, (int)nh, (int)hd, (int)ns, xsb, xsc, xsq, xsh,
               bsb, bsc, bsq, csb, csc, csq, (int)nc, nt, nt * (nt + 1) / 2};
  const Args a{x, b, c, dt, da, dy, dx, db, dc, ddt, dda};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)run<float>(a, (float*)scratch, (float*)bounds,
                           (float*)dcarry, B, d, group, s);
  return (int)run<bf16>(a, (float*)scratch, (float*)bounds, (float*)dcarry,
                        B, d, group, s);
}

}  // extern "C"
