// Hopper kernels of the Mamba-2 SSD chunk scan, with a plain C interface
// for ctypes (built by kernels/_build.py).
//
//   ssd_scan  replaces ssd_scan_pallas
//             (src/repro/kernels/ssd_scan/ssd_scan.py:63, its
//             pl.pallas_call at :72)
//
// The function is the Pallas kernel's (_ssd_kernel, same file :25-60), per
// (batch, head) and chunk, with cs the cumulative sum of da over the chunk
// and tot = cs[Q-1]:
//
//   y[q] = exp(cs_q) (c_q . h)
//          + sum_{p <= q} (c_q . b_p) exp(cs_q - cs_p) dt_p x_p
//   h'   = exp(tot) h  +  sum_q b_q (outer) (dt_q exp(tot - cs_q) x_q)
//
// y is cast to x's type (f32 or bf16) at the end.  The decay
// exp(cs_q - cs_p) overflows to inf above the diagonal (q < p; cs falls as
// da <= 0), so it is computed only where q >= p and is never multiplied by
// a 0/1 mask (inf * 0 = NaN).  Besides y the kernels write the state after
// the last chunk when asked for it (the prefill's decode cache); the
// Pallas kernel writes y only.
//
// Bound: bytes, narrowly.  At the mamba2-370m serve prefill (B 4, nc 8,
// Q 256, nh 32, hd 64, ns 128, bf16) the function moves 77.6 MB, 0.0232 ms
// at 3.35 TB/s, and needs 21.5 GFLOP -- the causal triangle, Q(Q+1)/2
// pairs a chunk, plus c . h and the state update -- 0.0218 ms at the
// 989 TFLOP/s of bf16 tensor cores (0.32 ms at the 67 TFLOP/s of f32 CUDA
// cores).
//
// bf16: three kernels on the tensor cores, launched one after another on
// the caller's stream, with the sums regrouped so that the chunks run in
// parallel (Pallas carries h across the sequential grid axis nc):
//
//   A  ssd_chunk_state  one block per (batch, chunk, head): cs by a warp
//      scan (kept for C), tot, and the chunk's own state contribution
//      S_c = B^T (dt exp(tot - cs) x), (ns, hd) f32, into scratch
//      (B, nc, nh, ns, hd).
//   B  ssd_state_pass   one thread per (batch, head, state entry), a walk
//      over the chunks: h_0 = 0, h_{c+1} = exp(tot_c) h_c + S_c.  It writes
//      h_c, the state entering chunk c, as the bf16 hi and lo halves that
//      C multiplies, and the final state in f32 when asked for it.
//   C  ssd_chunk_out    one block per (batch, chunk, head) and pair of
//      64-row q tiles (i, last - i), so that blocks carry equal causal
//      work and read h_c and each key tile once for 128 rows:
//      y = exp(cs_q) (c_q . h_c) + W x with W = (c b^T) exp(cs_q - cs_p)
//      dt_p on p <= q, key tiles above the diagonal skipped.  Below the
//      diagonal the decay is exp(cs_q - cs_m) exp(cs_m - cs_p) with m the
//      key tile's last row, both factors <= 1, so it costs an exp per row
//      and per key instead of one per entry.
//
// Products: mma.sync m16n8k16, bf16 operands from ldmatrix, f32
// accumulators; 256 threads a block.  In A warp w owns a tile of the
// (ns, hd) state and half the keys of every key tile (the halves meet in
// shared memory); in C it owns a 16-row slab of one q tile.  c b^T has
// only bf16 operands and is exact up to the order of its f32 sum.  W, the
// decay-scaled x and h are f32 in the plain version; each goes into the
// tensor cores as a bf16 hi + lo pair (hi = bf16(v), lo = bf16(v - hi);
// two MMAs, about 16 bits of mantissa), chosen over one rounding by a CPU
// emulation of both (tests/test_torch_ssd_scan.py).  A and C
// double-buffer their key tiles with cp.async, C keeps the c tile's
// operand fragments in registers, and C has the most blocks an SM that
// its registers and shared memory allow (two): on the card, fewer ran far
// slower.  Both zero-fill ragged tiles, so any Q from 1 to 4,096 works
// (the model gives Q = 1 for a prime prompt length), with ns and hd
// padded to 16, 64 or 128.  x, b and c are read through their strides
// (the model passes column slices of the convolution's output), 16 bytes
// at a time where the addresses allow and element by element otherwise;
// dt and da are contiguous (B, nc, Q, nh).  Scratch (from the wrapper):
// the chunk states S_c (f32), the entering states h_c (bf16 hi and lo),
// cs (B, G, nh, Q) and tot (B, G, nh) of one group of G chunks.  The
// three passes run group after group, and the state pass of a group
// starts from the f32 state the previous one ended with (in hfin), so the
// scratch is bounded whatever nc is (a prime prompt length gives Q = 1 and
// nc = S), the grids stay within 65,535 (pass A has G on y, pass C B * G
// on z), and the sums are those of one group: grouping cuts only the
// state pass's walk over the chunks, and the state crosses a group
// boundary in f32 as it crosses a chunk boundary.
//
// Where the numbers depart from the Pallas kernel's: the sums over a
// chunk's keys, over chunks (the state passing) and over ns run in other
// orders, the decay below the diagonal is a product of two exps, and W,
// the scaled x and h carry about 16 bits instead of 24 into their
// products.
//
// float32: ssd_scan_kernel, the CUDA-core kernel of the first port, kept
// as the f32 instantiation (f32 FMAs; the bf16 hi + lo split would not
// hold the f32 bounds).  One 256-thread block per (batch, head) walks the
// chunks in order with h in shared memory, in 64-row query and key tiles.
// Both paths count as ssd_scan launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------


constexpr int kT = 64;  // query rows and key columns per tile
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90


struct Dims {
  int nc, Q, nh, hd, ns;       // nc: chunks of a launch (of a group, bf16)
  int64_t xsb, xsc, xsq, xsh;  // x strides in elements (unit along hd)
  int64_t bsb, bsc, bsq;       // b strides (unit along ns)
  int64_t csb, csc, csq;       // c strides (unit along ns)
  bool xvec, bvec, cvec;       // rows of x, b, c 16-byte aligned (bf16)
  int ncs;                     // chunks of the call: dt, da, y's batch stride
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
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t stride, int r0, int R,
                                          int n) {
  for (int e = threadIdx.x; e < kT * ld; e += kThreads) {
    const int r = e / ld, s = e - r * ld;
    const int q = r0 + r;
    dst[e] = (q < R && s < n) ? src[(int64_t)q * stride + s] : 0.f;
  }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                    const float* __restrict__ c, const float* __restrict__ dt,
                    const float* __restrict__ da, float* __restrict__ y,
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
    const float* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
    const float* bc = b + bi * d.bsb + ch * d.bsc;
    const float* cc = c + bi * d.csb + ch * d.csc;
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
      float* yc = y + (row0 * d.nh + head) * (int64_t)hd;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
        const float e = expf(cs[q]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int col = tx + 16 * j;
          if (col < hd)
            yc[(int64_t)q * d.nh * hd + col] = e * inter[i][j] + intra[i][j];
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

template <int J>
cudaError_t launch_j(const void* x, const void* b, const void* c,
                     const void* dt, const void* da, void* y, void* hfin,
                     int64_t B, const Dims& d, cudaStream_t stream) {
  const size_t bytes = smem_floats<J>(d.Q, d.ns) * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)d.nh, (unsigned)B);
  ssd_scan_kernel<J><<<grid, kThreads, bytes, stream>>>(
      (const float*)x, (const float*)b, (const float*)c, (const float*)dt,
      (const float*)da, (float*)y, (float*)hfin, d);
  return cudaGetLastError();
}

cudaError_t launch_t(const void* x, const void* b, const void* c,
                     const void* dt, const void* da, void* y, void* hfin,
                     int64_t B, const Dims& d, cudaStream_t s) {
  if (d.hd <= 16) return launch_j<1>(x, b, c, dt, da, y, hfin, B, d, s);
  if (d.hd <= 32) return launch_j<2>(x, b, c, dt, da, y, hfin, B, d, s);
  if (d.hd <= 64) return launch_j<4>(x, b, c, dt, da, y, hfin, B, d, s);
  return launch_j<8>(x, b, c, dt, da, y, hfin, B, d, s);
}

// ---------------------------------------------------------------------------
// bfloat16: three passes on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTT = 64;        // rows of a q or key tile
constexpr int kTC = 256;       // threads of a pass A or C block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// v = hi + lo: hi = bf16(v), lo = bf16(v - hi), both rounded to nearest
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}
// a pair of f32 values as packed bf16 hi and lo halves
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  bf16 h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  hi = pack2(h0, h1);
  lo = pack2(l0, l1);
}

// rows r0 .. r0 + ROWS - 1 of an (R, n) bf16 matrix (row r at src +
// r * stride, unit stride along n) into dst (ROWS x LD), columns
// 0 .. NP - 1, zero past
// R rows and n columns.  With ``vec`` (16-byte aligned rows, n % 8 == 0)
// by cp.async, 16 bytes at a time; else element by element.
template <int NP, int LD, int ROWS = kTT>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int64_t stride, int r0, int R,
                                          int n, bool vec) {
  constexpr int kCh = NP / 8;
  for (int e = threadIdx.x; e < ROWS * kCh; e += blockDim.x) {
    const int r = e / kCh, col = (e % kCh) * 8, q = r0 + r;
    bf16* d = dst + r * LD + col;
    const bf16* s = src + (int64_t)q * stride + col;
    if (vec && q < R && col < n) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (q < R && col + i < n) ? s[i] : __float2bfloat16(0.f);
    }
  }
}


template <int NSP, int HDP>
struct Pass {
  static constexpr int kLB = NSP + 8;  // b / c tile row, elements (skewed)
  static constexpr int kLX = HDP + 8;  // x / h tile row
  // A: two (b, x) stages, x hi and lo tiles, then cs and the x scales
  // (2 Q floats); the partial sums of the state take the tiles' place
  static constexpr int kABytes = 2 * 2 * kTT * kLB + 4 * 2 * kTT * kLX;
  // C: two c tiles, then either h hi and lo or two (b, x) key stages,
  // then cs_q[2], cs_k[2], dt_k[2]
  static constexpr int kHBytes = 2 * 2 * NSP * kLX;
  static constexpr int kKBytes = 2 * 2 * kTT * (kLB + kLX);
  static constexpr int kCBytes = 2 * 2 * kTT * kLB +
                                 (kHBytes > kKBytes ? kHBytes : kKBytes) +
                                 6 * kTT * 4;
  // A's warp tiling of the (NSP, HDP) state: kWM x kWN warps, each kMT
  // m16 tiles by kNT n8 tiles
  static constexpr int kWM = NSP / 16 < 4 ? NSP / 16 : 4;
  static constexpr int kWN = 4 / kWM;
  static constexpr int kMT = NSP / 16 / kWM;
  static constexpr int kNT = HDP / 8 / kWN > 0 ? HDP / 8 / kWN : 1;
  static_assert(kABytes >= 4 * kMT * kNT * 32 * 16,
                "no room for pass A's partial sums");
};

// A: cs, tot and S_c = B^T (dt exp(tot - cs) x) of one (batch, chunk,
// head).  Eight warps: warp w owns tile w % 4 of the state and half w / 4
// of the keys of every key tile; the halves' sums meet in shared memory
// at the end.
template <int NSP, int HDP>
__global__ void __launch_bounds__(kTC, 2)
    ssd_chunk_state(const bf16* __restrict__ x, const bf16* __restrict__ b,
                    const float* __restrict__ dt,
                    const float* __restrict__ da, float* __restrict__ st,
                    float* __restrict__ cs_out, float* __restrict__ tot_out,
                    Dims d) {
  using P = Pass<NSP, HDP>;
  constexpr int kLB = P::kLB, kLX = P::kLX;
  extern __shared__ float4 smem4[];
  bf16* Bs = reinterpret_cast<bf16*>(smem4);  // 2 x (64, kLB)
  bf16* Xr = Bs + 2 * kTT * kLB;              // 2 x (64, kLX), x as read
  bf16* Xh = Xr + 2 * kTT * kLX;              // (64, kLX), scaled x, hi
  bf16* Xl = Xh + kTT * kLX;                  // (64, kLX), scaled x, lo
  float* cs = reinterpret_cast<float*>(Xl + kTT * kLX);  // (Q,)
  float* fs = cs + d.Q;                        // (Q,): dt, then x scales

  const int head = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int Q = d.Q, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;  // dt/da row of q=0
  const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;  // scratch
  const bf16* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
  const bf16* bc = b + bi * d.bsb + ch * d.bsc;
  const int n_kt = (Q + kTT - 1) / kTT;

  // key tile t: b and x as they are, by cp.async when aligned
  auto load_stage = [&](int tt) {
    const int s = tt & 1;
    load_tile<NSP, kLB>(Bs + s * kTT * kLB, bc, d.bsq, tt * kTT, Q, d.ns,
                        d.bvec);
    load_tile<HDP, kLX>(Xr + s * kTT * kLX, xc, d.xsq, tt * kTT, Q, d.hd,
                        d.xvec);
    cp_async_commit();
  };
  load_stage(0);
  for (int q = tid; q < Q; q += kTC) {  // da and dt of the chunk at once
    cs[q] = da[(row0 + q) * d.nh + head];
    fs[q] = dt[(row0 + q) * d.nh + head];
  }
  __syncthreads();
  if (warp == 0) {  // inclusive scan of da, 32 rows at a time
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int q = base + lane;
      float v = q < Q ? cs[q] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      v += carry;
      if (q < Q) {
        cs[q] = v;
        cs_out[bch * Q + q] = v;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float tot = cs[Q - 1];
  if (tid == 0) tot_out[bch] = tot;
  // x rows are scaled by dt_p exp(tot - cs_p), in that order (as Pallas)
  for (int q = tid; q < Q; q += kTC) fs[q] = fs[q] * expf(tot - cs[q]);

  const int wt = warp & 3, half = warp >> 2;
  const int wm = wt % P::kWM, wn = wt / P::kWM;
  const int m0 = wm * P::kMT * 16, n0 = wn * P::kNT * 8;
  const bool active = n0 < HDP;
  float acc[P::kMT][P::kNT][4];
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int j = 0; j < P::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int tt = 0; tt < n_kt; ++tt) {
    if (tt + 1 < n_kt) {
      load_stage(tt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = tt & 1, p0 = tt * kTT;
    const bf16* Bt = Bs + s * kTT * kLB;
    // the x tile scaled, split into bf16 hi and lo
    const bf16* Xt = Xr + s * kTT * kLX;
    constexpr int kCh = HDP / 8;
    for (int e = tid; e < kTT * kCh; e += kTC) {
      const int r = e / kCh, col = (e % kCh) * 8;
      const float f = p0 + r < Q ? fs[p0 + r] : 0.f;
      const uint4 raw = *reinterpret_cast<const uint4*>(Xt + r * kLX + col);
      const bf16* rv = reinterpret_cast<const bf16*>(&raw);
      uint4 hi, lo;
      split2(f * __bfloat162float(rv[0]), f * __bfloat162float(rv[1]), hi.x,
             lo.x);
      split2(f * __bfloat162float(rv[2]), f * __bfloat162float(rv[3]), hi.y,
             lo.y);
      split2(f * __bfloat162float(rv[4]), f * __bfloat162float(rv[5]), hi.z,
             lo.z);
      split2(f * __bfloat162float(rv[6]), f * __bfloat162float(rv[7]), hi.w,
             lo.w);
      *reinterpret_cast<uint4*>(Xh + r * kLX + col) = hi;
      *reinterpret_cast<uint4*>(Xl + r * kLX + col) = lo;
    }
    __syncthreads();
    if (active) {
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int kk = 32 * half; kk < 32 * half + 32; kk += 16) {
        // A = B^T (state rows x keys) from the b tile (keys x state rows)
        uint32_t a[P::kMT][4];
#pragma unroll
        for (int i = 0; i < P::kMT; ++i)
          ldsm_x4_t(a[i], Bt + (kk + rr + (mi >> 1) * 8) * kLB + m0 +
                              i * 16 + (mi & 1) * 8);
#pragma unroll
        for (int j = 0; j < P::kNT; j += 2) {
          // B = scaled x (keys x hd): n tiles j and j + 1 in one ldmatrix
          // when both exist
          uint32_t bh[4], bl[4];
          const int off = (kk + rr + (mi & 1) * 8) * kLX + n0 + j * 8 +
                          (j + 1 < P::kNT ? (mi >> 1) * 8 : 0);
          ldsm_x4_t(bh, Xh + off);
          ldsm_x4_t(bl, Xl + off);
#pragma unroll
          for (int i = 0; i < P::kMT; ++i) {
            mma16816(acc[i][j], a[i], bh[0], bh[1]);
            mma16816(acc[i][j], a[i], bl[0], bl[1]);
            if (j + 1 < P::kNT) {
              mma16816(acc[i][j + 1], a[i], bh[2], bh[3]);
              mma16816(acc[i][j + 1], a[i], bl[2], bl[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // stage s and Xh, Xl are rewritten next
  }

  // half 1 hands its sums to half 0 (the stages are free now)
  float4* red = reinterpret_cast<float4*>(smem4);
  if (active && half == 1) {
#pragma unroll
    for (int i = 0; i < P::kMT; ++i)
#pragma unroll
      for (int j = 0; j < P::kNT; ++j)
        red[((wt * P::kMT + i) * P::kNT + j) * 32 + lane] = make_float4(
            acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  }
  __syncthreads();
  if (!active || half == 1) return;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int j = 0; j < P::kNT; ++j) {
      const float4 o = red[((wt * P::kMT + i) * P::kNT + j) * 32 + lane];
      acc[i][j][0] += o.x;
      acc[i][j][1] += o.y;
      acc[i][j][2] += o.z;
      acc[i][j][3] += o.w;
    }
  float* sc = st + bch * d.ns * d.hd;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int j = 0; j < P::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = m0 + i * 16 + g + (r >> 1) * 8;
        const int col = n0 + j * 8 + t2 + (r & 1);
        if (s < d.ns && col < d.hd) sc[s * d.hd + col] = acc[i][j][r];
      }
}

// B: h_0 = hin (0 if null), h_{c+1} = exp(tot_c) h_c + S_c; h_c, the
// state entering chunk c, as bf16 hi and lo halves into hl (per (batch,
// chunk, head): n_state hi, then n_state lo), the final state into hfin
// (if not null).  One thread per (batch, head, entry); hin may be hfin,
// since each thread reads its entry before it writes it.
__global__ void __launch_bounds__(256)
    ssd_state_pass(const float* __restrict__ st,
                   const float* __restrict__ tot, bf16* __restrict__ hl,
                   const float* hin, float* hfin, int B, int nc, int nh,
                   int64_t n_state) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * nh * n_state) return;
  const int64_t bh = e / n_state, i = e - bh * n_state;
  const int64_t bi = bh / nh, head = bh - bi * nh;
  float h = hin != nullptr ? hin[bh * n_state + i] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    // the loads of 8 chunks first, so their latencies overlap
    float s[8], e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t bch = (bi * nc + c0 + k) * nh + head;
      s[k] = c0 + k < nc ? st[bch * n_state + i] : 0.f;
      e[k] = c0 + k < nc ? tot[bch] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k >= nc) break;
      const int64_t bch = (bi * nc + c0 + k) * nh + head;
      split(h, hl[2 * bch * n_state + i], hl[(2 * bch + 1) * n_state + i]);
      h = expf(e[k]) * h + s[k];
    }
  }
  if (hfin != nullptr) hfin[bh * n_state + i] = h;
}

// C: y of one (batch, chunk, head) and a pair of its 64-row q tiles,
// i and nqt - 1 - i, so that every block has about the same work (the
// causal triangle) and reads the entering state and each key tile once
// for both.  Eight warps: warp w owns the 16 rows 16 (w % 4) .. + 15 of
// tile w / 4 of the pair.
template <int NSP, int HDP>
__global__ void __launch_bounds__(kTC, 2)
    ssd_chunk_out(const bf16* __restrict__ x, const bf16* __restrict__ b,
                  const bf16* __restrict__ c, const float* __restrict__ dt,
                  const bf16* __restrict__ hl,
                  const float* __restrict__ cs_in, bf16* __restrict__ y,
                  Dims d) {
  using P = Pass<NSP, HDP>;
  constexpr int kLB = P::kLB, kLX = P::kLX;
  constexpr int kHBytes = P::kHBytes, kKBytes = P::kKBytes;
  constexpr int kUBytes = kHBytes > kKBytes ? kHBytes : kKBytes;
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);  // (128, kLB): both q tiles
  bf16* U = Cs + 2 * kTT * kLB;               // h hi/lo, then key stages
  bf16* Hh = U;                               // (NSP, kLX)
  bf16* Hl = Hh + NSP * kLX;                  // (NSP, kLX)
  bf16* Bk = U;                               // 2 x (64, kLB)
  bf16* Xk = Bk + 2 * kTT * kLB;              // 2 x (64, kLX)
  float* csq = reinterpret_cast<float*>(U + kUBytes / 2);  // (128,)
  float* csk = csq + 2 * kTT;                              // 2 x (64,)
  float* dtk = csk + 2 * kTT;                              // 2 x (64,)

  const int Q = d.Q, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nqt = (Q + kTT - 1) / kTT;
  const int ti = blockIdx.x, tj = nqt - 1 - ti;  // the pair, ti <= tj
  const int head = blockIdx.y;
  const int bi = blockIdx.z / d.nc, ch = blockIdx.z % d.nc;
  const int64_t row0 = ((int64_t)bi * d.ncs + ch) * Q;  // dt/y row of q=0
  const int64_t bch = ((int64_t)bi * d.nc + ch) * d.nh + head;  // scratch
  const bf16* xc = x + bi * d.xsb + ch * d.xsc + head * d.xsh;
  const bf16* bc = b + bi * d.bsb + ch * d.bsc;
  const bf16* cc = c + bi * d.csb + ch * d.csc;
  const float* cs = cs_in + bch * Q;
  const int g = lane >> 2, t2 = (lane & 3) * 2, mi = lane >> 3, rr = lane & 7;
  const int half = warp >> 2;              // which tile of the pair
  const bool active = half == 0 || tj != ti;  // a lone tile has 4 warps
  const int q0 = (half ? tj : ti) * kTT;   // first row of the warp's tile
  const int wr = half * kTT + (warp & 3) * 16;  // its rows in Cs and csq

  // the c tiles, the entering state as hi/lo, cs of the q rows
  load_tile<NSP, kLB>(Cs, cc, d.csq, ti * kTT, Q, d.ns, d.cvec);
  load_tile<NSP, kLB>(Cs + kTT * kLB, cc, d.csq, tj != ti ? tj * kTT : Q, Q,
                      d.ns, d.cvec);
  const bf16* hs = hl + 2 * bch * d.ns * d.hd;
  const bool hvec = d.hd % 8 == 0;
  load_tile<HDP, kLX, NSP>(Hh, hs, d.hd, 0, d.ns, d.hd, hvec);
  load_tile<HDP, kLX, NSP>(Hl, hs + d.ns * d.hd, d.hd, 0, d.ns, d.hd, hvec);
  cp_async_commit();
  if (tid < 2 * kTT) {
    const int q = (tid < kTT ? ti : tj) * kTT + tid % kTT;
    csq[tid] = q < Q ? cs[q] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the c operand of this warp's 16 rows stays in registers
  uint32_t ca[NSP / 16][4];
#pragma unroll
  for (int kk = 0; kk < NSP / 16; ++kk)
    ldsm_x4(ca[kk], Cs + (wr + rr + (mi & 1) * 8) * kLB + kk * 16 +
                        (mi >> 1) * 8);

  // inter-chunk: acc = c . h, then rows scaled by exp(cs_q)
  float acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < NSP / 16; ++kk)
#pragma unroll
      for (int j = 0; j < HDP / 8; j += 2) {
        uint32_t bh[4], bl[4];
        const int off = (kk * 16 + rr + (mi & 1) * 8) * kLX + j * 8 +
                        (mi >> 1) * 8;
        ldsm_x4_t(bh, Hh + off);
        ldsm_x4_t(bl, Hl + off);
        mma16816(acc[j], ca[kk], bh[0], bh[1]);
        mma16816(acc[j], ca[kk], bl[0], bl[1]);
        mma16816(acc[j + 1], ca[kk], bh[2], bh[3]);
        mma16816(acc[j + 1], ca[kk], bl[2], bl[3]);
      }
  }
  const int qa = q0 + (warp & 3) * 16 + g, qb = qa + 8;  // this thread's rows
  const float csa = csq[wr + g], csb = csq[wr + g + 8];
  {
    const float e0 = expf(csa), e1 = expf(csb);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }
  __syncthreads();  // h is no longer read: its space takes the key stages

  // intra-chunk: key tiles up to the later tile's diagonal, double-
  // buffered; each warp skips the tiles past its rows
  const int n_kt = tj + 1;
  auto load_stage = [&](int t) {
    const int s = t & 1, p0 = t * kTT;
    load_tile<NSP, kLB>(Bk + s * kTT * kLB, bc, d.bsq, p0, Q, d.ns, d.bvec);
    load_tile<HDP, kLX>(Xk + s * kTT * kLX, xc, d.xsq, p0, Q, d.hd, d.xvec);
    if (tid < kTT) {
      const int p = p0 + tid;
      if (p < Q) {
        cp_async4(csk + s * kTT + tid, cs + p);
        cp_async4(dtk + s * kTT + tid, dt + (row0 + p) * d.nh + head);
      } else {
        csk[s * kTT + tid] = dtk[s * kTT + tid] = 0.f;
      }
    }
    cp_async_commit();
  };
  load_stage(0);
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) {
      load_stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = t & 1, p0 = t * kTT;
    // keys past every row of this warp add nothing
    if (active && p0 <= q0 + (warp & 3) * 16 + 15) {
      const bf16* Bt = Bk + s * kTT * kLB;
      const bf16* Xt = Xk + s * kTT * kLX;
      const float* ck = csk + s * kTT;
      const float* dk = dtk + s * kTT;
      // scores c . b over 64 keys (8 n tiles)
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NSP / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, Bt + (j * 8 + rr + (mi >> 1) * 8) * kLB + kk * 16 +
                          (mi & 1) * 8);
          mma16816(sc[j], ca[kk], bb[0], bb[1]);
          mma16816(sc[j + 1], ca[kk], bb[2], bb[3]);
        }
      // W = scores exp(cs_q - cs_p) dt_p where p <= q, then y += W x,
      // W split hi + lo.  On the diagonal tile the decay is computed per
      // entry where p <= q only (select, never mask: it is inf for
      // q < p).  Below it every p <= q, and with m the tile's last key
      // the decay splits as exp(cs_q - cs_m) exp(cs_m - cs_p), both
      // factors <= 1 (cs falls), so an exp per row and per key does.
      if (p0 == q0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int pl = j * 8 + t2 + (r & 1), p = p0 + pl;
            const int q = (r >> 1) ? qb : qa;
            const float cq = (r >> 1) ? csb : csa;
            sc[j][r] = (q < Q && p <= q)
                           ? sc[j][r] * expf(cq - ck[pl]) * dk[pl]
                           : 0.f;
          }
      } else {
        const float cm = ck[kTT - 1];  // a full tile: p0 + 63 < q0 < Q
        const float ra = qa < Q ? expf(csa - cm) : 0.f;
        const float rb = qb < Q ? expf(csb - cm) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pl = j * 8 + t2 + e;
            const float kp = expf(cm - ck[pl]) * dk[pl];
            sc[j][e] = sc[j][e] * ra * kp;
            sc[j][2 + e] = sc[j][2 + e] * rb * kp;
          }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t wh[4], wl[4];
        split2(sc[2 * kk][0], sc[2 * kk][1], wh[0], wl[0]);
        split2(sc[2 * kk][2], sc[2 * kk][3], wh[1], wl[1]);
        split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], wh[2], wl[2]);
        split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], wh[3], wl[3]);
#pragma unroll
        for (int j = 0; j < HDP / 8; j += 2) {
          uint32_t xb[4];
          ldsm_x4_t(xb, Xt + (kk * 16 + rr + (mi & 1) * 8) * kLX + j * 8 +
                            (mi >> 1) * 8);
          mma16816(acc[j], wh, xb[0], xb[1]);
          mma16816(acc[j], wl, xb[0], xb[1]);
          mma16816(acc[j + 1], wh, xb[2], xb[3]);
          mma16816(acc[j + 1], wl, xb[2], xb[3]);
        }
      }
    }
    __syncthreads();  // stage s is refilled next
  }
  if (!active) return;

  // y rows qa, qb
  bf16* yb = y + (row0 * d.nh + head) * (int64_t)d.hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = hr ? qb : qa, col = j * 8 + t2;
      if (q >= Q) continue;
      bf16* dst = yb + (int64_t)q * d.nh * d.hd + col;
      const float v0 = acc[j][2 * hr], v1 = acc[j][2 * hr + 1];
      if (col + 1 < d.hd && (d.hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < d.hd) dst[0] = __float2bfloat16(v0);
        if (col + 1 < d.hd) dst[1] = __float2bfloat16(v1);
      }
    }
}

// The three passes over d.nc chunks, from the state hin (null: zeros).
template <int NSP, int HDP>
cudaError_t launch_bf16(const void* x, const void* b, const void* c,
                        const void* dt, const void* da, void* y,
                        const float* hin, void* hfin, void* scratch,
                        int64_t B, const Dims& d, cudaStream_t stream) {
  using P = Pass<NSP, HDP>;
  const int64_t n_state = (int64_t)d.ns * d.hd;
  const int64_t n_bch = B * d.nc * d.nh;
  float* st = (float*)scratch;
  bf16* hl = (bf16*)(st + n_bch * n_state);
  float* cs = st + 2 * n_bch * n_state;
  float* tot = cs + n_bch * d.Q;
  const size_t a_bytes = P::kABytes + (size_t)d.Q * 8;
  auto ka = ssd_chunk_state<NSP, HDP>;
  auto kc = ssd_chunk_out<NSP, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kc, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kCBytes);
  if (err != cudaSuccess) return err;
  ka<<<dim3((unsigned)d.nh, (unsigned)d.nc, (unsigned)B), kTC, a_bytes,
       stream>>>((const bf16*)x, (const bf16*)b, (const float*)dt,
                 (const float*)da, st, cs, tot, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = B * d.nh * n_state;
  ssd_state_pass<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      st, tot, hl, hin, (float*)hfin, (int)B, d.nc, d.nh, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kc<<<dim3((unsigned)((d.Q + 2 * kTT - 1) / (2 * kTT)), (unsigned)d.nh,
            (unsigned)(B * d.nc)),
       kTC, P::kCBytes, stream>>>((const bf16*)x, (const bf16*)b,
                                  (const bf16*)c, (const float*)dt, hl, cs,
                                  (bf16*)y, d);
  return cudaGetLastError();
}

template <int NSP>
cudaError_t launch_hd(const void* x, const void* b, const void* c,
                      const void* dt, const void* da, void* y,
                      const float* hin, void* hfin, void* scratch, int64_t B,
                      const Dims& d, cudaStream_t s) {
  if (d.hd <= 16)
    return launch_bf16<NSP, 16>(x, b, c, dt, da, y, hin, hfin, scratch, B, d,
                                s);
  if (d.hd <= 64)
    return launch_bf16<NSP, 64>(x, b, c, dt, da, y, hin, hfin, scratch, B, d,
                                s);
  return launch_bf16<NSP, 128>(x, b, c, dt, da, y, hin, hfin, scratch, B, d,
                               s);
}

// bf16: the chunks in groups of at most ``group``, one group after
// another on the stream, each group's passes from the state the previous
// group's state pass left in hfin; scratch holds one group.
cudaError_t launch_groups(const void* x, const void* b, const void* c,
                          const void* dt, const void* da, void* y,
                          void* hfin, void* scratch, int64_t B, Dims d,
                          int64_t group, cudaStream_t s) {
  const int64_t nc = d.ncs, rows = (int64_t)d.Q * d.nh;
  cudaError_t err = cudaSuccess;
  for (int64_t c0 = 0; c0 < nc && err == cudaSuccess; c0 += group) {
    d.nc = (int)(nc - c0 < group ? nc - c0 : group);
    const bf16* xg = (const bf16*)x + c0 * d.xsc;
    const bf16* bg = (const bf16*)b + c0 * d.bsc;
    const bf16* cg = (const bf16*)c + c0 * d.csc;
    const float* dtg = (const float*)dt + c0 * rows;
    const float* dag = (const float*)da + c0 * rows;
    bf16* yg = (bf16*)y + c0 * rows * d.hd;
    const float* hin = c0 ? (const float*)hfin : nullptr;
    if (d.ns <= 16)
      err = launch_hd<16>(xg, bg, cg, dtg, dag, yg, hin, hfin, scratch, B, d,
                          s);
    else if (d.ns <= 64)
      err = launch_hd<64>(xg, bg, cg, dtg, dag, yg, hin, hfin, scratch, B, d,
                          s);
    else
      err = launch_hd<128>(xg, bg, cg, dtg, dag, yg, hin, hfin, scratch, B,
                           d, s);
  }
  return err;
}

bool rows16(const void* base, int64_t stride, int n) {
  return ((uintptr_t)base & 15) == 0 && stride % 8 == 0 && n % 8 == 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, nc, Q, nh, hd) and y (contiguous, same shape); b, c (B, nc, Q, ns);
// dt, da (B, nc, Q, nh) f32 contiguous; hfin (B, nh, ns, hd) f32 or null.
// Strides are in elements; x, b and c have unit stride in their last
// dimension.  dtype (of x, b, c and y) 0: float32, 1: bfloat16.  bf16 only:
// the chunks go in groups of at most ``group`` (B * group <= 65535; hfin
// not null when group < nc, as it carries the state between groups), and
// scratch holds B * group * nh * (2 * ns * hd + Q + 1) floats.
int ssd_scan(const void* x, const void* b, const void* c, const void* dt,
             const void* da, void* y, void* hfin, void* scratch, int64_t B,
             int64_t nc, int64_t Q, int64_t nh, int64_t hd, int64_t ns,
             int64_t xsb, int64_t xsc, int64_t xsq, int64_t xsh, int64_t bsb,
             int64_t bsc, int64_t bsq, int64_t csb, int64_t csc, int64_t csq,
             int64_t group, int64_t dtype, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || nh < 1 || hd < 1 || ns < 1 || B > 65535 ||
      nh > 65535 || Q > 4096 || hd > 128 || ns > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dims d{(int)nc, (int)Q, (int)nh, (int)hd, (int)ns, xsb, xsc, xsq, xsh,
               bsb, bsc, bsq, csb, csc, csq,
               rows16(x, xsq, (int)hd) && xsb % 8 == 0 && xsc % 8 == 0 &&
                   xsh % 8 == 0,
               rows16(b, bsq, (int)ns) && bsb % 8 == 0 && bsc % 8 == 0,
               rows16(c, csq, (int)ns) && csb % 8 == 0 && csc % 8 == 0,
               (int)nc};
  if (dtype == 0) return (int)launch_t(x, b, c, dt, da, y, hfin, B, d, s);
  if (dtype != 1 || scratch == nullptr || group < 1 || B * group > 65535 ||
      (group < nc && hfin == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_groups(x, b, c, dt, da, y, hfin, scratch, B, d, group,
                            s);
}

}  // extern "C"
