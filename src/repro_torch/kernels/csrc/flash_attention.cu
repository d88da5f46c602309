// Hopper kernels of forward flash attention, with a plain C interface for
// ctypes (built by kernels/_build.py).
//
//   flash_attention  replaces flash_attention_pallas
//                    (src/repro/kernels/flash_attention/flash_attention.py:72,
//                    its pl.pallas_call at :93)
//
// The math is the Pallas kernel's (_attn_kernel, same file :30-69): f32
// scores scaled by 1/sqrt(D), masked entries set to -1e30 and their p
// zeroed explicitly (never left to exp underflow), a running max and
// denominator in f32, and the output acc / max(l, 1e-30) cast to the input
// type.  GQA: query head h reads KV head h / group directly; k and v are
// never repeated.  q, k and v are read through their (B, S, H) strides.
//
// Bound: operations.  At the serving path's prefill (B 4, S 1024, H 64,
// KVH 8, D 128, causal, bf16) the function needs 68.8 GFLOP over the
// causal pairs -- 0.0696 ms at the 989 TFLOP/s of bf16 tensor cores --
// against about 151 MB moved, 0.045 ms at 3.35 TB/s.
//
// bf16: flash_attention_wgmma, on the tensor cores.  A block owns one
// (batch, head, 128-row q tile) and has three warpgroups: two consumers
// of 64 q rows each (wgmma takes M = 64) and a producer, which at D 128
// hands its registers to the consumers (setmaxnreg).  The producer's one
// thread loads the q tile once and then the K and V tiles -- 64 keys in
// three stages at D 128, 128 keys in two below -- into a ring of shared-
// memory stages with the Tensor Memory Accelerator; each stage has a full
// and an empty mbarrier.  The (B, S, H, D) strides go into three 4-d
// tensor maps, encoded on the host for each call (cuTensorMapEncodeTiled,
// found in libcuda, which the CUDA runtime has already loaded) and passed as
// __grid_constant__ parameters.  Tiles land in shared memory with the
// widest swizzle their rows allow (128 B for D 64 and 128, cut into
// 64-column blocks; 64 B for D 32; 32 B for D 16, and for D 8, whose rows
// the map pads to 16 columns with the zeros it fills outside the tensor).
// Each consumer warpgroup computes its scores S = Q K^T with wgmma from
// shared memory into f32 registers, masks them where a tile crosses the
// diagonal, the window's edge or Skv, runs the online softmax in
// registers (row max and sum are shuffles over the four lanes that share
// a row of the accumulator), rounds p to bf16 in registers -- the
// accumulator's layout is the A operand's -- and adds P V with wgmma, V
// read from shared memory by its descriptor (MN-major).  It then releases
// the stage.  The two warpgroups run unsynchronised, so one's softmax
// overlaps the other's products.  (Issuing the next S before this P V,
// FA3's pipeline within a warpgroup, made ptxas serialise the wgmma, and
// a ping-pong of the two warpgroups' turns through named barriers ran
// slower on the card.)  kv tiles that the causal or window
// mask empties for every row of the q tile are neither loaded nor
// computed; q tiles with the most causal work are scheduled first; tails
// past S are zero rows that TMA fills and the mask or the store skips, so
// any S works.  The output (B, Sq, H, D) is written as bf16 from
// registers.
//
// Where the numbers depart from the Pallas kernel's: p is rounded to bf16
// before P V (Pallas keeps p in f32; the JAX model's XLA path and the
// port's "torch" path round p to the value type, as here), and the
// softmax runs in base 2 on scores prescaled by log2(e) / sqrt(D), which
// changes only f32 rounding.  l sums the unrounded f32 p.
//
// float32: flash_attention_kernel, the CUDA-core kernel of the first port,
// kept as the f32 instantiation: TF32 tensor cores keep about three digits
// and would break the f32 bounds (2e-5 against the plain version).  f32
// runs only in the on-card checks, never in bf16 serving.  A block owns one
// (batch, head, 64-row q tile) and loops over 32-key tiles converted to
// f32 in shared memory; 256 threads, each four rows by a strided column
// set; p goes through shared memory for p @ v.  Both kernels count as
// flash_attention launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the Pallas kernel's NEG_INF

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per kv tile
constexpr int kThreads = 256;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Skv, int H,
                           int group, int64_t qsb, int64_t qss, int64_t qsh,
                           int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                           int64_t vss, int64_t vsh, float scale, int causal,
                           int window) {
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * kDP + d] = s < Sq ? qb[s * qss + d] : 0.f;
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
      Ks[r * kDP + d] = in ? kb[s * kss + d] : 0.f;
      Vs[r * D + d] = in ? vb[s * vss + d] : 0.f;
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
    float* orow = out + (((int64_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < D) orow[col] = acc[i][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

template <int D>
struct Wg {
  static constexpr int kDP = D < 16 ? 16 : D;  // head dim padded for wgmma K
  static constexpr int kSW = kDP * 2 >= 128 ? 128 : kDP * 2;  // swizzle, B
  static constexpr int kCW = kSW / 2;          // columns of a column block
  static constexpr int kCB = kDP / kCW;        // column blocks of a tile
  static constexpr int kBM = 128;              // q rows per block
  static constexpr int kBN = D == 128 ? 64 : 128;
  static constexpr int kStages = D == 128 ? 3 : 2;
  static constexpr int kQBytes = kBM * kDP * 2;
  static constexpr int kKVBytes = kBN * kDP * 2;  // one of K, V per stage
  // 1 KB of slack to align the tiles to 1024 B, then barriers
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 64;
  static constexpr int kLayout = kSW == 128 ? 1 : kSW == 64 ? 2 : 3;
};

constexpr int kWgThreads = 384;  // two consumer warpgroups + a producer one

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed; a wait that
// outlasts 2^26 polls (seconds) traps, so a broken pipeline fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n == (1u << 26)) __trap();
  }
}

// one box of a 4-d tensor map into shared memory, completion on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, smem) * b (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, smem) * b (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 16, f32) += a (64 x 16, bf16 in registers) * b (16 x 16,
// smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += a (64 x 16, bf16 in registers) * b (16 x 32,
// smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, bf16 in registers) * b (16 x 64,
// smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, bf16 in registers) * b (16 x 128,
// smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b);
  else wgmma_ss_n128(d, a, b);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                          int H, int group, float scale_log2, int causal,
                          int window) {
  using C = Wg<D>;
  constexpr int kDP = C::kDP, kSW = C::kSW, kCW = C::kCW, kCB = C::kCB;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                               // kCB x kBM x kSW
  const uint32_t sK = sQ + C::kQBytes;                    // stage s at + s*
  const uint32_t sV = sK + kStages * C::kKVBytes;         //   C::kKVBytes
  const uint32_t bars = sV + kStages * C::kKVBytes;
  const uint32_t q_bar = bars;                  // q tile loaded
  const uint32_t full_bar = bars + 8;           // + 8 s: stage s loaded
  const uint32_t empty_bar = bars + 8 + 8 * kStages;  // + 8 s: s released

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;

  // the kv tiles some row of this q tile can see
  const int q_end = min(q0 + kBM, Sq);
  const int kv_end = causal ? min(Skv, q_end) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBN;
  const int n_tiles = max(0, (kv_end + kBN - 1) / kBN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: warp 8's lane 0 starts every load.  At D 128 the
    // warpgroup gives registers to the consumers, whose two 64-register
    // accumulators need them (168 each at launch: 128 x 144 freed here,
    // 256 x 72 taken there)
    if constexpr (D == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        tma_load_4d(sQ + cb * kBM * kSW, &tq, q_bar, cb * kCW, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, use = it / kStages;
        if (use > 0) mbar_wait(empty_bar + 8 * s, (use - 1) & 1);
        const uint32_t full = full_bar + 8 * s;
        mbar_expect_tx(full, 2 * C::kKVBytes);
        const int k0 = (t_begin + it) * kBN;
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_4d(sK + s * C::kKVBytes + cb * kBN * kSW, &tk, full,
                      cb * kCW, kvh, k0, b);
          tma_load_4d(sV + s * C::kKVBytes + cb * kBN * kSW, &tv, full,
                      cb * kCW, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63.  In the
  // accumulator of an m64nN wgmma, register j of a thread holds row
  // (warp % 4) * 16 + lane / 4 + 8 * ((j / 2) % 2) and column
  // (j / 4) * 8 + (lane % 4) * 2 + j % 2.
  if constexpr (D == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2, wg_lo = q0 + wg * 64;  // first row of wg
  const int r0 = wg_lo + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = (lane & 3) * 2;

  float o[kDP / 2], sc[kBN / 2];
#pragma unroll
  for (int j = 0; j < kDP / 2; ++j) o[j] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  const uint32_t q_wg = sQ + wg * 64 * kSW;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
    const uint32_t k_s = sK + s * C::kKVBytes, v_s = sV + s * C::kKVBytes;

    // S = Q K^T: K-major operands, 16 columns (32 B) of D per step
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) sc[j] = 0.f;
    fence_regs<kBN / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      const int cb = kk / (kSW / 32);            // column block
      const uint32_t off = (kk % (kSW / 32)) * 32;  // bytes into its rows
      wgmma_ss<kBN>(sc,
                    make_desc(q_wg + cb * kBM * kSW + off, 16, 8 * kSW,
                              C::kLayout),
                    make_desc(k_s + cb * kBN * kSW + off, 16, 8 * kSW,
                              C::kLayout));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBN / 2>(sc);

    // mask (only tiles that cross the diagonal, the window's edge or Skv),
    // then the online softmax in base 2
    const int k0 = (t_begin + it) * kBN;
    const bool edge = k0 + kBN > Skv || (causal && k0 + kBN - 1 > wg_lo) ||
                      (window > 0 && k0 <= wg_lo + 63 - window);
    float mx0 = kNeg, mx1 = kNeg;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) {
        const int col = k0 + (j >> 2) * 8 + cq + (j & 1);
        const int row = (j & 2) ? r1 : r0;
        const bool ok = col < Skv && (!causal || row >= col) &&
                        (window <= 0 || col > row - window);
        sc[j] = ok ? sc[j] * scale_log2 : kNeg;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) sc[j] *= scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      if (j & 2) mx1 = fmaxf(mx1, sc[j]);
      else mx0 = fmaxf(mx0, sc[j]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const float mn = (j & 2) ? mn1 : mn0;
      const float p = sc[j] == kNeg ? 0.f : exp2f(sc[j] - mn);
      sc[j] = p;
      if (j & 2) rs1 += p;
      else rs0 += p;
    }
    l0 = l0 * corr0 + rs0;  // this thread's part of the row sums
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int j = 0; j < kDP / 2; ++j) o[j] *= (j & 2) ? corr1 : corr0;

    // p in bf16 as the A operand: 16 keys per step
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[kk * 8 + 0], sc[kk * 8 + 1]);
      pa[kk][1] = pack_bf16(sc[kk * 8 + 2], sc[kk * 8 + 3]);
      pa[kk][2] = pack_bf16(sc[kk * 8 + 4], sc[kk * 8 + 5]);
      pa[kk][3] = pack_bf16(sc[kk * 8 + 6], sc[kk * 8 + 7]);
    }
    // O += P V: V (keys x D) MN-major, 16 keys (16 rows of kSW B) a step,
    // column blocks kBN * kSW apart
    fence_regs<kDP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<kDP>(o, pa[kk],
                    make_desc(v_s + kk * 16 * kSW, kBN * kSW, 8 * kSW,
                              C::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDP / 2>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDP / 2; j += 2) {
    const int row = (j & 2) ? r1 : r0;
    const int col = (j >> 2) * 8 + cq;
    if (row < Sq && col < D) {
      const float d = (j & 2) ? d1 : d0;
      *reinterpret_cast<uint32_t*>(
          out + (((int64_t)b * Sq + row) * H + h) * D + col) =
          pack_bf16(o[j] / d, o[j + 1] / d);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  int64_t B, Sq, Skv, H, KVH;
  int64_t qs[3], ks[3], vs[3];
  float scale;
  int causal, window;
};

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D>;
  const size_t smem = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)a.H,
                  (unsigned)a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (float*)a.out, (int)a.Sq, (int)a.Skv, (int)a.H, (int)(a.H / a.KVH),
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1],
      a.vs[2], a.scale, a.causal, a.window);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime loaded
// (no link against libcuda needed)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

// a (B, S, heads, D) bf16 tensor with element strides st = (b, s, head) as
// a 4-d map {D, heads, S, B}; boxes of box_cols x 1 x box_rows x 1
cudaError_t make_map(CUtensorMap* map, const void* base, int64_t B,
                     int64_t S, int64_t heads, int64_t D, const int64_t* st,
                     int box_cols, int box_rows, int swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using C = Wg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      make_map(&tq, a.q, a.B, a.Sq, a.H, D, a.qs, C::kCW, C::kBM, C::kSW);
  if (err == cudaSuccess)
    err = make_map(&tk, a.k, a.B, a.Skv, a.KVH, D, a.ks, C::kCW, C::kBN,
                   C::kSW);
  if (err == cudaSuccess)
    err = make_map(&tv, a.v, a.B, a.Skv, a.KVH, D, a.vs, C::kCW, C::kBN,
                   C::kSW);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_wgmma<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Sq + C::kBM - 1) / C::kBM), (unsigned)a.H,
                  (unsigned)a.B);
  kern<<<grid, kWgThreads, C::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)a.out, (int)a.Sq, (int)a.Skv, (int)a.H,
      (int)(a.H / a.KVH), a.scale * 1.4426950408889634f, a.causal,
      a.window);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch(const Args& a, int64_t D, cudaStream_t s) {
  switch (D) {
    case 8: return kBf16 ? launch_bf16<8>(a, s) : launch_f32<8>(a, s);
    case 16: return kBf16 ? launch_bf16<16>(a, s) : launch_f32<16>(a, s);
    case 32: return kBf16 ? launch_bf16<32>(a, s) : launch_f32<32>(a, s);
    case 64: return kBf16 ? launch_bf16<64>(a, s) : launch_f32<64>(a, s);
    case 128: return kBf16 ? launch_bf16<128>(a, s) : launch_f32<128>(a, s);
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
// dtype 0: float32, 1: bfloat16 (base addresses 16-byte aligned, strides
// multiples of 8 elements, Skv >= 1: the tensor maps need them).
// D in {8, 16, 32, 64, 128}.
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
  if (dtype == 0) return (int)launch<false>(a, D, s);
  if (dtype == 1) return (int)launch<true>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
