// Hopper kernels of the timestamp and varint encode paths, with a plain C
// interface for ctypes (built by kernels/_build.py).
//
//   delta_zigzag         replaces delta_zigzag_pallas
//                        (src/repro/kernels/delta_encode/delta_encode.py:40)
//   delta_zigzag_varint  replaces delta_zigzag_varint_pallas (same file,
//                        :100)
//   uvarint_encode64     replaces uvarint_encode64_pallas (same file, :155)
//   uvarint_pack64       the same function to the packed byte stream: the
//                        one the encode path launches
//   fit_columns          replaces fit_columns_pallas (same file, :202)
//
// All of them are bound by memory traffic: each reads its input once and
// writes its output once, with a handful of integer operations per byte.
// At the tracer's sizes (tens of thousands of elements per call) the time
// is launch latency and the host<->device copies, not HBM bandwidth, so
// the two kernels the encode path launches most (delta_zigzag and
// uvarint_pack64) are built to need fewer launches and fewer bytes across
// PCIe: delta_zigzag encodes every block of a streaming flush in one
// launch (``segment``), and uvarint_pack64 emits the packed bytes on the
// card, so the host copies back only those and scatters nothing.
//
// The TPU versions walk the grid in order and carry the previous block's
// last element in VMEM scratch; here blocks run in any order, so a thread
// gets its left neighbour from the previous lane (delta_zigzag) or from
// global memory (the others), and uvarint_pack64 finds its tile's output
// offset by a decoupled look-back over the tiles before it.  Fixed
// 256-thread blocks with a masked tail replace the Pallas shrink-to-a-
// divisor block loop.  Each entry point returns cudaGetLastError() so the
// wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ uint32_t zigzag32(uint32_t d) {
  return (d << 1) ^ (0u - (d >> 31));
}

// flat u32 ticks -> zigzag of the first-order delta, wrapped mod 2^32;
// element i is taken against 0 (i.e. kept) where i % segment == 0, or
// only at i == 0 when segment is 0.  All arithmetic is unsigned: signed
// overflow and left shifts of negative values are UB in C++.
//
// Each thread takes 4 consecutive values, with one 16-byte load where x is
// 16-byte aligned and the 4 lie inside the array (scalar loads for the
// tail).  The left neighbour of its first value is the previous lane's
// last, by shuffle; only lane 0 of a warp reads one word from memory.  A
// grid of a few blocks an SM walks the array with a grid stride; the loop
// bound is the warp's first group, so whole warps stay in the loop and
// every lane takes part in the shuffle.
__global__ void __launch_bounds__(kThreads)
    delta_zigzag_kernel(const uint32_t* __restrict__ x,
                        uint32_t* __restrict__ out, int64_t n,
                        int64_t segment, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t n4 = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint64_t seg = (uint64_t)segment;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       w < n4; w += stride) {
    const int64_t g = w + lane, i0 = 4 * g;
    const bool full = vec && i0 + 4 <= n;
    // lane 0's left neighbour, loaded beside the values rather than after
    // the shuffle that waits for them
    const uint32_t left =
        (lane == 0 && i0 > 0 && i0 < n) ? x[i0 - 1] : 0u;
    uint32_t v[4];
    if (full) {
      const uint4 t = reinterpret_cast<const uint4*>(x)[g];
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = i0 + k < n ? x[i0 + k] : 0u;
    }
    uint32_t prev = __shfl_up_sync(0xffffffffu, v[3], 1);
    if (lane == 0) prev = left;
    // position of element i0 within its segment
    const uint64_t r = seg ? (uint64_t)i0 % seg : (uint64_t)i0;
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool start = seg ? (r + k) % seg == 0 : i0 + k == 0;
      o[k] = zigzag32(v[k] - (start ? 0u : prev));
      prev = v[k];
    }
    if (full) {
      reinterpret_cast<uint4*>(out)[g] = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) out[i0 + k] = o[k];
    }
  }
}

// The fused tick encode: delta_zigzag above, then the 5-plane varint split
// of a u32 (a u32 varint is at most 5 bytes) in the same pass, so the
// zigzag values never make a round trip through device memory before
// they are split.  The host scatters the planes into the byte stream.
__global__ void delta_zigzag_varint_kernel(const uint32_t* __restrict__ x,
                                           uint32_t* __restrict__ zz,
                                           int32_t* __restrict__ lens,
                                           uint8_t* __restrict__ planes,
                                           int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t prev = i ? x[i - 1] : 0u;
  uint32_t d = x[i] - prev;
  uint32_t z = (d << 1) ^ (0u - (d >> 31));
  zz[i] = z;
  int len = 1;
#pragma unroll
  for (int k = 1; k < 5; ++k) len += z >= (1u << (7 * k));
  lens[i] = len;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    uint32_t b = (z >> (7 * j)) & 0x7Fu;
    if (j < len - 1) b |= 0x80u;
    planes[(int64_t)j * n + i] = (uint8_t)b;
  }
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

// u64 values -> their uvarints packed end to end, in one launch.  A block
// takes a tile of kPackTile values, 4 a thread (two 16-byte loads where v
// is 16-byte aligned and the 4 lie inside the array), computes their byte
// counts, and scans them over the block.  The tile's offset in the output
// comes from the decoupled look-back of lookback.cuh, run by warp 0 while
// the others stage their bytes.  The block stages its bytes in shared
// memory and writes them out with 4-byte stores, a byte at a time only at
// the two ragged ends.  The last tile writes the total length.
//
// status (from the wrapper, zeroed): [0] the tile counter, [1] the total,
// [2 + t] the look-back word of tile t.
constexpr int kPackVals = 4;
constexpr int kPackTile = kThreads * kPackVals;
constexpr int kWarps = kThreads / 32;

// bytes of the uvarint of v: 7 bits a byte, at least one
__device__ __forceinline__ int uvarint_len(uint64_t v) {
  return (64 - __clzll((long long)(v | 1ull)) + 6) / 7;
}

__global__ void __launch_bounds__(kThreads)
    uvarint_pack64_kernel(const uint64_t* __restrict__ v,
                          uint8_t* __restrict__ out,
                          unsigned long long* status, int64_t n,
                          int vec) {
  __shared__ uint8_t stage[10 * kPackTile];
  __shared__ int warp_incl[kWarps];
  __shared__ long long tile_s;
  __shared__ unsigned long long prefix_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = lookback::take_tile(status, &tile_s);
  const int64_t base = tile * kPackTile + (int64_t)tid * kPackVals;

  uint64_t x[kPackVals];
  if (vec && base + kPackVals <= n) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(v + base);
#pragma unroll
    for (int k = 0; k < kPackVals / 2; ++k) {
      const ulonglong2 t = p[k];
      x[2 * k] = t.x;
      x[2 * k + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPackVals; ++k) x[k] = base + k < n ? v[base + k] : 0;
  }
  int len[kPackVals], sum = 0;
#pragma unroll
  for (int k = 0; k < kPackVals; ++k) {
    len[k] = base + k < n ? uvarint_len(x[k]) : 0;
    sum += len[k];
  }

  // the thread's offset within the tile, and the tile's byte count
  int agg;
  const int excl =
      lookback::block_exclusive_scan<kThreads>(sum, warp_incl, &agg);

  if (warp == 0) {
    const unsigned long long prefix =
        lookback::tile_prefix(status + 2, tile, (unsigned)agg);
    if (lane == 0) {
      prefix_s = prefix;
      if (tile == (int64_t)gridDim.x - 1) status[1] = prefix + (unsigned)agg;
    }
  }
  int o = excl;
#pragma unroll
  for (int k = 0; k < kPackVals; ++k) {
    for (int j = 0; j < len[k]; ++j) {
      const uint32_t b = (uint32_t)(x[k] >> (7 * j)) & 0x7Fu;
      stage[o + j] = (uint8_t)(j < len[k] - 1 ? b | 0x80u : b);
    }
    o += len[k];
  }
  __syncthreads();

  // out[prefix, prefix + agg) = stage[0, agg): the bytes up to the first
  // 4-byte boundary, 4-byte words, then the bytes after the last one
  uint8_t* dst = out + prefix_s;
  const int head = min((int)((4 - ((uintptr_t)dst & 3)) & 3), agg);
  const int n32 = (agg - head) / 4, tail = head + 4 * n32;
  if (tid < head) dst[tid] = stage[tid];
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + head);
  for (int w = tid; w < n32; w += kThreads) {
    const uint8_t* s = stage + head + 4 * w;
    d32[w] = (uint32_t)s[0] | (uint32_t)s[1] << 8 | (uint32_t)s[2] << 16 |
             (uint32_t)s[3] << 24;
  }
  if (tid < agg - tail) dst[tail + tid] = stage[tail + tid];
}

// fit_columns: (C, R) int64 rows, the row stride ld >= R and the column
// stride 1 -> one packed int64 buffer of C + ceil(C / 2) words: the first
// deltas v[1] - v[0] in words [0, C), then, as int32, the flags (1 if
// every first-order delta is 0, 2 if every delta equals a nonzero first
// delta, else 0).  The wrapper copies the buffer back in one D2H copy.
// All arithmetic is unsigned, so it wraps mod 2^64.
//
// Bound by bytes: 8 C R read, 12 C written.  A warp a row, lanes striding
// over the ranks, would give (256, 16384) 32 blocks of 8 warps on a
// 132-SM card, load each value twice, and idle at least 24 of a warp's
// lanes at R <= 8.  Instead, two routes:
//
// rows  (R <= kFitRowsMax and at least kFitRowsMinWarps warps of rows an
//       SM): a thread a row, walking it kFitChunk values at a time
//       (16-byte loads where the row is 16-byte aligned, else 8-byte
//       ones; a chunk's loads are in flight together).  A thread's few
//       instructions a row keep many short rows fast, while a few rows
//       would leave the card idle and wait a round trip a chunk.  (Staging
//       a warp's 32 x 16 tile through shared memory with coalesced loads
//       was slower on the H100: 152 registers, half the warps an SM.)
// tiles (otherwise): a warp a (row, span of ranks), the span sized
//       so the card holds about 32 warps an SM.  A lane holds two
//       consecutive values (one 16-byte load where the row is aligned;
//       else two 8-byte loads 32 values apart, each coalesced) and takes
//       the delta to its left neighbour with __shfl_up_sync; lane 0's left
//       neighbour is the previous step's last value, or the span's halo
//       v[s0 - 1] from global memory.  A warp loads kFitUnroll steps of 64
//       values before it uses them.  Every warp reads v[0] and v[1] of its
//       row for d0.  Blocks run in no order, so a row split over several
//       spans combines their verdicts: each span ORs "a delta != 0" (bit
//       0) and "a delta != d0" (bit 1) into the row's word of a scratch
//       buffer, then counts itself done there after a fence; the last
//       span of the row turns the word into the flag and sets the word and
//       the count back to 0.  The wrapper keeps one zeroed scratch a
//       stream, which every launch leaves zeroed, so no launch has to
//       clear it.  The span that holds rank 1 writes d0.
constexpr int kFitRowsMax = 64;
constexpr int kFitRowsMinWarps = 4;             // rows route: warps an SM
constexpr int kFitRowsThreads = 128;
constexpr int kFitChunk = 16;                   // values a rows thread loads
constexpr int kFitStep = 64;                    // values a warp step covers
constexpr int kFitUnroll = 4;                   // steps loaded at once
constexpr int kFitQuantum = kFitStep * kFitUnroll;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t fit_flag(bool zero, bool same,
                                            uint64_t d0) {
  return zero ? 1 : ((same && d0 != 0) ? 2 : 0);
}

__global__ void __launch_bounds__(kFitRowsThreads)
    fit_columns_rows(const uint64_t* __restrict__ V,
                     int64_t* __restrict__ packed, int64_t c, int r,
                     int64_t ld) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= c) return;
  const uint64_t* v = V + row * ld;
  const bool vec = ((uintptr_t)v & 15) == 0;
  uint64_t d0 = 0, prev = 0;
  bool zero = true, same = true;
  for (int j0 = 0; j0 < r; j0 += kFitChunk) {
    uint64_t x[kFitChunk];
#pragma unroll
    for (int j = 0; j < kFitChunk; j += 2) {
      const int i = j0 + j;
      x[j] = x[j + 1] = 0;
      if (vec && i + 1 < r) {
        const ulonglong2 p = *reinterpret_cast<const ulonglong2*>(v + i);
        x[j] = p.x;
        x[j + 1] = p.y;
      } else {
        if (i < r) x[j] = v[i];
        if (i + 1 < r) x[j + 1] = v[i + 1];
      }
    }
    if (j0 == 0) d0 = x[1] - x[0];  // R >= 2
#pragma unroll
    for (int j = 0; j < kFitChunk; ++j) {
      const int i = j0 + j;
      if (i >= 1 && i < r) {
        const uint64_t d = x[j] - (j ? x[j - 1] : prev);
        zero &= d == 0;
        same &= d == d0;
      }
    }
    prev = x[kFitChunk - 1];
  }
  packed[row] = (int64_t)d0;
  reinterpret_cast<int32_t*>(packed + c)[row] = fit_flag(zero, same, d0);
}

__global__ void __launch_bounds__(kThreads)
    fit_columns_tiles(const uint64_t* __restrict__ V,
                      int64_t* __restrict__ packed,
                      int32_t* __restrict__ scratch, int64_t c, int64_t r,
                      int64_t ld, int64_t span, int64_t nspans) {
  const int lane = threadIdx.x & 31;
  const int64_t task = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= c * nspans) return;  // whole warps
  const int64_t row = nspans == 1 ? task : task / nspans;
  const int64_t s = task - row * nspans;
  const int64_t s0 = s * span, s1 = s0 + span < r ? s0 + span : r;
  const uint64_t* v = V + row * ld;
  const uint64_t d0 = v[1] - v[0];
  uint64_t carry = s0 > 0 ? v[s0 - 1] : 0;
  // spans start at multiples of kFitQuantum, so a lane's pair starts at an
  // even index: aligned wherever the row is
  const bool vec = ((uintptr_t)v & 15) == 0;
  bool zero = true, same = true;
  for (int64_t base = s0; base < s1; base += kFitQuantum) {
    uint64_t lo[kFitUnroll], hi[kFitUnroll];
#pragma unroll
    for (int u = 0; u < kFitUnroll; ++u) {
      const int64_t b = base + u * kFitStep;
      lo[u] = hi[u] = 0;
      if (vec) {
        const int64_t a = b + 2 * lane;
        if (a + 1 < s1) {
          const ulonglong2 p = *reinterpret_cast<const ulonglong2*>(v + a);
          lo[u] = p.x;
          hi[u] = p.y;
        } else if (a < s1) {
          lo[u] = v[a];
        }
      } else {
        if (b + lane < s1) lo[u] = v[b + lane];
        if (b + 32 + lane < s1) hi[u] = v[b + 32 + lane];
      }
    }
#pragma unroll
    for (int u = 0; u < kFitUnroll; ++u) {
      const int64_t b = base + u * kFitStep;
      if (b >= s1) break;  // the same for every lane
      uint64_t d[2];
      bool ok[2];
      if (vec) {
        // lane l holds v[a], v[a + 1] with a = b + 2 l
        const int64_t a = b + 2 * lane;
        uint64_t prev = __shfl_up_sync(kFull, hi[u], 1);
        if (lane == 0) prev = carry;
        d[0] = lo[u] - prev;
        ok[0] = a < s1 && a >= 1;
        d[1] = hi[u] - lo[u];
        ok[1] = a + 1 < s1;
      } else {
        // lane l holds v[b + l] and v[b + 32 + l]
        uint64_t p0 = __shfl_up_sync(kFull, lo[u], 1);
        uint64_t p1 = __shfl_up_sync(kFull, hi[u], 1);
        const uint64_t last0 = __shfl_sync(kFull, lo[u], 31);
        if (lane == 0) {
          p0 = carry;
          p1 = last0;
        }
        d[0] = lo[u] - p0;
        ok[0] = b + lane < s1 && b + lane >= 1;
        d[1] = hi[u] - p1;
        ok[1] = b + 32 + lane < s1;
      }
      // the step's last value: lane 31's, valid wherever a next step is
      carry = __shfl_sync(kFull, hi[u], 31);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (ok[k]) {
          zero &= d[k] == 0;
          same &= d[k] == d0;
        }
      }
    }
  }
  zero = __all_sync(kFull, zero);
  same = __all_sync(kFull, same);
  if (lane != 0) return;
  int32_t* flags = reinterpret_cast<int32_t*>(packed + c);
  if (nspans == 1) {
    packed[row] = (int64_t)d0;
    flags[row] = fit_flag(zero, same, d0);
    return;
  }
  if (s == 0) packed[row] = (int64_t)d0;  // the span that holds rank 1
  int32_t* word = scratch + row;
  int32_t* done = scratch + c + row;
  const int bits = (zero ? 0 : 1) | (same ? 0 : 2);
  if (bits) atomicOr(word, bits);
  __threadfence();
  if (atomicAdd(done, 1) == nspans - 1) {
    __threadfence();
    const int w = atomicOr(word, 0);
    flags[row] = fit_flag(!(w & 1), !(w & 2), d0);
    *word = 0;  // every span of the row is done: leave the scratch zeroed
    *done = 0;
  }
}

// The SM count of the current device, read once (a host's cards are one
// model; ranks on threads may race to read it, and store the same count).
// A failed query returns its error.
cudaError_t sm_count(int* out) {
  static std::atomic<int> sms_read{0};
  int sms = sms_read.load(std::memory_order_relaxed);
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    sms_read.store(sms, std::memory_order_relaxed);
  }
  *out = sms;
  return cudaSuccess;
}

// Blocks for a grid-stride kernel: enough for n4 groups, at most four an
// SM.
cudaError_t grid_blocks(int64_t n4, unsigned* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  *blocks = (unsigned)(want < 4 * sms ? want : 4 * sms);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int delta_zigzag(const void* x, void* out, int64_t n, int64_t segment,
                 void* stream) {
  const int vec = aligned16(x) && aligned16(out);
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks((n + 3) / 4, &blocks);
  if (err != cudaSuccess) return (int)err;
  delta_zigzag_kernel<<<blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, segment, vec);
  return (int)cudaGetLastError();
}

int delta_zigzag_varint(const void* x, void* zz, void* lens, void* planes,
                        int64_t n, void* stream) {
  delta_zigzag_varint_kernel<<<blocks_for(n), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)zz, (int32_t*)lens, (uint8_t*)planes, n);
  return (int)cudaGetLastError();
}

int uvarint_encode64(const void* v, void* lens, void* planes, int64_t n,
                     void* stream) {
  uvarint_encode64_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint64_t*)v, (int32_t*)lens, (uint8_t*)planes, n);
  return (int)cudaGetLastError();
}

// status: n_status >= 2 + ceil(n / kPackTile) zeroed u64 (see
// uvarint_pack64_kernel); the total length lands in status[1]
int uvarint_pack64(const void* v, void* out, void* status, int64_t n_status,
                   int64_t n, void* stream) {
  const int64_t tiles = (n + kPackTile - 1) / kPackTile;
  if (n_status < 2 + tiles) return (int)cudaErrorInvalidValue;
  uvarint_pack64_kernel<<<(unsigned)tiles, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint64_t*)v, (uint8_t*)out, (unsigned long long*)status, n,
      aligned16(v));
  return (int)cudaGetLastError();
}

// How fit_columns splits (C, R) on this device: plan[0] the route (0
// rows, 1 tiles), plan[1] the ranks a rows thread loads at a time or a
// tiles warp's span, plan[2] the spans a row (1 on the rows route).
int fit_columns_plan(int64_t c, int64_t r, void* plan) {
  int64_t* out = (int64_t*)plan;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (r <= kFitRowsMax && c >= (int64_t)kFitRowsMinWarps * 32 * sms) {
    out[0] = 0;
    out[1] = r < kFitChunk ? r : kFitChunk;
    out[2] = 1;
    return 0;
  }
  // spans of whole quanta, as many as give about 32 warps an SM
  const int64_t per_warp = (c * r + 32 * (int64_t)sms - 1) / (32 * sms);
  out[0] = 1;
  out[1] = ((per_warp + kFitQuantum - 1) / kFitQuantum) * kFitQuantum;
  out[2] = (r + out[1] - 1) / out[1];
  return 0;
}

// packed: c + ceil(c / 2) int64 words (see above); scratch: 2 c int32,
// zero on entry and on return; ld: V's row stride in values.
int fit_columns(const void* V, void* packed, void* scratch, int64_t c,
                int64_t r, int64_t ld, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int64_t plan[3];
  const int err = fit_columns_plan(c, r, plan);
  if (err != 0) return err;
  const uint64_t* v = (const uint64_t*)V;
  int64_t* out = (int64_t*)packed;
  if (plan[0] == 0) {
    fit_columns_rows<<<(unsigned)((c + kFitRowsThreads - 1) /
                                  kFitRowsThreads),
                       kFitRowsThreads, 0, st>>>(v, out, c, (int)r, ld);
    return (int)cudaGetLastError();
  }
  const int64_t warps = c * plan[2], per_block = kThreads / 32;
  fit_columns_tiles<<<(unsigned)((warps + per_block - 1) / per_block),
                      kThreads, 0, st>>>(v, out, (int32_t*)scratch, c, r,
                                         ld, plan[1], plan[2]);
  return (int)cudaGetLastError();
}

}  // extern "C"
