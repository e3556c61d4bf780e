// Packed-ternary weight matmuls for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/build.py).
//
// Replaces the two Pallas TPU kernels of the reference:
//   src/repro/kernels/ternary_matmul.py  _kernel       (ternary_matmul)
//   src/repro/kernels/ternary_matmul.py  _kernel_int8  (ternary_matmul_int8)
//
//   float: y[m,n] = (sum_k x[m,k] * decode(w)[k,n]) * scale[n]
//          x f32 or bf16, f32 accumulation, scale applied once after K.
//   int8:  y[m,n] = ((float)(sum_k x[m,k] * decode(w)[k,n]) * xs[m]) * scale[n]
//          exact int32 accumulation, epilogue with __fmul_rn in that order.
//   int32: acc[m,n] = sum_k x[m,k] * decode(w)[k,n], int8 x, the int8
//          routes' exact sums written as they are (no scales): the
//          product term of cim_mac's code route (csrc/cim_mac.cu).
//
// decode: base3 stores one weight per byte as v + 121 (v in [-121, 121]);
// trit2 stores four trits per byte as 2-bit codes, little-endian along K
// (0 -> 0, 1 -> +1, 2 -> -1, 3 -> 0).
//
// Three routes; the wrapper (kernels/ternary_matmul.py, route()) picks
// one from M and the dtype of x, and no route falls back to another.
//
// gemv (M <= 8 with bf16 or int8 x, decode; tm_gemv_kernel): bound by
// the packed weight bytes, each read once per call at 3.35 TB/s; most
// calls of a decode step move 2-17 MB, a few microseconds of bytes, so
// a kernel's fixed cost (launch, first DRAM latency, a second kernel)
// weighs as much as its rate.  The design, in the order of what it
// fixes:
//   * The multiply-adds go to the tensor cores with A and B swapped:
//     the decoded weight, transposed, is mma.sync's A operand (16
//     output columns x k16 bf16 or k32 int8) and x's 8 rows its B
//     operand (n8).  The CUDA cores only decode.  A lane decodes a
//     32-bit word of 4 neighbouring columns from each of the 4 K rows
//     its fragment needs (base3: 4 words; trit2: 1 word, whose bytes
//     hold exactly those 4 rows), so the column order inside a
//     32-column group is permuted (column 4g + c is row g or g + 8 of
//     m16 tile c / 2) and, for bf16, so is K inside each k16 step
//     (lane quad q takes rows 4q .. 4q + 3, which x's B fragment follows
//     with one 8-byte load).  Decodes as the mma route's: base3 bytes to
//     bf16 without I2F, trit2 codes to bf16 pairs with one fma,
//     __byte_perm 4 x 4 transposes for int8.
//   * The weights stream through a ring of stages (about 32 KB a block:
//     3 of 64 raw packed rows x 128 columns up to 8 of 64 x 32), each
//     filled by two TMA boxes on one mbarrier: the raw tile from a 2-D
//     tensor map with the hardware's swizzle of its width (32, 64 or
//     128 bytes), and x's 8 x kKS slice.  What lies past M, K or N
//     arrives as 0 (a zero base3 byte decodes to -121, but meets a zero
//     x).  One thread issues a stage.  Per-thread 16-byte cp.async, and
//     a TMA copy per row, were measured slower on the H100: the first
//     stalls the load/store pipe that the decode's shared loads share,
//     the second is too small for the TMA.  The small ring leaves room
//     for 6 blocks an SM, so the unembedding's 724 blocks run in one
//     wave.  Rows not 16-byte aligned are staged by the threads, byte
//     by byte, into the same layout.
//   * K is split without partials in HBM or a second kernel: the splits
//     of one column tile are one thread-block cluster (grid.z = the
//     cluster size, 1-8).  Each block adds its warps' sums in warp order
//     and writes row r's into the inbox of rank r % c through
//     distributed shared memory; after one cluster barrier each rank
//     adds its inbox in rank order (float deterministic, int8 exact),
//     applies the epilogue and writes whole rows.  A block announces
//     itself at its start and waits for the others only before its
//     first remote write, so no barrier is needed before it exits.
//   * gemv_plan (the wrapper) picks the column tile (128, 64 or 32:
//     wider means longer row segments, 128 bytes being whole lines;
//     narrower means more blocks) and the smallest cluster that puts a
//     block on every SM: the widest tile that does so wins.
//
// mma (M > 8 with bf16 or int8 x, prefill; tm_mma_kernel): bound by the
// multiply-adds at the tensor-core rate (989 TFLOP/s bf16, 1979 TOP/s
// int8).  One template serves both domains; only the mma instruction
// (m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32) and the epilogue differ.
// A block owns 128 or 256 rows x 128 columns of the output: 8 warps
// (2 x 4) or 16 warps (4 x 4) of 64 x 32 outputs each (the wrapper's
// mma_plan: 256 rows for M > 128, else 128 with the rows past M masked).
// cp.async stages x's K slice into a ring of 3 stages and the raw packed
// weight tile (64 K rows: 64 x 128 bytes of base3, 16 x 128 of trit2)
// into 2; a decode pass turns each raw tile into the mma's element type
// in one N x K layout (K contiguous), double-buffered, so that one
// barrier a stage suffices: iteration t issues the loads of stage t + 2,
// multiplies stage t, and between its k steps decodes stage t + 1.  int8
// transposes 4 K rows x 4 columns with __byte_perm; bf16 picks each
// base3 byte out of its raw word while converting it exactly (no I2F),
// and turns trit2 codes into bf16 pairs with one fma.  A (x, row-major)
// and B are then both read with plain ldmatrix: the "TN" layout, the one
// that serves both types (ldmatrix.trans has no 8-bit form).  x and B
// rows are padded by 16 bytes and the raw tile's 16-byte chunks are
// swizzled, against bank conflicts.  The outputs leave through a shared
// patch per warp as whole 128-byte rows.  What holds this mma.sync form
// short of the tensor-core peak, by ablation on the H100: the mma.sync
// issue itself (well below the peak even with no staging or decode),
// then the staging, the decode and the ldmatrix traffic, which overlap
// it only in part; wgmma with TMA staging is the next pass.
// Every weight is exact in bf16 (|v| <= 121) and a bf16 x bf16 product
// is exact in f32, so the float domain differs from f32 only in the
// order of the sums; int8 sums are exact.  Rows past M or K, columns
// past N and rows past the split are staged as 0 (a zero base3 byte
// decodes to -121, but meets a zero x), so ragged edges need no padded
// copy; rows not 16-byte aligned are staged byte by byte.
//
// cuda_core (f32 x, any M; tm_gemv_float_kernel for M <= 8,
// tm_float_kernel above): f32 activations are off the serving path, and
// rounding them to bf16 for the tensor cores would break the float
// domain's f32 bar, so they keep these CUDA-core kernels.  At M > 8 a
// block of 128 threads owns 8 rows x 128 columns, a thread 4 adjacent
// columns read as one 32-bit load, activations staged 8 x 64 at a time,
// four K slices combined in shared memory in a fixed order.  At M <= 8
// a block of 8 warps owns 128 columns, the warps take interleaved K rows
// and each lane issues 8 row loads before it computes.
//
// Where the output tiles alone would leave the SMs idle, the mma and
// cuda_core routes split K across blocks (grid.z); each split writes its
// partial sums and a second kernel adds them in split order and applies
// the epilogue, so the result is deterministic (no atomics).  The gemv
// route reduces its splits inside a cluster instead (above).
// Later work: wgmma with TMA staging and warp specialisation for the mma
// route (PERF.md has each route's times).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColGroups = 32;
constexpr int kBN = kColGroups * kColsPerThread;   // 128 output columns
constexpr int kSlices = kThreads / kColGroups;     // 4 K slices per chunk
constexpr int kBM = 8;                             // rows per block tile
constexpr int kKC = 64;                            // K per staged chunk
constexpr int kRowsPerSlice = kKC / kSlices;       // 16
constexpr int kBase3Offset = 121;
constexpr int kBase3 = 0;
constexpr uint32_t kBase3Zero = 0x79797979u;       // four bytes of 121

// Four packed bytes of columns n0..n0+3 of one packed row; columns past N
// read as 0 (never written out).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int n0, int N, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + n0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c)
    if (n0 + c < N) v |= static_cast<uint32_t>(__ldg(row + n0 + c)) << (8 * c);
  return v;
}

__device__ __forceinline__ int base3_value(uint32_t b, int c) {
  return static_cast<int>((b >> (8 * c)) & 0xffu) - kBase3Offset;
}

__device__ __forceinline__ int trit_value(uint32_t b, int c, int j) {
  const uint32_t code = (b >> (8 * c + 2 * j)) & 0x3u;
  return static_cast<int>(code & 1u) - static_cast<int>(code >> 1);
}

// Accumulates the block's K range [kb0, kb1) into acc.
template <int MODE>
__device__ __forceinline__ void accumulate(
    const float* __restrict__ x, const uint8_t* __restrict__ w,
    float (&xs)[kBM][kKC], float (&acc)[kBM][kColsPerThread], int M, int K,
    int N, int m0, int n0, int kb0, int kb1, int slice, int vec) {
  using T = float;
  const int t = threadIdx.x;
  for (int kc = kb0; kc < kb1; kc += kKC) {
    __syncthreads();
    for (int i = t; i < kBM * kKC; i += kThreads) {
      const int mm = i / kKC, kk = i % kKC;
      const int gm = m0 + mm, gk = kc + kk;
      xs[mm][kk] = (gm < M && gk < kb1) ? x[static_cast<size_t>(gm) * K + gk]
                                         : 0.f;
    }
    __syncthreads();
    if (n0 >= N) continue;
    if (MODE == kBase3) {
#pragma unroll 4
      for (int r = 0; r < kRowsPerSlice; ++r) {
        const int kk = slice * kRowsPerSlice + r;
        if (kc + kk >= kb1) break;
        const uint32_t b = load4(w + static_cast<size_t>(kc + kk) * N, n0, N, vec);
        T wv[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) wv[c] = T(base3_value(b, c));
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          const T xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) acc[m][c] += xv * wv[c];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerSlice / 4; ++r) {
        const int kk = slice * kRowsPerSlice + 4 * r;
        if (kc + kk >= kb1) break;
        const uint32_t b =
            load4(w + static_cast<size_t>((kc + kk) / 4) * N, n0, N, vec);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T wv[kColsPerThread];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) wv[c] = T(trit_value(b, c, j));
#pragma unroll
          for (int m = 0; m < kBM; ++m) {
            const T xv = xs[m][kk + j];
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c) acc[m][c] += xv * wv[c];
          }
        }
      }
    }
  }
}

// Combines the four K slices of the block in slice order; returns via red.
__device__ __forceinline__ void stash(float (&red)[kSlices][kBM][kBN],
                                      const float (&acc)[kBM][kColsPerThread],
                                      int slice, int col) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      red[slice][m][col * kColsPerThread + c] = acc[m][c];
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tm_float_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int K, int N, int k_per_split, int vec, int partial) {
  __shared__ float xs[kBM][kKC];
  __shared__ float red[kSlices][kBM][kBN];
  const int col = threadIdx.x % kColGroups, slice = threadIdx.x / kColGroups;
  const int n0 = blockIdx.x * kBN + col * kColsPerThread;
  const int m0 = blockIdx.y * kBM;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  float acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;
  accumulate<MODE>(x, w, xs, acc, M, K, N, m0, n0, kb0, kb1, slice, vec);
  stash(red, acc, slice, col);
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int mm = i / kBN, nn = i % kBN;
    const int gm = m0 + mm, gn = blockIdx.x * kBN + nn;
    if (gm >= M || gn >= N) continue;
    float s = red[0][mm][nn];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) s += red[q][mm][nn];
    if (partial)
      out[(static_cast<size_t>(blockIdx.z) * M + gm) * N + gn] = s;
    else
      out[static_cast<size_t>(gm) * N + gn] = s * scale[gn];
  }
}

// ------------------------------------------------------- prefill (mma)

constexpr int kMBN = 128;               // output columns per block
constexpr int kMBK = 64;                // K rows per stage (the split unit)
constexpr int kAhead = 2;               // stages loaded ahead of the mma
constexpr int kXStages = kAhead + 1;    // x ring (one stage in the mma)
constexpr int kPad = 16;                // bytes after each shared row
constexpr int kRawRow = kMBN;           // one raw packed row, 128 bytes
constexpr int kMaxSmem = 227 * 1024;    // opt-in shared memory per block
constexpr int kPatchRow = 40;           // words per epilogue patch row

template <typename T> struct AccOf { using type = int; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without waiting; valid = false writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One 16 x 8 output tile += A (16 rows x 32 bytes) . B (32 bytes x 8
// columns): bf16 k16 with f32 sums, or int8 k32 with exact int32 sums.
__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Decodes without int-to-float conversions or emulated SIMD: base3
// bytes minus 121 as int8 (a carry-free byte add of 135); a trit2 byte's
// four 2-bit codes as four int8; trit2 words as bf16 pairs (below).
__device__ __forceinline__ uint32_t base3_s8(uint32_t b) {
  return ((b & 0x7f7f7f7fu) + 0x07070707u) ^ ((b ^ 0x87878787u) & 0x80808080u);
}
__device__ __forceinline__ uint32_t trit2_s8(uint32_t b) {
  const uint32_t c = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  const uint32_t lo = c & 0x01010101u, hi = (c >> 1) & 0x01010101u;
  const uint32_t nz = lo ^ hi;
  return nz | ((hi & nz) * 0xfeu);
}
// Every 2-bit code of w as its value + 1 (0 -> 1, 1 -> 2, 2 -> 0, 3 -> 1).
__device__ __forceinline__ uint32_t trit2_fields_plus_one(uint32_t w) {
  const uint32_t lo = w & 0x55555555u, hi = (w >> 1) & 0x55555555u;
  return ((lo & ~hi) << 1) | (~(lo ^ hi) & 0x55555555u);
}
// Two fields f in 0..2 at bits 0 and 16 -> the bf16 pair (f - 1): 128 + f
// is 0x4300 | f in bf16, and (128 + f) * 1 - 129 is exact.
__device__ __forceinline__ uint32_t bf16x2_minus_one(uint32_t f) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(f | 0x43004300u), "r"(0x3f803f80u), "r"(0xc301c301u));
  return d;
}

// The f32 of byte `sel` of w minus `off`: the byte is placed as the low
// bits of 2^23's f32 pattern and 2^23 + off is subtracted, which is exact.
// Every value here has at most 7 significant bits (|v| <= 121), so its
// bf16 is the upper half of that f32.
__device__ __forceinline__ uint32_t byte_f32(uint32_t w, int sel, float off) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B00u, 0x5440 + sel)) - off);
}
__device__ __forceinline__ void put_bf16x4(__nv_bfloat16* dst, uint32_t f0,
                                           uint32_t f1, uint32_t f2,
                                           uint32_t f3) {
  uint2 v;
  v.x = __byte_perm(f0, f1, 0x7632);
  v.y = __byte_perm(f2, f3, 0x7632);
  *reinterpret_cast<uint2*>(dst) = v;
}

__device__ __forceinline__ float finish(float acc, const float*, int,
                                        float sc) {
  return acc * sc;
}
__device__ __forceinline__ float finish(int acc, const float* xscale, int m,
                                        float sc) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xscale[m]), sc);
}

// Four outputs of row gm, columns gn .. gn + 3 (those below N), from a
// shared patch: finished (plane < 0), or the raw sums into row gm of
// plane `plane` of an (planes, M, N) array of Acc (a split's partial
// rows, or plane 0: the int32 output of cim_mac's code route).
template <typename Acc>
__device__ __forceinline__ void put_outputs(const Acc* patch,
                                            const float* xscale,
                                            const float* scale, void* out,
                                            int M, int N, int gm, int gn,
                                            int plane, bool vec4) {
  const bool whole = vec4 && gn + 3 < N;
  alignas(16) Acc v[4];
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(patch);
  if (plane >= 0) {
    Acc* o = static_cast<Acc*>(out)
             + (static_cast<size_t>(plane) * M + gm) * N + gn;
    if (whole) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 4 && gn + e < N; ++e) o[e] = v[e];
    }
    return;
  }
  float* o = static_cast<float*>(out) + static_cast<size_t>(gm) * N + gn;
  if (whole) {
    const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
    *reinterpret_cast<float4*>(o) =
        make_float4(finish(v[0], xscale, gm, sc.x),
                    finish(v[1], xscale, gm, sc.y),
                    finish(v[2], xscale, gm, sc.z),
                    finish(v[3], xscale, gm, sc.w));
  } else {
    for (int e = 0; e < 4 && gn + e < N; ++e)
      o[e] = finish(v[e], xscale, gm, scale[gn + e]);
  }
}

template <int MODE, typename T, int BM>
struct MmaShape {
  // warps: 2 (BM = 128) or 4 (BM = 256) along M times 4 along N; a warp
  // owns 64 x 32 outputs
  static constexpr int kWarpsM = BM / 64;
  static constexpr int kThreads = kWarpsM * 4 * 32;
  static constexpr int kMI = BM / kWarpsM / 16;          // m16 tiles per warp
  static constexpr int kGroups = 16 / (kThreads / 32);   // decode groups
                                                         // per warp
  static constexpr int kRow = kMBK * sizeof(T) + kPad;   // x and B rows
  static constexpr int kX = BM * kRow;                   // one x stage
  static constexpr int kRawRows = MODE == kBase3 ? kMBK : kMBK / 4;
  static constexpr int kW = kRawRows * kRawRow;          // one raw w stage
  // raw row r keeps its 16-byte chunk c at c ^ swizzle(r), so that the
  // decode's reads (4 K rows apart for base3) spread over the banks
  static __device__ __forceinline__ int swizzle(int r) {
    return (MODE == kBase3 ? r / 4 : r) % 8;
  }
  static constexpr int kB = kMBN * kRow;                 // one B tile
  // x ring of kXStages, raw weight ring of kAhead, B double-buffered
  static constexpr int kSmem = kXStages * kX + kAhead * kW + 2 * kB;
  static_assert(kSmem <= kMaxSmem, "shared tiles exceed a block's limit");
};

// Stages K rows [k0, k0 + kMBK) of x and of the raw packed weight; what
// lies past M, N or the split's end kb1 is written as 0.
template <int MODE, typename T, int BM>
__device__ __forceinline__ void mma_load(
    const T* __restrict__ x, const uint8_t* __restrict__ w, uint8_t* xd,
    uint8_t* wd, int M, int K, int N, int m0, int n0, int k0, int kb1,
    int vec) {
  using S = MmaShape<MODE, T, BM>;
  constexpr int kE = 16 / sizeof(T);             // x elements per 16 bytes
  constexpr int kXc = kMBK / kE;                 // 16-byte chunks per x row
  for (int i = threadIdx.x; i < BM * kXc; i += S::kThreads) {
    const int r = i / kXc, c = i % kXc;
    const int gm = m0 + r, gk = k0 + c * kE;
    uint8_t* d = xd + r * S::kRow + c * 16;
    const T* src = x + static_cast<size_t>(gm) * K + gk;
    if (vec) {
      const bool ok = gm < M && gk < kb1;
      cp_async16(d, ok ? src : x, ok);
    } else {
      for (int j = 0; j < 16; ++j) {
        const int e = j / static_cast<int>(sizeof(T));
        d[j] = (gm < M && gk + e < kb1)
                   ? reinterpret_cast<const uint8_t*>(src)[j] : 0;
      }
    }
  }
  const int p0 = MODE == kBase3 ? k0 : k0 / 4;   // packed rows
  const int pend = MODE == kBase3 ? kb1 : kb1 / 4;
  constexpr int kWc = kMBN / 16;
  for (int i = threadIdx.x; i < S::kRawRows * kWc; i += S::kThreads) {
    const int r = i / kWc, c = i % kWc;
    const int gp = p0 + r, gn = n0 + c * 16;
    uint8_t* d = wd + r * kRawRow + (c ^ S::swizzle(r)) * 16;
    const uint8_t* src = w + static_cast<size_t>(gp) * N + gn;
    if (vec) {
      const bool ok = gp < pend && gn < N;
      cp_async16(d, ok ? src : w, ok);
    } else {
      for (int j = 0; j < 16; ++j)
        d[j] = (gp < pend && gn + j < N) ? src[j] : 0;
    }
  }
}

// Raw packed stage -> B tile [kMBN][kMBK] (K contiguous) in T, one of
// its 16 groups of 32 tasks: a thread turns 4 K rows x 4 columns, a warp
// covers 8 row quads x 4 column quads, so that with the raw tile's
// swizzle its raw reads take one pass of the banks and its B writes two
// (the fewest for 8-byte stores).  base3: int8 transposes the bytes with
// __byte_perm, bf16 picks each byte straight out of its raw word while
// it converts.  trit2: int8 spreads each byte's codes; bf16 turns the
// word's 16 codes into value + 1 at once, then each column's pairs with
// one fma each.
template <int MODE, typename T, int BM>
__device__ __forceinline__ void mma_decode(const uint8_t* wr, uint8_t* bs,
                                           int g) {
  using S = MmaShape<MODE, T, BM>;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int lane = threadIdx.x % 32;
  {
    const int rq = 8 * (g / 8) + lane / 4;       // K rows 4rq .. 4rq + 3
    const int cq = 4 * (g % 8) + lane % 4;       // columns 4cq .. 4cq + 3
    // byte of columns 4cq .. in raw row r
    auto raw = [&](int r) {
      return wr + r * kRawRow + ((cq / 4) ^ S::swizzle(r)) * 16 + 4 * (cq % 4);
    };
    T* col = reinterpret_cast<T*>(bs + 4 * cq * S::kRow) + 4 * rq;
    if (MODE == kBase3) {
      uint32_t r[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        r[t] = *reinterpret_cast<const uint32_t*>(raw(4 * rq + t));
      if constexpr (kInt8) {
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t u1 = __byte_perm(r[2], r[3], 0x7362);
        const uint32_t c4[4] = {__byte_perm(t0, u0, 0x5410),
                                __byte_perm(t0, u0, 0x7632),
                                __byte_perm(t1, u1, 0x5410),
                                __byte_perm(t1, u1, 0x7632)};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint32_t*>(col + c * S::kRow) = base3_s8(c4[c]);
      } else {
        constexpr float kOff = 8388608.0f + kBase3Offset;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          put_bf16x4(reinterpret_cast<__nv_bfloat16*>(
                         reinterpret_cast<uint8_t*>(col) + c * S::kRow),
                     byte_f32(r[0], c, kOff), byte_f32(r[1], c, kOff),
                     byte_f32(r[2], c, kOff), byte_f32(r[3], c, kOff));
      }
    } else {
      // one packed row holds K rows 4rq .. 4rq + 3
      const uint32_t b = *reinterpret_cast<const uint32_t*>(raw(rq));
      if constexpr (kInt8) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(col)
                                       + c * S::kRow) =
              trit2_s8((b >> (8 * c)) & 0xffu);
      } else {
        // fields of K rows 0 and 2 (even) and 1 and 3 (odd) of each
        // column, a byte per column; column c's pairs (0, 1) and (2, 3)
        // are its even and odd bytes side by side
        const uint32_t f = trit2_fields_plus_one(b);
        const uint32_t even = f & 0x33333333u, odd = (f >> 2) & 0x33333333u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t p = __byte_perm(even, odd, c | ((4 + c) << 8));
          uint2 v;
          v.x = bf16x2_minus_one(p & 0x00030003u);
          v.y = bf16x2_minus_one((p >> 4) & 0x00030003u);
          *reinterpret_cast<uint2*>(reinterpret_cast<uint8_t*>(col)
                                    + c * S::kRow) = v;
        }
      }
    }
  }
}

template <int MODE, typename T, int BM>
__global__ void __launch_bounds__(MmaShape<MODE, T, BM>::kThreads)
tm_mma_kernel(const T* __restrict__ x, const float* __restrict__ xscale,
              const uint8_t* __restrict__ w, const float* __restrict__ scale,
              void* __restrict__ out, int M, int K, int N, int k_per_split,
              int vec, int partial) {
  using S = MmaShape<MODE, T, BM>;
  using Acc = typename AccOf<T>::type;
  constexpr int MI = S::kMI;
  constexpr int kSteps = kMBK * sizeof(T) / 32;  // 32-byte mma steps
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;                            // [kXStages][BM][kRow]
  uint8_t* ws = xs + kXStages * S::kX;           // [kAhead][raw rows][128]
  uint8_t* bs = ws + kAhead * S::kW;             // [2][kMBN][kRow]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kMBN;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  const int tiles = (kb1 - kb0 + kMBK - 1) / kMBK;
  const int wm0 = (warp / 4) * (BM / S::kWarpsM), wn0 = (warp % 4) * 32;

  Acc acc[MI][4][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = Acc(0);

  // Stage t: x in slot t % kXStages, raw weight in t % kAhead, decoded
  // B in t % 2.  Iteration t issues the loads of stage t + kAhead,
  // multiplies stage t and decodes stage t + 1, behind one barrier, so
  // kAhead - 1 stages stay in flight while it works.
  auto load = [&](int t) {
    if (t < tiles)
      mma_load<MODE, T, BM>(x, w, xs + (t % kXStages) * S::kX,
                            ws + (t % kAhead) * S::kW, M, K, N, m0, n0,
                            kb0 + t * kMBK, kb1, vec);
    cp_async_commit();
  };
  constexpr int kWarps = S::kThreads / 32;
  static_assert(S::kGroups <= kSteps, "a decode group per k step at most");
#pragma unroll
  for (int t = 0; t < kAhead; ++t) load(t);
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  if (tiles > 0)
#pragma unroll
    for (int j = 0; j < S::kGroups; ++j)
      mma_decode<MODE, T, BM>(ws, bs, warp + j * kWarps);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kAhead - 2>();
    __syncthreads();    // stage t + 1 landed, B[t % 2] written, and
                        // iteration t - 1's reads are done
    load(t + kAhead);
    const uint8_t* xa = xs + (t % kXStages) * S::kX;
    const uint8_t* ba = bs + (t % 2) * S::kB;
    const bool next = t + 1 < tiles;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[mi], xa + (wm0 + mi * 16 + lane % 16) * S::kRow + s * 32
                           + (lane / 16) * 16);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4(r, ba + (wn0 + nj * 16 + lane % 8 + (lane / 16) * 8) * S::kRow
                       + s * 32 + ((lane / 8) % 2) * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_tile(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      // this warp's decode groups of stage t + 1 follow the k steps of
      // stage t, so their ALU work issues while the mma pipe is busy
      if (next && s < S::kGroups)
        mma_decode<MODE, T, BM>(ws + ((t + 1) % kAhead) * S::kW,
                                bs + ((t + 1) % 2) * S::kB, warp + s * kWarps);
    }
  }

  // Epilogue: each warp passes its outputs through a private patch of
  // 16 x 32 in shared memory (the x ring is free now), one m16 tile at a
  // time, so that each row of 32 outputs leaves as 128 contiguous bytes.
  cp_async_wait<0>();
  __syncthreads();
  static_assert(kWarps * 16 * kPatchRow * 4 <= kXStages * S::kX,
                "the epilogue's patches fit in the x ring");
  Acc* patch = reinterpret_cast<Acc*>(xs) + warp * 16 * kPatchRow;
  const int g = lane / 4, t4 = lane % 4;
  const bool vec4 = N % 4 == 0
      && ((reinterpret_cast<uintptr_t>(out)
           | reinterpret_cast<uintptr_t>(scale)) & 15u) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc* p = patch + (g + 8 * h) * kPatchRow + ni * 8 + 2 * t4;
        p[0] = acc[mi][ni][2 * h];
        p[1] = acc[mi][ni][2 * h + 1];
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = 4 * it + lane / 8, c = 4 * (lane % 8);
      const int gm = m0 + wm0 + mi * 16 + r, gn = n0 + wn0 + c;
      if (gm < M && gn < N)
        put_outputs(patch + r * kPatchRow + c, xscale, scale, out, M, N, gm,
                    gn, partial ? static_cast<int>(blockIdx.z) : -1, vec4);
    }
    __syncwarp();
  }
}

// ------------------------------------------------- decode, f32 (cuda_core)

constexpr int kGWarps = 8;
constexpr int kGThreads = kGWarps * 32;
constexpr int kGCols = 32 * kColsPerThread;        // 128 output columns
constexpr int kGChunk = 256;                       // K rows staged at once
constexpr int kGUnroll = 8;                        // row loads in flight

__device__ __forceinline__ void rows8(const float* p, float (&v)[kBM]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[m][c] += x[m][k] * decode(b)[c] for the 8 rows of staged k row kk
// (trit2: field j of each byte).
template <int MODE>
__device__ __forceinline__ void gemv_row(const float (&xs)[kGChunk][kBM],
                                         int kk, uint32_t b, int j,
                                         float (&acc)[kBM][kColsPerThread]) {
  float xv[kBM];
  rows8(&xs[kk][0], xv);
  float wv[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c)
    wv[c] = float(MODE == kBase3 ? base3_value(b, c) : trit_value(b, c, j));
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] += xv[m] * wv[c];
}

template <int MODE>
__device__ __forceinline__ void gemv_accumulate(
    const float* __restrict__ x, const uint8_t* __restrict__ w,
    float (&xs)[kGChunk][kBM], float (&acc)[kBM][kColsPerThread], int M,
    int K, int N, int n0, int kb0, int kb1, int vec) {
  const int warp = threadIdx.x / 32;
  for (int kc = kb0; kc < kb1; kc += kGChunk) {
    const int kn = min(kGChunk, kb1 - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < kn * kBM; i += kGThreads) {
      const int mm = i / kn, kk = i % kn;             // coalesced along K
      xs[kk][mm] = mm < M ? x[static_cast<size_t>(mm) * K + kc + kk] : 0.f;
    }
    __syncthreads();
    if (n0 >= N) continue;
    if (MODE == kBase3) {
      for (int r0 = warp; r0 < kn; r0 += kGWarps * kGUnroll) {
        uint32_t b[kGUnroll];
#pragma unroll
        for (int u = 0; u < kGUnroll; ++u) {
          const int kk = r0 + u * kGWarps;
          b[u] = kk < kn ? load4(w + static_cast<size_t>(kc + kk) * N, n0, N, vec)
                         : kBase3Zero;
        }
#pragma unroll
        for (int u = 0; u < kGUnroll; ++u) {
          const int kk = r0 + u * kGWarps;
          if (kk < kn) gemv_row<MODE>(xs, kk, b[u], 0, acc);
        }
      }
    } else {
      // one packed row holds 4 consecutive K rows; kc and kn are
      // multiples of 4 (the wrapper checks K, the split is 64-aligned)
      const int pn = kn / 4, p0 = kc / 4;
      for (int r0 = warp; r0 < pn; r0 += kGWarps * kGUnroll) {
        uint32_t b[kGUnroll];
#pragma unroll
        for (int u = 0; u < kGUnroll; ++u) {
          const int pp = r0 + u * kGWarps;
          b[u] = pp < pn ? load4(w + static_cast<size_t>(p0 + pp) * N, n0, N, vec)
                         : 0u;
        }
#pragma unroll
        for (int u = 0; u < kGUnroll; ++u) {
          const int pp = r0 + u * kGWarps;
          if (pp < pn) {
#pragma unroll
            for (int j = 0; j < 4; ++j) gemv_row<MODE>(xs, 4 * pp + j, b[u], j, acc);
          }
        }
      }
    }
  }
}

// Adds the 8 warps' sums in warp order into red[0] (returned through red).
__device__ __forceinline__ void gemv_stash(
    float (&red)[kGWarps][kBM][kGCols],
    const float (&acc)[kBM][kColsPerThread]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      red[warp][m][lane * kColsPerThread + c] = acc[m][c];
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(kGThreads)
tm_gemv_float_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int K, int N, int k_per_split, int vec, int partial) {
  __shared__ __align__(16) float xs[kGChunk][kBM];
  __shared__ float red[kGWarps][kBM][kGCols];
  const int n0 = blockIdx.x * kGCols + (threadIdx.x % 32) * kColsPerThread;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  float acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;
  gemv_accumulate<MODE>(x, w, xs, acc, M, K, N, n0, kb0, kb1, vec);
  gemv_stash(red, acc);
  for (int i = threadIdx.x; i < kBM * kGCols; i += kGThreads) {
    const int mm = i / kGCols, nn = i % kGCols;
    const int gn = blockIdx.x * kGCols + nn;
    if (mm >= M || gn >= N) continue;
    float s = red[0][mm][nn];
#pragma unroll
    for (int q = 1; q < kGWarps; ++q) s += red[q][mm][nn];
    if (partial)
      out[(static_cast<size_t>(blockIdx.z) * M + mm) * N + gn] = s;
    else
      out[static_cast<size_t>(mm) * N + gn] = s * scale[gn];
  }
}

// ------------------------------------------- decode, bf16 / int8 (gemv)

constexpr int kGvThreads = 128;                    // 4 warps
constexpr int kGvRows = 64;                        // packed rows per stage
constexpr int kGvGroup = 32;                       // columns per warp
constexpr int kGvRingBytes = 32 * 1024;            // about, per block

template <int MODE, typename T, int BN>
struct GemvShape {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kGroups = BN / kGvGroup;          // 32-column groups
  static constexpr int kKW = kGvThreads / 32 / kGroups;  // warps per group,
                                                         // which split K
  static constexpr int kKS = MODE == kBase3 ? kGvRows : 4 * kGvRows;  // K
                                                         // rows per stage
  static constexpr int kSteps = kKS * sizeof(T) / 32;    // 32-byte mma steps
  // A stage is the raw tile [64][BN] as the TMA writes it, its 16-byte
  // chunks XOR-swizzled by row (BN-byte swizzle), then x [8][kKS], dense.
  static constexpr int kW = kGvRows * BN;
  static constexpr int kXRow = kKS * sizeof(T);
  static constexpr int kX = kBM * kXRow;
  static constexpr int kStage = (kW + kX + 1023) / 1024 * 1024;
  static constexpr int kRing = kGvRingBytes / kStage < 3 ? 3
      : kGvRingBytes / kStage > 8 ? 8 : kGvRingBytes / kStage;
  // the swizzle: chunk c of row r sits at c ^ swz(r)
  static __device__ __forceinline__ int swz(int r) {
    return ((r * BN) >> 7) & (BN / 16 - 1);
  }
  static constexpr int kPartRow = BN + 4;                // padded sums row
  // after the ring, the inbox (the cluster's sums of this block's rows),
  // then one mbarrier per ring slot; 1 KB spare to align the ring
  static constexpr int kInbox = kRing * kStage;
  static constexpr int kBars = kInbox + kBM * kPartRow * 4;
  static constexpr int kSmem = kBars + 8 * kRing + 1024;
  static_assert(kGroups * kKW == kGvThreads / 32, "the warps cover the tile");
  static_assert(kKW * kBM * kPartRow * 4 <= kInbox,
                "the warps' sums fit in the ring");
  static_assert(kSmem <= 48 * 1024, "no opt-in shared memory needed");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// The box of `map` at (c0, c1) into shared memory by the TMA, counted
// on the mbarrier at `bar` when it lands; what lies outside the tensor
// arrives as 0.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}

// The same stage staged by the block's threads with byte loads and
// stores, for operands that are not 16-byte aligned: the TMA's layout,
// with everything past M, K, the split or N written as 0.
template <int MODE, typename T, int BN>
__device__ __forceinline__ void gemv_fill(const T* __restrict__ x,
                                          const uint8_t* __restrict__ w,
                                          uint8_t* st, int t, int M, int K,
                                          int N, int n0, int kb0, int kb1) {
  using S = GemvShape<MODE, T, BN>;
  const int k0 = kb0 + t * S::kKS;
  for (int i = threadIdx.x; i < kBM * S::kXRow; i += kGvThreads) {
    const int r = i / S::kXRow, b = i % S::kXRow;
    const int e = b / static_cast<int>(sizeof(T));
    st[S::kW + i] = (r < M && k0 + e < kb1)
        ? reinterpret_cast<const uint8_t*>(
              x + static_cast<size_t>(r) * K + k0)[b] : 0;
  }
  const int p0 = MODE == kBase3 ? k0 : k0 / 4;
  const int pend = MODE == kBase3 ? kb1 : kb1 / 4;
  for (int i = threadIdx.x; i < kGvRows * BN; i += kGvThreads) {
    const int r = i / BN, c = i % BN;
    st[r * BN + (c ^ (S::swz(r) << 4))] =
        (p0 + r < pend && n0 + c < N)
            ? w[static_cast<size_t>(p0 + r) * N + n0 + c] : 0;
  }
}

// This warp's k steps of stage t (st): for its 32-column group, two m16
// tiles += decode(w)^T . x^T.  Lane (g, q): the word at byte 4 (g % 4) of
// chunk g / 4 of its group holds columns 4g .. 4g + 3, whose column c is
// row g (c even) or g + 8 (c odd) of tile c / 2; a[tile][0..3] are the
// mma's a0..a3.
template <int MODE, typename T, int BN>
__device__ __forceinline__ void gemv_stage(
    const uint8_t* st, int t, typename AccOf<T>::type (&acc)[2][4]) {
  using S = GemvShape<MODE, T, BN>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kw = warp / S::kGroups;
  const int g = lane / 4, q = lane % 4;
  const int cb = (warp % S::kGroups) * kGvGroup + 4 * g;
  const uint8_t* xr = st + S::kW + g * S::kXRow;
  auto word = [&](int r) {
    return *reinterpret_cast<const uint32_t*>(st + r * BN
                                              + (cb ^ (S::swz(r) << 4)));
  };
#pragma unroll
  for (int s = 0; s < S::kSteps; ++s) {
    if ((t * S::kSteps + s) % S::kKW != kw) continue;
    uint32_t a[2][4], b0, b1;
    if constexpr (!S::kInt8) {
      // K slots (2q, 2q + 1, 2q + 8, 2q + 9) of the k16 step hold K rows
      // 4q .. 4q + 3: x[g][4q .. 4q + 3] is the B fragment
      const uint2 bx = *reinterpret_cast<const uint2*>(xr + s * 32 + 8 * q);
      b0 = bx.x;
      b1 = bx.y;
      if constexpr (MODE == kBase3) {
        constexpr float kOff = 8388608.0f + kBase3Offset;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = word(16 * s + 4 * q + i);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a[c / 2][c % 2] = __byte_perm(byte_f32(r[0], c, kOff),
                                        byte_f32(r[1], c, kOff), 0x7632);
          a[c / 2][2 + c % 2] = __byte_perm(byte_f32(r[2], c, kOff),
                                            byte_f32(r[3], c, kOff), 0x7632);
        }
      } else {
        // one packed row holds the lane's 4 K rows of each column
        const uint32_t f = trit2_fields_plus_one(word(4 * s + q));
        const uint32_t even = f & 0x33333333u, odd = (f >> 2) & 0x33333333u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t p = __byte_perm(even, odd, c | ((4 + c) << 8));
          a[c / 2][c % 2] = bf16x2_minus_one(p & 0x00030003u);
          a[c / 2][2 + c % 2] = bf16x2_minus_one((p >> 4) & 0x00030003u);
        }
      }
    } else {
      // k32 step: K rows 4q .. 4q + 3 (h = 0) and 16 + 4q .. (h = 1)
      b0 = *reinterpret_cast<const uint32_t*>(xr + s * 32 + 4 * q);
      b1 = *reinterpret_cast<const uint32_t*>(xr + s * 32 + 16 + 4 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t c4[4];
        if constexpr (MODE == kBase3) {
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = word(32 * s + 16 * h + 4 * q + i);
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t u1 = __byte_perm(r[2], r[3], 0x7362);
          c4[0] = base3_s8(__byte_perm(t0, u0, 0x5410));
          c4[1] = base3_s8(__byte_perm(t0, u0, 0x7632));
          c4[2] = base3_s8(__byte_perm(t1, u1, 0x5410));
          c4[3] = base3_s8(__byte_perm(t1, u1, 0x7632));
        } else {
          const uint32_t b = word(8 * s + 4 * h + q);
#pragma unroll
          for (int c = 0; c < 4; ++c) c4[c] = trit2_s8((b >> (8 * c)) & 0xffu);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c / 2][2 * h + c % 2] = c4[c];
      }
    }
    mma_tile(acc[0], a[0], b0, b1);
    mma_tile(acc[1], a[1], b0, b1);
  }
}

// The cluster barrier in its two halves (every thread of every block).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename Acc>
__device__ __forceinline__ void add4(Acc (&v)[4], const Acc* p) {
  alignas(16) Acc u[4];
  *reinterpret_cast<uint4*>(u) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] += u[e];
}

// grid (ceil(N / BN), 1, splits), launched as clusters of (1, 1, splits):
// block z sums K rows [z * k_per_split, (z + 1) * k_per_split) of
// columns [x * BN, (x + 1) * BN) for all M <= 8 rows.  raw (int8 x only):
// out is (M, N) int32 and takes the exact sums, with no scales.
template <int MODE, typename T, int BN>
__global__ void __launch_bounds__(kGvThreads)
tm_gemv_kernel(const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap xmap,
               const T* __restrict__ x, const float* __restrict__ xscale,
               const uint8_t* __restrict__ w, const float* __restrict__ scale,
               void* __restrict__ out, int M, int K, int N, int k_per_split,
               int vec, int raw) {
  using S = GemvShape<MODE, T, BN>;
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) uint8_t dyn[];
  // the ring starts on a 1 KB boundary (the 128-byte swizzle's period)
  uint8_t* smem = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN;
  const int rank = blockIdx.z, splits = gridDim.z;
  const int kb0 = rank * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  const int stages = kb1 > kb0 ? (kb1 - kb0 + S::kKS - 1) / S::kKS : 0;
  // A rank may write into another's inbox only once that block runs:
  // every block says it has started here and waits for the others just
  // before its first remote write, long after.
  if (splits > 1) cluster_arrive_relaxed();

  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = Acc(0);

  const uint32_t ring = smem_u32(smem), bars = ring + S::kBars;
  if (vec) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S::kRing; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // Stage t lives in slot t % kRing, its two boxes (the raw tile at
    // packed row p0, x at K row k0) counted on that slot's mbarrier
    // (phase t / kRing); iteration t issues stage t + kRing - 1 into the
    // slot that stage t - 1 freed, after the barrier that shows every
    // warp is done with it.
    auto issue = [&](int t) {
      if (threadIdx.x == 0 && t < stages) {
        const int k0 = kb0 + t * S::kKS, s = t % S::kRing;
        mbar_expect_tx(bars + 8 * s, S::kW + S::kX);
        tma_box(ring + s * S::kStage, &wmap, n0,
                MODE == kBase3 ? k0 : k0 / 4, bars + 8 * s);
        tma_box(ring + s * S::kStage + S::kW, &xmap, k0, 0, bars + 8 * s);
      }
    };
#pragma unroll
    for (int t = 0; t < S::kRing - 1; ++t) issue(t);
    for (int t = 0; t < stages; ++t) {
      mbar_wait(bars + 8 * (t % S::kRing), (t / S::kRing) & 1);
      __syncthreads();
      issue(t + S::kRing - 1);
      gemv_stage<MODE, T, BN>(smem + (t % S::kRing) * S::kStage, t, acc);
    }
  } else {
    for (int t = 0; t < stages; ++t) {
      __syncthreads();
      gemv_fill<MODE, T, BN>(x, w, smem, t, M, K, N, n0, kb0, kb1);
      __syncthreads();
      gemv_stage<MODE, T, BN>(smem, t, acc);
    }
  }
  __syncthreads();

  // The ring is free: each warp leaves its sums as [row][column] (lane
  // (g, q) holds rows 2q, 2q + 1 of columns 4g .. 4g + 3), one array per
  // K warp.
  Acc* part = reinterpret_cast<Acc*>(smem);
  Acc* inbox = reinterpret_cast<Acc*>(smem + S::kInbox);
  {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    Acc* p = part + ((warp / S::kGroups) * kBM + 2 * q) * S::kPartRow
             + (warp % S::kGroups) * kGvGroup + 4 * g;
    alignas(16) Acc v0[4] = {acc[0][0], acc[0][2], acc[1][0], acc[1][2]};
    alignas(16) Acc v1[4] = {acc[0][1], acc[0][3], acc[1][1], acc[1][3]};
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v0);
    *reinterpret_cast<uint4*>(p + S::kPartRow) =
        *reinterpret_cast<const uint4*>(v1);
  }
  __syncthreads();

  // Row r belongs to rank r % splits.  Each rank adds its K warps' sums
  // in warp order and writes them into slot [rank][r / splits] of the
  // owner's inbox (its own shared memory, or another block's through
  // distributed shared memory); one cluster barrier later the owner adds
  // its slots in rank order, so the result does not depend on timing.
  constexpr int kQuads = kBM * BN / 4;           // 4 outputs each
  const int owned = kBM / splits;                // rows per rank
  const bool vec4 = N % 4 == 0
      && ((reinterpret_cast<uintptr_t>(out)
           | reinterpret_cast<uintptr_t>(scale)) & 15u) == 0;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster_wait();                // every block has started
  for (int i = threadIdx.x; i < kQuads; i += kGvThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (r >= M || n0 + c >= N) continue;
    const Acc* p = part + r * S::kPartRow + c;
    alignas(16) Acc v[4];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int kw = 1; kw < S::kKW; ++kw) add4(v, p + kw * kBM * S::kPartRow);
    if (splits == 1) {
      put_outputs(v, xscale, scale, out, M, N, r, n0 + c, raw ? 0 : -1,
                  vec4);
      continue;
    }
    Acc* dst = cluster.map_shared_rank(inbox, r % splits)
               + (rank * owned + r / splits) * S::kPartRow + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
  if (splits == 1) return;
  cluster_arrive_release();
  cluster_wait();                                // every slot has landed
  for (int i = threadIdx.x; i < owned * BN / 4; i += kGvThreads) {
    const int j = i / (BN / 4), c = 4 * (i % (BN / 4));
    const int r = rank + j * splits;
    if (r >= M || n0 + c >= N) continue;
    const Acc* p = inbox + j * S::kPartRow + c;
    alignas(16) Acc v[4];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    for (int z = 1; z < splits; ++z) add4(v, p + z * owned * S::kPartRow);
    put_outputs(v, xscale, scale, out, M, N, r, n0 + c, raw ? 0 : -1, vec4);
  }
}

// ---------------------------------------------------------------- splits

__global__ void tm_float_reduce(const float* __restrict__ partial,
                                const float* __restrict__ scale,
                                float* __restrict__ out, int M, int N,
                                int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = partial[i];
  for (int z = 1; z < splits; ++z) s += partial[z * total + i];
  out[i] = s * scale[i % N];
}

__global__ void tm_int8_reduce(const int* __restrict__ partial,
                               const float* __restrict__ xscale,
                               const float* __restrict__ scale,
                               float* __restrict__ out, int M, int N,
                               int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = partial[i];
  for (int z = 1; z < splits; ++z) s += partial[z * total + i];
  out[i] = __fmul_rn(__fmul_rn(__int2float_rn(s), xscale[i / N]),
                     scale[i % N]);
}

__global__ void tm_int32_reduce(const int* __restrict__ partial,
                                int* __restrict__ out, int M, int N,
                                int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = partial[i];
  for (int z = 1; z < splits; ++z) s += partial[z * total + i];
  out[i] = s;
}

template <int MODE>
void launch_float(const float* x, const uint8_t* w, const float* scale,
                  float* dst, int M, int K, int N, int splits,
                  int k_per_split, int vec, int partial, cudaStream_t st) {
  if (M <= kBM) {
    const dim3 grid((N + kGCols - 1) / kGCols, 1, splits);
    tm_gemv_float_kernel<MODE><<<grid, kGThreads, 0, st>>>(
        x, w, scale, dst, M, K, N, k_per_split, vec, partial);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    tm_float_kernel<MODE><<<grid, kThreads, 0, st>>>(
        x, w, scale, dst, M, K, N, k_per_split, vec, partial);
  }
}

// Lets tm_mma_kernel<MODE, T, BM> take its shared tiles (above the
// default 48 KB) on the current device: one driver call per device.
template <int MODE, typename T, int BM>
cudaError_t allow_mma_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(tm_mma_kernel<MODE, T, BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaShape<MODE, T, BM>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int MODE, typename T, int BM>
cudaError_t launch_mma(const T* x, const float* xs, const uint8_t* w,
                       const float* scale, void* dst, int M, int K, int N,
                       int splits, int k_per_split, int vec, int partial,
                       cudaStream_t st) {
  constexpr int smem = MmaShape<MODE, T, BM>::kSmem;
  const cudaError_t err = allow_mma_smem<MODE, T, BM>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMBN - 1) / kMBN, (M + BM - 1) / BM, splits);
  tm_mma_kernel<MODE, T, BM><<<grid, MmaShape<MODE, T, BM>::kThreads, smem,
                               st>>>(
      x, xs, w, scale, dst, M, K, N, k_per_split, vec, partial);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_any(const T* x, const float* xs, const uint8_t* w,
                           const float* scale, void* dst, int M, int K, int N,
                           int mode, int bm, int splits, int k_per_split,
                           int vec, int partial, cudaStream_t st) {
  using Launch = cudaError_t (*)(const T*, const float*, const uint8_t*,
                                 const float*, void*, int, int, int, int,
                                 int, int, int, cudaStream_t);
  Launch fn = nullptr;
  if (mode == kBase3)
    fn = bm == 128 ? launch_mma<0, T, 128>
       : bm == 256 ? launch_mma<0, T, 256> : nullptr;
  else
    fn = bm == 128 ? launch_mma<1, T, 128>
       : bm == 256 ? launch_mma<1, T, 256> : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(x, xs, w, scale, dst, M, K, N, splits, k_per_split, vec, partial,
            st);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime (the library
// links no libcuda of its own); nullptr where it is missing.
EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess) {
      f = reinterpret_cast<EncodeTiled>(p);
      fn.store(f, std::memory_order_release);
    }
  }
  return f;
}

// A rank-2 tensor map of `rows` x `cols` elements, rows `pitch` bytes
// apart, read in boxes of box_rows x box_cols.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int cols, int rows, size_t pitch,
                       int box_cols, int box_rows, CUtensorMapSwizzle swz) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dim, stride, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MODE, typename T, int BN>
cudaError_t launch_gemv(const T* x, const float* xs, const uint8_t* w,
                        const float* scale, void* out, int M, int K, int N,
                        int cluster, int k_per_split, int vec, int raw,
                        cudaStream_t st) {
  using S = GemvShape<MODE, T, BN>;
  // the raw tile in 64 x BN boxes, swizzled by BN bytes; x in 8 x kKS
  // boxes, the rows past M read as 0
  CUtensorMap wmap = {}, xmap = {};
  if (vec) {
    const CUtensorMapSwizzle swz = BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : BN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
    cudaError_t err = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                                 MODE == kBase3 ? K : K / 4, N, BN, kGvRows,
                                 swz);
    if (err != cudaSuccess) return err;
    err = tensor_map(&xmap, S::kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     x, K, M, static_cast<size_t>(K) * sizeof(T), S::kKS,
                     kBM, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, 1, cluster);
  cfg.blockDim = dim3(kGvThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tm_gemv_kernel<MODE, T, BN>, wmap, xmap, x, xs, w, scale, out, M,
      K, N, k_per_split, vec, raw);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv_any(const T* x, const float* xs, const uint8_t* w,
                            const float* scale, void* out, int M, int K,
                            int N, int mode, int block_n, int cluster,
                            int k_per_split, int vec, int raw,
                            cudaStream_t st) {
  using Launch = cudaError_t (*)(const T*, const float*, const uint8_t*,
                                 const float*, void*, int, int, int, int,
                                 int, int, int, cudaStream_t);
  const Launch table[2][3] = {
      {launch_gemv<0, T, 32>, launch_gemv<0, T, 64>, launch_gemv<0, T, 128>},
      {launch_gemv<1, T, 32>, launch_gemv<1, T, 64>, launch_gemv<1, T, 128>}};
  const int b = block_n == 32 ? 0 : block_n == 64 ? 1 : block_n == 128 ? 2
                                                                       : -1;
  if (b < 0 || (mode != 0 && mode != 1)) return cudaErrorInvalidValue;
  return table[mode][b](x, xs, w, scale, out, M, K, N, cluster, k_per_split,
                        vec, raw, st);
}

// What tm_gemv_kernel takes: 1-8 rows, a cluster of 1, 2, 4 or 8 blocks
// whose splits are whole stages and cover K.
bool gemv_plan_ok(int M, int K, int N, int mode, int cluster,
                  int k_per_split) {
  const int stage = mode == kBase3 ? kGvRows : 4 * kGvRows;
  return M >= 1 && M <= kBM && K >= 1 && N >= 1 && (mode == 0 || mode == 1)
      && (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8)
      && k_per_split > 0 && k_per_split % stage == 0
      && static_cast<long long>(cluster) * k_per_split >= K;
}

unsigned reduce_blocks(int M, int N) {
  return static_cast<unsigned>((static_cast<size_t>(M) * N + 255) / 256);
}

}  // namespace

// The CUDA-core route: x (M, K) f32, any M; w: packed uint8 (K, N) base3
// (mode 0) or (K/4, N) trit2 (mode 1, K a multiple of 4); scale: (N,)
// f32; out: (M, N) f32; partial: (splits, M, N) f32 when splits > 1.
// k_per_split is a multiple of 64.  bf16 and int8 x take tm_gemv_launch
// (M <= 8) or tm_mma_launch.  Returns cudaGetLastError().
extern "C" int tm_float_launch(const void* x, const void* w,
                               const void* scale, void* out, void* partial,
                               int M, int K, int N, int mode, int splits,
                               int k_per_split, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int use_partial = splits > 1;
  float* dst = static_cast<float*>(use_partial ? partial : out);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  if (mode == kBase3)
    launch_float<0>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                    use_partial, st);
  else
    launch_float<1>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                    use_partial, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !use_partial) return static_cast<int>(err);
  tm_float_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
      static_cast<const float*>(partial), sp, static_cast<float*>(out), M, N,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// The decode route (tm_gemv_kernel), one launch per call.  x: (M, K) with
// 1 <= M <= 8, bf16 (x_type 1, float domain; xscale unused) or int8
// (x_type 2) with xscale (M,) f32; x_type 0 (f32) is refused, as is any
// M above 8.  w, scale, out as above.  block_n: 32, 64 or 128 columns
// per block; cluster: 1, 2, 4 or 8 blocks splitting K, each taking
// k_per_split rows (a multiple of 64 base3 or 256 trit2 rows; the splits
// must cover K).  vec: every x row and w row starts 16-byte aligned, as
// the TMA needs (else the threads stage them byte by byte).  Returns the
// launch's error, or cudaErrorInvalidValue for what the kernel does not
// take.
extern "C" int tm_gemv_launch(const void* x, int x_type, const void* xscale,
                              const void* w, const void* scale, void* out,
                              int M, int K, int N, int mode, int block_n,
                              int cluster, int k_per_split, int vec,
                              void* stream) {
  if (!(x_type == 1 || x_type == 2)
      || !gemv_plan_ok(M, K, N, mode, cluster, k_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xsp = static_cast<const float*>(xscale);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const cudaError_t err =
      x_type == 2
          ? launch_gemv_any(static_cast<const int8_t*>(x), xsp, wp, sp, out,
                            M, K, N, mode, block_n, cluster, k_per_split, vec,
                            0, st)
          : launch_gemv_any(static_cast<const __nv_bfloat16*>(x), xsp, wp, sp,
                            out, M, K, N, mode, block_n, cluster, k_per_split,
                            vec, 0, st);
  return static_cast<int>(err);
}

// The tensor-core route (M > 8).  x: (M, K) bf16 (x_int8 = 0, float
// domain; xscale unused) or int8 (x_int8 = 1) with xscale (M,) f32; w,
// scale, out as above; partial: (splits, M, N) f32 or int32 when
// splits > 1; bm: 128 or 256 rows per block tile; k_per_split a multiple
// of 64; vec: every x row and w row starts 16-byte aligned (else the
// staging falls to byte loads).  Returns cudaGetLastError().
extern "C" int tm_mma_launch(const void* x, int x_int8, const void* xscale,
                             const void* w, const void* scale, void* out,
                             void* partial, int M, int K, int N, int mode,
                             int bm, int splits, int k_per_split, int vec,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int use_partial = splits > 1;
  void* dst = use_partial ? partial : out;
  const auto* xsp = static_cast<const float*>(xscale);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  cudaError_t err =
      x_int8 ? launch_mma_any(static_cast<const int8_t*>(x), xsp, wp, sp, dst,
                              M, K, N, mode, bm, splits, k_per_split, vec,
                              use_partial, st)
             : launch_mma_any(static_cast<const __nv_bfloat16*>(x), xsp, wp,
                              sp, dst, M, K, N, mode, bm, splits, k_per_split,
                              vec, use_partial, st);
  if (err != cudaSuccess || !use_partial) return static_cast<int>(err);
  if (x_int8)
    tm_int8_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
        static_cast<const int*>(partial), xsp, sp, static_cast<float*>(out),
        M, N, splits);
  else
    tm_float_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
        static_cast<const float*>(partial), sp, static_cast<float*>(out), M,
        N, splits);
  return static_cast<int>(cudaGetLastError());
}

// The int32 epilogue of both int8 routes, for cim_mac's code route
// (kernels/cim_mac.py): x (M, K) int8 times the packed w, the exact int32
// sums written to out (M, N) int32 as they are, with no scales.  Plans,
// operands and errors as tm_gemv_launch (M <= 8) and tm_mma_launch
// (partial: (splits, M, N) int32 when splits > 1, added in split order).
extern "C" int tm_gemv_int32_launch(const void* x, const void* w, void* out,
                                    int M, int K, int N, int mode,
                                    int block_n, int cluster,
                                    int k_per_split, int vec, void* stream) {
  if (!gemv_plan_ok(M, K, N, mode, cluster, k_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gemv_any(
      static_cast<const int8_t*>(x), nullptr,
      static_cast<const uint8_t*>(w), nullptr, out, M, K, N, mode, block_n,
      cluster, k_per_split, vec, 1, static_cast<cudaStream_t>(stream)));
}

extern "C" int tm_mma_int32_launch(const void* x, const void* w, void* out,
                                   void* partial, int M, int K, int N,
                                   int mode, int bm, int splits,
                                   int k_per_split, int vec, void* stream) {
  if (M < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one split writes its raw sums straight into out (plane 0)
  const cudaError_t err = launch_mma_any(
      static_cast<const int8_t*>(x), nullptr, static_cast<const uint8_t*>(w),
      nullptr, splits > 1 ? partial : out, M, K, N, mode, bm, splits,
      k_per_split, vec, 1, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  tm_int32_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
      static_cast<const int*>(partial), static_cast<int*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
