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
//
// decode: base3 stores one weight per byte as v + 121 (v in [-121, 121]);
// trit2 stores four trits per byte as 2-bit codes, little-endian along K
// (0 -> 0, 1 -> +1, 2 -> -1, 3 -> 0).
//
// What bounds it on an H100: at decode (M = batch <= 8) the packed
// weight bytes, read once per step at 3.35 TB/s; at prefill (M ~ 1e3)
// the multiply-adds, which these kernels run on the CUDA cores.
//
// Design.  A block of 128 threads owns a tile of 8 rows x 128 output
// columns and loops over K itself; nothing carries across blocks.  A
// thread owns 4 adjacent columns and reads their packed bytes as one
// 32-bit load, so a warp reads 128 contiguous bytes of a weight row
// (coalesced).  The bytes are decoded in registers: no dequantized
// weight exists in device memory.  Activations are staged in shared
// memory, 8 rows x 64 K at a time, and broadcast to all column threads.
// The four warps of a block split each K chunk four ways and combine
// their sums in shared memory in a fixed order.
//
// Decode (M <= 8) takes a second, weight-streaming kernel (tm_gemv_*):
// one row tile covers every row, so each weight byte is read once per
// call.  A block of 8 warps owns 128 output columns; the warps take
// interleaved K rows (warp w reads rows w, w + 8, ...), so at any moment
// the block reads 8 neighbouring 128-byte row segments, and each lane
// issues 8 row loads before it computes, to keep more bytes in flight
// than the tiled kernel does (PERF.md has the measured rate).  The activations
// are staged in shared memory as [k][row], so a lane reads the 8 rows
// of one k with two 16-byte loads (a broadcast across the warp).
//
// Where the output tiles alone would leave the SMs idle (decode: 8 to 64
// column tiles for N = 1024 to 8192), the wrapper splits K across blocks
// (grid.z); each split writes its partial sums and a second kernel adds
// them in split order and applies the epilogue, so the result is
// deterministic.  Ragged M, N and K edges are masked, not padded.  Later
// work: bf16/int8 tensor-core products (mma.sync / wgmma, TMA staging)
// for prefill, where this file's kernels run on the CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// Activation element -> accumulation type (float or int).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }

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

// Accumulates the block's K range [kb0, kb1) into acc.  T is float or int.
template <int MODE, typename T, typename XT>
__device__ __forceinline__ void accumulate(
    const XT* __restrict__ x, const uint8_t* __restrict__ w,
    T (&xs)[kBM][kKC], T (&acc)[kBM][kColsPerThread], int M, int K, int N,
    int m0, int n0, int kb0, int kb1, int slice, int vec) {
  const int t = threadIdx.x;
  for (int kc = kb0; kc < kb1; kc += kKC) {
    __syncthreads();
    for (int i = t; i < kBM * kKC; i += kThreads) {
      const int mm = i / kKC, kk = i % kKC;
      const int gm = m0 + mm, gk = kc + kk;
      T v = T(0);
      if (gm < M && gk < kb1) v = T(widen(x[static_cast<size_t>(gm) * K + gk]));
      xs[mm][kk] = v;
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
template <typename T>
__device__ __forceinline__ void stash(T (&red)[kSlices][kBM][kBN],
                                      const T (&acc)[kBM][kColsPerThread],
                                      int slice, int cg) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      red[slice][m][cg * kColsPerThread + c] = acc[m][c];
  __syncthreads();
}

template <int MODE, typename XT>
__global__ void __launch_bounds__(kThreads)
tm_float_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int K, int N, int k_per_split, int vec, int partial) {
  __shared__ float xs[kBM][kKC];
  __shared__ float red[kSlices][kBM][kBN];
  const int cg = threadIdx.x % kColGroups, slice = threadIdx.x / kColGroups;
  const int n0 = blockIdx.x * kBN + cg * kColsPerThread;
  const int m0 = blockIdx.y * kBM;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  float acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;
  accumulate<MODE>(x, w, xs, acc, M, K, N, m0, n0, kb0, kb1, slice, vec);
  stash(red, acc, slice, cg);
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tm_int8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xscale,
               const uint8_t* __restrict__ w, const float* __restrict__ scale,
               void* __restrict__ out, int M, int K, int N, int k_per_split,
               int vec, int partial) {
  __shared__ int xs[kBM][kKC];
  __shared__ int red[kSlices][kBM][kBN];
  const int cg = threadIdx.x % kColGroups, slice = threadIdx.x / kColGroups;
  const int n0 = blockIdx.x * kBN + cg * kColsPerThread;
  const int m0 = blockIdx.y * kBM;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  int acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0;
  accumulate<MODE>(x, w, xs, acc, M, K, N, m0, n0, kb0, kb1, slice, vec);
  stash(red, acc, slice, cg);
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int mm = i / kBN, nn = i % kBN;
    const int gm = m0 + mm, gn = blockIdx.x * kBN + nn;
    if (gm >= M || gn >= N) continue;
    int s = red[0][mm][nn];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) s += red[q][mm][nn];
    if (partial) {
      static_cast<int*>(out)[(static_cast<size_t>(blockIdx.z) * M + gm) * N + gn] = s;
    } else {
      static_cast<float*>(out)[static_cast<size_t>(gm) * N + gn] =
          __fmul_rn(__fmul_rn(__int2float_rn(s), xscale[gm]), scale[gn]);
    }
  }
}

// ---------------------------------------------------------------- decode

constexpr int kGWarps = 8;
constexpr int kGThreads = kGWarps * 32;
constexpr int kGCols = 32 * kColsPerThread;        // 128 output columns
constexpr int kGChunk = 256;                       // K rows staged at once
constexpr int kGUnroll = 8;                        // row loads in flight
constexpr uint32_t kBase3Zero = 0x79797979u;       // four bytes of 121

__device__ __forceinline__ void rows8(const float* p, float (&v)[kBM]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void rows8(const int* p, int (&v)[kBM]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[m][c] += x[m][k] * decode(b)[c] for the 8 rows of staged k row kk
// (trit2: field j of each byte).
template <int MODE, typename T>
__device__ __forceinline__ void gemv_row(const T (&xs)[kGChunk][kBM],
                                         int kk, uint32_t b, int j,
                                         T (&acc)[kBM][kColsPerThread]) {
  T xv[kBM];
  rows8(&xs[kk][0], xv);
  T wv[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c)
    wv[c] = T(MODE == kBase3 ? base3_value(b, c) : trit_value(b, c, j));
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] += xv[m] * wv[c];
}

template <int MODE, typename T, typename XT>
__device__ __forceinline__ void gemv_accumulate(
    const XT* __restrict__ x, const uint8_t* __restrict__ w,
    T (&xs)[kGChunk][kBM], T (&acc)[kBM][kColsPerThread], int M, int K,
    int N, int n0, int kb0, int kb1, int vec) {
  const int warp = threadIdx.x / 32;
  for (int kc = kb0; kc < kb1; kc += kGChunk) {
    const int kn = min(kGChunk, kb1 - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < kn * kBM; i += kGThreads) {
      const int mm = i / kn, kk = i % kn;             // coalesced along K
      xs[kk][mm] = mm < M ? T(widen(x[static_cast<size_t>(mm) * K + kc + kk]))
                          : T(0);
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
template <typename T>
__device__ __forceinline__ void gemv_stash(T (&red)[kGWarps][kBM][kGCols],
                                           const T (&acc)[kBM][kColsPerThread]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      red[warp][m][lane * kColsPerThread + c] = acc[m][c];
  __syncthreads();
}

template <int MODE, typename XT>
__global__ void __launch_bounds__(kGThreads)
tm_gemv_float_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
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

template <int MODE>
__global__ void __launch_bounds__(kGThreads)
tm_gemv_int8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xscale,
                    const uint8_t* __restrict__ w, const float* __restrict__ scale,
                    void* __restrict__ out, int M, int K, int N, int k_per_split,
                    int vec, int partial) {
  __shared__ __align__(16) int xs[kGChunk][kBM];
  __shared__ int red[kGWarps][kBM][kGCols];
  const int n0 = blockIdx.x * kGCols + (threadIdx.x % 32) * kColsPerThread;
  const int kb0 = blockIdx.z * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);
  int acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0;
  gemv_accumulate<MODE>(x, w, xs, acc, M, K, N, n0, kb0, kb1, vec);
  gemv_stash(red, acc);
  for (int i = threadIdx.x; i < kBM * kGCols; i += kGThreads) {
    const int mm = i / kGCols, nn = i % kGCols;
    const int gn = blockIdx.x * kGCols + nn;
    if (mm >= M || gn >= N) continue;
    int s = red[0][mm][nn];
#pragma unroll
    for (int q = 1; q < kGWarps; ++q) s += red[q][mm][nn];
    if (partial) {
      static_cast<int*>(out)[(static_cast<size_t>(blockIdx.z) * M + mm) * N + gn] = s;
    } else {
      static_cast<float*>(out)[static_cast<size_t>(mm) * N + gn] =
          __fmul_rn(__fmul_rn(__int2float_rn(s), xscale[mm]), scale[gn]);
    }
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

dim3 grid_of(int M, int N, int splits) {
  if (M <= kBM) return dim3((N + kGCols - 1) / kGCols, 1, splits);
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
}

template <int MODE, typename XT>
void launch_float(const XT* x, const uint8_t* w, const float* scale, float* dst,
                  int M, int K, int N, int splits, int k_per_split, int vec,
                  int partial, cudaStream_t st) {
  const dim3 grid = grid_of(M, N, splits);
  if (M <= kBM)
    tm_gemv_float_kernel<MODE><<<grid, kGThreads, 0, st>>>(
        x, w, scale, dst, M, K, N, k_per_split, vec, partial);
  else
    tm_float_kernel<MODE><<<grid, kThreads, 0, st>>>(
        x, w, scale, dst, M, K, N, k_per_split, vec, partial);
}

template <int MODE>
void launch_int8(const int8_t* x, const float* xs, const uint8_t* w,
                 const float* scale, void* dst, int M, int K, int N, int splits,
                 int k_per_split, int vec, int partial, cudaStream_t st) {
  const dim3 grid = grid_of(M, N, splits);
  if (M <= kBM)
    tm_gemv_int8_kernel<MODE><<<grid, kGThreads, 0, st>>>(
        x, xs, w, scale, dst, M, K, N, k_per_split, vec, partial);
  else
    tm_int8_kernel<MODE><<<grid, kThreads, 0, st>>>(
        x, xs, w, scale, dst, M, K, N, k_per_split, vec, partial);
}

unsigned reduce_blocks(int M, int N) {
  return static_cast<unsigned>((static_cast<size_t>(M) * N + 255) / 256);
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: packed uint8
// (K, N) base3 (mode 0) or (K/4, N) trit2 (mode 1, K a multiple of 4);
// scale: (N,) f32; out: (M, N) f32; partial: (splits, M, N) f32 when
// splits > 1.  k_per_split is a multiple of 64.  Returns cudaGetLastError().
extern "C" int tm_float_launch(const void* x, int x_bf16, const void* w,
                               const void* scale, void* out, void* partial,
                               int M, int K, int N, int mode, int splits,
                               int k_per_split, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int use_partial = splits > 1;
  float* dst = static_cast<float*>(use_partial ? partial : out);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  if (x_bf16) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    if (mode == kBase3)
      launch_float<0>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                      use_partial, st);
    else
      launch_float<1>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                      use_partial, st);
  } else {
    const auto* xp = static_cast<const float*>(x);
    if (mode == kBase3)
      launch_float<0>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                      use_partial, st);
    else
      launch_float<1>(xp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                      use_partial, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !use_partial) return static_cast<int>(err);
  tm_float_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
      static_cast<const float*>(partial), sp, static_cast<float*>(out), M, N,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// x: (M, K) int8; xscale: (M,) f32; w, scale as above; out: (M, N) f32;
// partial: (splits, M, N) int32 when splits > 1.  Returns cudaGetLastError().
extern "C" int tm_int8_launch(const void* x, const void* xscale, const void* w,
                              const void* scale, void* out, void* partial,
                              int M, int K, int N, int mode, int splits,
                              int k_per_split, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int use_partial = splits > 1;
  void* dst = use_partial ? partial : out;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* xsp = static_cast<const float*>(xscale);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  if (mode == kBase3)
    launch_int8<0>(xp, xsp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                   use_partial, st);
  else
    launch_int8<1>(xp, xsp, wp, sp, dst, M, K, N, splits, k_per_split, vec,
                   use_partial, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !use_partial) return static_cast<int>(err);
  tm_int8_reduce<<<reduce_blocks(M, N), 256, 0, st>>>(
      static_cast<const int*>(partial), xsp, sp, static_cast<float*>(out), M, N,
      splits);
  return static_cast<int>(cudaGetLastError());
}
