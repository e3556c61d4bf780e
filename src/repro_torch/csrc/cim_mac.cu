// Macro-exact ternary CIM MAC for Hopper (sm_90a): the TL-nvSRAM-CIM
// array's ADC-clipped shift-and-add.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/cim_mac.py
// (`cim_mac`).  It computes the semantics of the macro model
// `cim_matmul_int` (src/repro_torch/core/cim.py), the kernel's oracle:
//
//   x (qi, M, K) int8, w (qw, K, N) int8, trits in {-1, 0, 1}
//   K is cut into groups of 16 rows; group g has r_g = min(16, K - 16 g)
//   real rows (a partial last group's missing rows are deactivated)
//   mac_ij[g]  = sum_{k in g} x_i[m, k] * w_j[k, n]
//   code       = clamp(r_g - mac_ij[g], 0, 2^b - 1)      (the b-bit ADC)
//   out[m, n]  = sum_ij 3^(i+j) sum_g (r_g - code)        (int32)
//
// and r_g - clamp(r_g - mac, 0, C) = clamp(mac, r_g - C, r_g), since
// mac <= r_g.  At b = 5 this equals the Pallas kernel, which clips every
// group, partial or not, to [16 - 31, 16]; for b <= 4 and K not a
// multiple of 16 the Pallas kernel clips a partial group to the wrong
// window and its zero-padded groups add (16 - C) 3^(i+j) each, while this
// source follows the oracle.
//
// Two routes (kernels/cim_mac.py, route()):
//
// codes (b >= 5).  With C = 2^b - 1, clamp(mac, r_g - C, r_g) =
// mac + relu(r_g - C - mac), and summed with the powers of 3 the mac
// part is one product of the 5-trit codes, X = sum_i 3^i x_i and
// W = sum_j 3^j w_j in [-121, 121]:
//   out = X . W + sum_ij 3^(i+j) sum_g relu(r_g - C - mac_ij[g]).
// W + 121 is the base3 byte, so X . W is the int8 route of
// ternary_matmul_int8 with an int32 epilogue (csrc/ternary_matmul.cu:
// tensor cores, 1 byte per weight), exact in int32 (121^2 K < 2^31).
// The correction is 0 unless C < 2 r_g: never for b >= 6; at b = 5 only
// in a full group with mac = -16, i.e. x_i's 16 digits all non-zero and
// w_j's exactly their negation, which adds 3^(i+j).  cim_correct_kernel
// adds those terms: one thread per (row m, full group g) whose group has
// a weight column with a full plane derives the 16 codes' digits (a
// shared table) and, for each plane i whose 16 digits are all non-zero,
// its sign pattern; the warp then walks the weight's list of (column,
// planes full, sign patterns) for group g, lanes across columns, and adds
// 3^(i+j) for each plane j whose pattern is the opposite with an integer
// atomicAdd (exact in any order).  Its cost follows the flagged groups:
// with quantized Gaussian data about 0.1-0.2% of (plane, group) slices
// are full on either side; if every group saturates it is right but
// slow (an atomic per row, group and column).
//
// groups (b <= 4, where the clip bites almost everywhere): the dense
// per-group kernel, cim_mac_kernel, on the trit planes.  Layout: x and w
// row-major and contiguous; out (M, N) int32.  M, N and K are
// bounds-checked in the kernel: rows past M, columns past N and rows past
// K load as 0, groups past K are skipped, and nothing is padded in device
// memory.  A block of 256 threads owns a BM x BN output tile and walks
// its share of K two groups (32 rows) at a time.  Per step it stages the
// x planes as (qi, 2, BM) and the w planes as (qw, 2, BN) 16-byte vectors
// in shared memory, each vector one row's or one column's 16 trits of a
// group: w is transposed on the way in (a thread loads a 4 x 4 byte
// block, four rows of four columns, and turns it with __byte_perm).  Each
// thread then computes TM x TN outputs: per plane pair and group, four
// __dp4a give one group MAC, a min and a max clip it, and one multiply-add
// accumulates it with its power of 3, in int32.  Two tiles:
//   M <= 8 (decode): BM = 8, BN = 256, each thread one column and all
//     eight rows, so the block streams each weight-plane byte once;
//   M > 8 (prefill): BM = 64, BN = 64, 4 x 4 outputs per thread.
// When the tiles alone cannot fill the SMs, the wrapper splits the groups
// across blocks (gridDim.z) and the blocks add their int32 partial sums
// into the zeroed output with atomicAdd: integer addition is exact in any
// order, so the result is deterministic.
//
// Bound.  The least time the card could take.  codes: the one int8
// product, at decode (M = 8) its 1 byte per weight at 3.35 TB/s, at
// prefill its multiply-adds on the int8 tensor cores (1979 TOP/s).
// groups: the 5 plane bytes per weight at decode and the 25 plane-pair
// MACs at prefill; cim_mac_kernel runs them on the CUDA cores as dp4a
// plus the clip, about 7 int32 instructions per 16 products, and that
// instruction rate holds it back at both shapes.
//
// C interface (loaded with ctypes): cim_mac_launch(...) and
// cim_correct_launch(...) return cudaGetLastError() after the launch, 0
// on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // rows per group (ROWS_PER_GROUP)
constexpr int kMaxPlanes = 5;      // qi, qw <= 5
constexpr int kStage = 2;          // groups staged per step

__constant__ int kPow3[2 * kMaxPlanes - 1] = {1, 3, 9, 27, 81, 243, 729,
                                              2187, 6561};

// One 32-bit word of 4 consecutive int8 along a row, zero past the `avail`
// elements left in the row; `vec` says 4-byte loads are aligned.
__device__ __forceinline__ int load_word(const int8_t* p, int avail,
                                         bool vec) {
  if (avail >= 4 && vec) return __ldg(reinterpret_cast<const int*>(p));
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < avail) v |= (static_cast<int>(p[b]) & 0xff) << (8 * b);
  return v;
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
cim_mac_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int* __restrict__ out, int qi, int qw, int M, int K, int N,
               int cmax, int groups_per_split, int split, int xvec,
               int wvec) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile / thread mismatch");
  constexpr int kColThreads = BN / TN;
  __shared__ int4 xs[kMaxPlanes][kStage][BM];
  __shared__ int4 ws[kMaxPlanes][kStage][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int groups = (K + kRows - 1) / kRows;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  // thread's outputs: rows ty + a * (BM / TM), columns tx + b * kColThreads
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;

  int acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0;

  for (int g0 = g_begin; g0 < g_end; g0 += kStage) {
    // x: one 16-byte vector per (plane, group, row), built from 4 words
    for (int e = tid; e < qi * kStage * BM * 4; e += kThreads) {
      const int q = e & 3;
      const int row = (e >> 2) % BM;
      const int s = (e >> 2) / BM % kStage;
      const int i = (e >> 2) / BM / kStage;
      const int m = m0 + row;
      const int k = (g0 + s) * kRows + 4 * q;
      int v = 0;
      if (m < M && g0 + s < g_end && k < K)
        v = load_word(x + (static_cast<size_t>(i) * M + m) * K + k, K - k,
                      xvec);
      reinterpret_cast<int*>(&xs[i][s][row])[q] = v;
    }
    // w: a thread turns a 4 x 4 block (rows k..k+3, columns n..n+3) into
    // four column words
    for (int e = tid; e < qw * kStage * 4 * (BN / 4); e += kThreads) {
      const int rq = e & 3;
      const int nq = (e >> 2) % (BN / 4);
      const int s = (e >> 2) / (BN / 4) % kStage;
      const int j = (e >> 2) / (BN / 4) / kStage;
      const int n = n0 + 4 * nq;
      const int kb = (g0 + s) * kRows + 4 * rq;
      int r[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = kb + t;
        r[t] = (n < N && g0 + s < g_end && k < K)
                   ? load_word(w + (static_cast<size_t>(j) * K + k) * N + n,
                               N - n, wvec)
                   : 0;
      }
      const int t0 = __byte_perm(r[0], r[1], 0x5140);
      const int t1 = __byte_perm(r[0], r[1], 0x7362);
      const int u0 = __byte_perm(r[2], r[3], 0x5140);
      const int u1 = __byte_perm(r[2], r[3], 0x7362);
      reinterpret_cast<int*>(&ws[j][s][4 * nq + 0])[rq] =
          __byte_perm(t0, u0, 0x5410);
      reinterpret_cast<int*>(&ws[j][s][4 * nq + 1])[rq] =
          __byte_perm(t0, u0, 0x7632);
      reinterpret_cast<int*>(&ws[j][s][4 * nq + 2])[rq] =
          __byte_perm(t1, u1, 0x5410);
      reinterpret_cast<int*>(&ws[j][s][4 * nq + 3])[rq] =
          __byte_perm(t1, u1, 0x7632);
    }
    __syncthreads();

    for (int s = 0; s < kStage && g0 + s < g_end; ++s) {
      const int rg = min(kRows, K - (g0 + s) * kRows);   // real rows
      const int lo = rg - cmax;
      for (int i = 0; i < qi; ++i) {
        int4 xv[TM];
#pragma unroll
        for (int a = 0; a < TM; ++a) xv[a] = xs[i][s][ty + a * (BM / TM)];
        for (int j = 0; j < qw; ++j) {
          const int p3 = kPow3[i + j];
          int4 wv[TN];
#pragma unroll
          for (int b = 0; b < TN; ++b) wv[b] = ws[j][s][tx + b * kColThreads];
#pragma unroll
          for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int b = 0; b < TN; ++b) {
              int mac = __dp4a(xv[a].x, wv[b].x, 0);
              mac = __dp4a(xv[a].y, wv[b].y, mac);
              mac = __dp4a(xv[a].z, wv[b].z, mac);
              mac = __dp4a(xv[a].w, wv[b].w, mac);
              acc[a][b] += p3 * min(max(mac, lo), rg);
            }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int m = m0 + ty + a * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int n = n0 + tx + b * kColThreads;
      if (n >= N) continue;
      int* o = out + static_cast<size_t>(m) * N + n;
      if (split)
        atomicAdd(o, acc[a][b]);
      else
        *o = acc[a][b];
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const void* w, void* out, int qi, int qw,
                   int M, int K, int N, int cmax, int splits,
                   int groups_per_split, int xvec, int wvec,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cim_mac_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int*>(out), qi, qw, M, K, N, cmax, groups_per_split,
      splits > 1, xvec, wvec);
  return cudaGetLastError();
}

// ------------------------------------------ codes route: the correction

constexpr int kCorrThreads = 256;
constexpr int kTritRange = 121;    // 5-trit codes lie in [-121, 121]

// The 5 balanced-ternary digits of v, two bits per plane i: bit 2i the
// digit is non-zero, bit 2i + 1 it is negative.
__device__ unsigned digit_bits(int v) {
  unsigned bits = 0;
  for (int i = 0; i < kMaxPlanes; ++i) {
    int d = v % 3;                   // -2 .. 2, with v's sign
    if (d > 1) d -= 3;
    if (d < -1) d += 3;
    bits |= (d != 0 ? 1u : 0u) << (2 * i);
    bits |= (d < 0 ? 1u : 0u) << (2 * i + 1);
    v = (v - d) / 3;                 // exact
  }
  return bits;
}

// out[m, n] += sum over full groups g, planes i of x and j of w where
// x_i's 16 digits are all non-zero and w_j's are their negation, of
// 3^(i+j).  offsets (groups + 1) and entries (E, 4) list, per full group
// g, the columns n with a full weight plane: entry (n, pat0 | pat1 << 16,
// pat2 | pat3 << 16, pat4 | planes << 16), pat_j the 16-bit negative mask
// of w_j's rows when bit j of `planes` says w_j is all non-zero there.
__global__ void __launch_bounds__(kCorrThreads)
cim_correct_kernel(const int8_t* __restrict__ x,
                   const int* __restrict__ offsets,
                   const int4* __restrict__ entries, int* __restrict__ out,
                   int M, int K, int N, int xvec) {
  // the digits of every int8 code (clipped into the 5-trit range, as the
  // balanced-ternary planes are), by its byte
  __shared__ unsigned short digits[256];
  for (int t = threadIdx.x; t < 256; t += kCorrThreads)
    digits[t] = static_cast<unsigned short>(digit_bits(
        max(-kTritRange, min(kTritRange, static_cast<int>(
            static_cast<int8_t>(t))))));
  __syncthreads();

  const int groups = K / kRows;                  // full groups only
  const long long item =
      static_cast<long long>(blockIdx.x) * kCorrThreads + threadIdx.x;
  int m = 0, g = 0;
  unsigned full = 0, pat[kMaxPlanes] = {0, 0, 0, 0, 0};
  if (item < static_cast<long long>(M) * groups) {
    m = static_cast<int>(item / groups);
    g = static_cast<int>(item % groups);
    if (__ldg(offsets + g + 1) > __ldg(offsets + g)) {
      const int8_t* p = x + static_cast<size_t>(m) * K + g * kRows;
      unsigned word[4];                          // the group's 16 codes
      if (xvec) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        word[0] = v.x; word[1] = v.y; word[2] = v.z; word[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          word[q] = load_word(p + 4 * q, 4, false);
      }
      unsigned nz[kMaxPlanes] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const unsigned b = digits[(word[r / 4] >> (8 * (r % 4))) & 0xffu];
#pragma unroll
        for (int i = 0; i < kMaxPlanes; ++i) {
          nz[i] |= ((b >> (2 * i)) & 1u) << r;
          pat[i] |= ((b >> (2 * i + 1)) & 1u) << r;
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxPlanes; ++i)
        if (nz[i] == 0xffffu) full |= 1u << i;
    }
  }

  // The warp takes its flagged (m, g) one by one, its lanes across the
  // group's list.
  const int lane = threadIdx.x % 32;
  unsigned live = __ballot_sync(0xffffffffu, full != 0);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    const int sm = __shfl_sync(0xffffffffu, m, src);
    const int sg = __shfl_sync(0xffffffffu, g, src);
    const unsigned sfull = __shfl_sync(0xffffffffu, full, src);
    unsigned want[kMaxPlanes];                   // w_j's pattern to match
#pragma unroll
    for (int i = 0; i < kMaxPlanes; ++i)
      want[i] = ~__shfl_sync(0xffffffffu, pat[i], src) & 0xffffu;
    const int e1 = __ldg(offsets + sg + 1);
    for (int e = __ldg(offsets + sg) + lane; e < e1; e += 32) {
      const int4 en = __ldg(entries + e);
      const unsigned wfull = static_cast<unsigned>(en.w) >> 16;
      const unsigned wp[kMaxPlanes] = {
          static_cast<unsigned>(en.y) & 0xffffu,
          static_cast<unsigned>(en.y) >> 16,
          static_cast<unsigned>(en.z) & 0xffffu,
          static_cast<unsigned>(en.z) >> 16,
          static_cast<unsigned>(en.w) & 0xffffu};
      int add = 0;
#pragma unroll
      for (int i = 0; i < kMaxPlanes; ++i)
#pragma unroll
        for (int j = 0; j < kMaxPlanes; ++j)
          if ((sfull >> i & 1u) && (wfull >> j & 1u) && wp[j] == want[i])
            add += kPow3[i + j];
      if (add) atomicAdd(out + static_cast<size_t>(sm) * N + en.x, add);
    }
  }
}

}  // namespace

extern "C" {

// out must be zeroed when splits > 1 (the blocks add into it).
int cim_mac_launch(const void* x, const void* w, void* out, int qi, int qw,
                   int M, int K, int N, int adc_bits, int splits,
                   int groups_per_split, int xvec, int wvec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qi < 1 || qi > kMaxPlanes || qw < 1 || qw > kMaxPlanes ||
      adc_bits < 1 || adc_bits > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cmax = (1 << adc_bits) - 1;
  if (M <= 8)
    return launch<8, 256, 8, 1>(x, w, out, qi, qw, M, K, N, cmax, splits,
                                groups_per_split, xvec, wvec, st);
  return launch<64, 64, 4, 4>(x, w, out, qi, qw, M, K, N, cmax, splits,
                              groups_per_split, xvec, wvec, st);
}

// The codes route's correction at adc_bits = 5, added into out (M, N)
// int32, which already holds the product X . W.  x: (M, K) int8 codes in
// [-121, 121]; offsets: (K / 16 + 1,) int32 and entries: (E, 4) int32,
// 16-byte aligned, the weight's full-group lists (kernels/cim_mac.py,
// full_groups); xvec: every x row starts 16-byte aligned.
int cim_correct_launch(const void* x, const void* offsets,
                       const void* entries, void* out, int M, int K, int N,
                       int xvec, void* stream) {
  if (M < 0 || K < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(M) * (K / kRows);
  if (items == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((items + kCorrThreads - 1) / kCorrThreads);
  cim_correct_kernel<<<blocks, kCorrThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(offsets),
      static_cast<const int4*>(entries), static_cast<int*>(out), M, K, N,
      xvec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
