// Counter-based random bits for Hopper (sm_90a): threefry2x32 in jax's
// partitionable layout, with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/build.py).
//
// Not a port of a Pallas kernel: it is the counterpart of XLA's lowering
// of jax.random's threefry2x32 (jax/_src/prng.py, threefry_random_bits
// with jax_threefry_partitionable on), which the reference's fault
// campaigns draw every channel from (src/repro/faults/model.py,
// faults/scrub.py).  Its oracle is threefry_bits_torch in
// src/repro_torch/core/prng.py, bit for bit.
//
//   out[r, c] = y0 ^ y1,   (y0, y1) = threefry2x32((k0, k1), (hi, lo))
//   where idx = base + r * row_stride + c, hi = idx >> 32, lo = idx
//
// so element values depend on the flat index only, and a piece of a draw
// (one layer's slice of a stacked weight, one column range) equals the
// same elements of the whole draw.
//
// Bound: the integer operations.  One element is 20 rounds of (add,
// rotate, xor) plus the key injections, ~73 int32 operations, against
// 4 bytes written: at 64 int32 lanes an SM a clock the ALUs take ~3.6x
// longer than HBM.  The rotate is one funnel shift; each thread keeps
// its counters in registers and writes one word, neighbouring threads
// neighbouring words.  A grid-stride loop covers any number of columns
// (a leaf of 10^9 elements is one launch) and blockIdx.y the rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(uint32_t k0, uint32_t k1, uint64_t base, int64_t rows,
                     int64_t row_stride, int64_t cols,
                     uint32_t* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint64_t row_base = base + static_cast<uint64_t>(r * row_stride);
    uint32_t* row_out = out + r * cols;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         c < cols; c += static_cast<int64_t>(gridDim.x) * kThreads) {
      const uint64_t idx = row_base + static_cast<uint64_t>(c);
      uint32_t x0 = static_cast<uint32_t>(idx >> 32) + k0;
      uint32_t x1 = static_cast<uint32_t>(idx) + k1;
      four_rounds<13, 15, 26, 6>(x0, x1);
      x0 += k1; x1 += k2 + 1u;
      four_rounds<17, 29, 16, 24>(x0, x1);
      x0 += k2; x1 += k0 + 2u;
      four_rounds<13, 15, 26, 6>(x0, x1);
      x0 += k0; x1 += k1 + 3u;
      four_rounds<17, 29, 16, 24>(x0, x1);
      x0 += k1; x1 += k2 + 4u;
      four_rounds<13, 15, 26, 6>(x0, x1);
      x0 += k2; x1 += k0 + 5u;
      row_out[c] = x0 ^ x1;
    }
  }
}

}  // namespace

extern "C" {

// out: rows * cols uint32 words, row-major.  Returns a cudaError_t.
int threefry_bits_launch(uint32_t k0, uint32_t k1, uint64_t base,
                         int64_t rows, int64_t row_stride, int64_t cols,
                         void* out, void* stream) {
  if (rows < 1 || cols < 1 || row_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t col_blocks = (cols + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(col_blocks < (1 << 20)
                                            ? col_blocks : (1 << 20)),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  threefry_bits_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, base, rows, row_stride, cols, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
