// Paged-attention decode read for Hopper (sm_90a): the flash statistics of
// each slot's grouped queries against that slot's KV context, read straight
// off the shared page pool through the slot's page table.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/paged_attention.py (`paged_attention`).  It computes
// what the gather oracle `paged_attention_ref` computes:
//
//   s[t]  = q . k[t]                     (f32; q pre-scaled by 1/sqrt(hd))
//   s[t]  = -1e30 where t >= pos[slot]    (set, not added)
//   m     = max_t s[t]
//   l     = sum_t exp(s[t] - m)
//   acc   = sum_t exp(s[t] - m) * v[t]
//
// over the W * page_size context positions of the slot, unnormalised, so
// the caller can merge in the fresh token's own k/v (two-block rule).
// Every window is walked, live or not: a slot with pos = 0 reports
// m = -1e30, l = W * page_size and acc = the sum of every V row its table
// names (null-page garbage included), as the oracle does; the caller's
// merge weighs that block by exp(-1e30 - s_new) = 0.
//
// Layout: q (S, KV, rep, hd); k/v pages (P, page_size, KV, hd), so the
// page_size rows of one KV head are strided by KV * hd elements;
// page_table (S, W) int32; pos (S,) int32; outputs acc (S, KV, rep, hd),
// m and l (S, KV, rep), all f32.
//
// Design.  One block of 512 threads per (slot, KV head).  The TPU kernel
// walks its (slot, window) grid in order on one core and carries the
// online-softmax state in VMEM scratch; here a loop inside the block takes
// the place of the sequential grid axis, over groups of G windows (G pages
// whose K and V tiles fit in shared memory together, G <= 4, chosen by the
// wrapper), and the state stays in registers (acc: each thread owns up to
// 2 of the rep x hd lanes for every `parts`-th position) and shared memory
// (m, l per query row).  The
// block copies its page-table row to shared memory once (there is no
// scalar prefetch on Hopper); per group it loads the G pages' K and V rows
// of its head with 16-byte loads, issued together, and the rep grouped
// queries of the head share each load.  Scores: four lanes per (query,
// position) pair, each an f32 dot over a quarter of hd read from shared
// memory in an order rotated by the position (the warp hits distinct
// banks), added by two shuffles.  The softmax update runs one warp per
// query row; the acc update walks each part's positions with the
// thread's lanes interleaved.  16 warps a block keep each SM's four
// schedulers fed while one warp waits on shared or global memory.
//
// Bound: the K/V bytes it reads (decode attention does ~1 multiply-add per
// byte).  At the serve shape (8 slots x 8 KV heads) 64 blocks leave most
// of the 132 SMs idle, and each group's load waits for the previous
// group's compute.  Splitting the windows across blocks with a merge pass
// (flash-decoding), cp.async/TMA double-buffering, and skipping windows at
// or past pos are the work of a later change.
//
// C interface (loaded with ctypes): pa_launch(...) returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAccPerThread = 2;      // rep * hd <= kThreads * 2 = 1024
constexpr int kDotParts = 4;          // threads sharing one score's dot
constexpr int kLoadsInFlight = 4;     // K (and V) loads a thread issues
                                      // before it stores any of them
constexpr float kNegInf = -1e30f;     // the reference's masking constant

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy `count` units of type U (16-byte vectors, or single elements) of
// the group's K and V rows into shared memory.  Unit i belongs to
// position i / units_per_row; each thread issues up to kLoadsInFlight
// loads of K and of V before it stores any, so their latencies overlap.
template <typename U, typename T>
__device__ __forceinline__ void load_group(
    U* __restrict__ ks, U* __restrict__ vs, const T* __restrict__ k_head,
    const T* __restrict__ v_head, const int* __restrict__ table, int w0,
    int count, int units_per_row, int elems_per_unit, int ps,
    size_t row_stride, size_t page_stride) {
  for (int base = 0; base < count; base += kThreads * kLoadsInFlight) {
    U kr[kLoadsInFlight];
    U vr[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < count) {
        const int t = i / units_per_row;
        const int c = (i - t * units_per_row) * elems_per_unit;
        const int j = t / ps;
        const size_t off = (size_t)table[w0 + j] * page_stride +
                           (size_t)(t - j * ps) * row_stride + c;
        kr[u] = *reinterpret_cast<const U*>(k_head + off);
        vr[u] = *reinterpret_cast<const U*>(v_head + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < count) {
        ks[i] = kr[u];
        vs[i] = vr[u];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ pos,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int num_pages, int kvh,
                       int rep, int hd, int ps, int windows, int group,
                       int vec) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rh = rep * hd;
  const int gpos = group * ps;      // positions in a full group

  // shared: K tile, V tile (group x ps x hd each, 16-byte aligned when
  // vec), then the f32 queries, scores / probabilities, the per-row
  // state, the parts' partial acc and the page-table row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + gpos * hd;
  float* qs = reinterpret_cast<float*>(vs + gpos * hd);
  float* sc = qs + rh;              // rep x gpos
  float* m_run = sc + rep * gpos;   // rep
  float* l_run = m_run + rep;       // rep
  float* corr = l_run + rep;        // rep
  float* part_acc = corr + rep;     // kThreads x kAccPerThread
  int* table = reinterpret_cast<int*>(part_acc + kThreads * kAccPerThread);

  const size_t head = (size_t)s * kvh + h;
  for (int i = tid; i < rh; i += kThreads) qs[i] = to_f32(q[head * rh + i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int w = tid; w < windows; w += kThreads) {
    // a memory-safety guard: the allocator never hands out ids outside
    // the pool, and JAX's gather clamps them the same way
    table[w] = min(max(page_table[(size_t)s * windows + w], 0),
                   num_pages - 1);
  }

  // acc ownership: the rep x hd lanes are covered `parts` times over
  // (parts = kThreads / lanes when they fit), each part summing every
  // parts-th position; the parts are added in order at the end
  const int span = min(rh, kThreads);
  const int parts = kThreads / span;
  const int part = tid / span;
  float acc[kAccPerThread];
  int own_r[kAccPerThread];
  int own_d[kAccPerThread];
  bool own[kAccPerThread];
#pragma unroll
  for (int k = 0; k < kAccPerThread; ++k) {
    const int idx = tid - part * span + k * kThreads;
    own[k] = part < parts && idx < rh;
    own_r[k] = idx / hd;
    own_d[k] = idx - own_r[k] * hd;
    acc[k] = 0.f;
  }

  const int live = pos[s];
  const size_t row_stride = (size_t)kvh * hd;
  const size_t page_stride = (size_t)ps * row_stride;
  const T* k_head = k_pages + (size_t)h * hd;
  const T* v_head = v_pages + (size_t)h * hd;
  const int dpart = lane % kDotParts;
  const int dcount = (hd - dpart + kDotParts - 1) / kDotParts;

  for (int w0 = 0; w0 < windows; w0 += group) {
    const int npos = min(group, windows - w0) * ps;
    __syncthreads();  // the previous group is done with ks, vs and sc
    if (vec) {
      constexpr int kElems = 16 / sizeof(T);
      load_group(reinterpret_cast<uint4*>(ks), reinterpret_cast<uint4*>(vs),
                 k_head, v_head, table, w0, npos * (hd / kElems),
                 hd / kElems, kElems, ps, row_stride, page_stride);
    } else {
      load_group(ks, vs, k_head, v_head, table, w0, npos * hd, hd, 1, ps,
                 row_stride, page_stride);
    }
    __syncthreads();
    // scores: kDotParts neighbouring lanes per (query row, position), each
    // summing every kDotParts-th lane of hd, starting at a lane rotated by
    // the position so the warp hits distinct banks; two shuffles add the
    // parts.  The loop runs warp-uniformly, so every lane shuffles.
    constexpr int kPairsPerWarp = 32 / kDotParts;
    for (int base = warp * kPairsPerWarp; base < rep * npos;
         base += kWarps * kPairsPerWarp) {
      const int pr = base + lane / kDotParts;
      float dot = 0.f;
      int r = 0, t = 0;
      if (pr < rep * npos) {
        r = pr / npos;
        t = pr - r * npos;
        const float* qr = qs + r * hd;
        const T* kt = ks + t * hd;
        int j = dcount ? t % dcount : 0;
        for (int i = 0; i < dcount; ++i) {
          const int d = dpart + kDotParts * j;
          dot += qr[d] * to_f32(kt[d]);
          j = (j + 1 == dcount) ? 0 : j + 1;
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (pr < rep * npos && dpart == 0)
        sc[r * gpos + t] = (w0 * ps + t < live) ? dot : kNegInf;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < npos; t += 32) mx = fmaxf(mx, sc[r * gpos + t]);
      mx = warp_max(mx);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < npos; t += 32) {
        const float e = expf(sc[r * gpos + t] - m_new);
        sc[r * gpos + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);  // 0 on the first group
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    // acc: this part's positions, each thread's lanes interleaved
#pragma unroll
    for (int k = 0; k < kAccPerThread; ++k)
      if (own[k]) acc[k] *= corr[own_r[k]];
    for (int t = part < parts ? part : npos; t < npos; t += parts) {
#pragma unroll
      for (int k = 0; k < kAccPerThread; ++k)
        if (own[k])
          acc[k] += sc[own_r[k] * gpos + t] * to_f32(vs[t * hd + own_d[k]]);
    }
  }
#pragma unroll
  for (int k = 0; k < kAccPerThread; ++k)
    if (own[k]) part_acc[part * rh + own_r[k] * hd + own_d[k]] = acc[k];
  __syncthreads();
  for (int idx = tid; idx < rh; idx += kThreads) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a += part_acc[p * rh + idx];
    acc_out[head * rh + idx] = a;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_out[head * rep + r] = m_run[r];
    l_out[head * rep + r] = l_run[r];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* page_table, const void* pos, void* acc,
                   void* m, void* l, int slots, int num_pages, int kvh,
                   int rep, int hd, int ps, int windows, int group, int vec,
                   size_t smem, cudaStream_t stream) {
  const dim3 grid(slots, kvh);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), num_pages, kvh, rep,
      hd, ps, windows, group, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for groups of `group` windows; the
// wrapper picks the largest group (up to 4) within the 48 KB a block may
// take without opting in.
size_t pa_smem_bytes(int rep, int hd, int ps, int windows, int group,
                     int elem_bytes) {
  return (size_t)2 * group * ps * hd * elem_bytes +
         sizeof(float) * ((size_t)rep * hd + (size_t)rep * group * ps +
                          3 * rep + kThreads * kAccPerThread) +
         sizeof(int) * (size_t)windows;
}

int pa_launch(const void* q, const void* k_pages, const void* v_pages,
              const void* page_table, const void* pos, void* acc, void* m,
              void* l, int slots, int num_pages, int kvh, int rep, int hd,
              int ps, int windows, int group, int is_bf16, int vec,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      pa_smem_bytes(rep, hd, ps, windows, group, is_bf16 ? 2 : 4);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, pos, acc,
                                 m, l, slots, num_pages, kvh, rep, hd, ps,
                                 windows, group, vec, smem, st);
  return launch<float>(q, k_pages, v_pages, page_table, pos, acc, m, l,
                       slots, num_pages, kvh, rep, hd, ps, windows, group,
                       vec, smem, st);
}

}  // extern "C"
