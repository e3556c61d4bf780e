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
// the caller can merge in the fresh token's own k/v (two-block rule).  A
// slot with pos = 0 reports m = -1e30, l = W * page_size and acc = the
// sum of every V row its table names (null-page garbage included), as the
// oracle does; the caller's merge weighs that block by exp(-1e30 - s_new)
// = 0.  So for pos = 0 every window is still walked (mostly the null
// page, an L2 hit).
//
// Layout: q (S, KV, rep, hd); k/v pages (P, page_size, KV, hd), so the
// page_size rows of one KV head are strided by KV * hd elements;
// page_table (S, W) int32; pos (S,) int32; outputs acc (S, KV, rep, hd),
// m and l (S, KV, rep), all f32.
//
// What bounds it: the live K/V bytes.  Decode attention does about one
// multiply-add per byte read at rep <= 16, so tensor cores buy nothing;
// the arithmetic runs on CUDA cores in f32.  The TPU kernel walks a
// (slot, window) grid in order on one core; a port that gives each
// (slot, KV head) one block leaves most SMs idle at decode batch sizes
// (8 x 8 = 64 blocks on 132 SMs) and waits on every page it loads.  The
// design, point by point:
//
// 1. Split the windows across a thread-block cluster.  The grid is
//    (split, KV head, slot), launched as clusters of (splits, 1, 1), 1-8
//    ranks (`paged_plan` in kernels/paged_attention.py picks it so the
//    grid fills the SMs).  Rank z takes windows [z * per_rank, (z + 1) *
//    per_rank) and folds them into partial statistics (m, l, acc) with the
//    online softmax.  After one cluster barrier every rank merges a slice
//    of the rep x hd lanes, reading each live rank's partial through
//    distributed shared memory in rank order (m = max, l and acc rescaled
//    by exp(m_z - m) and added in rank order), so a call is one launch
//    and two calls agree bitwise; a second barrier keeps every block
//    resident until its partial has been read.
// 2. Skip dead windows.  With pos > 0 a window whose first position is at
//    or past pos is never loaded, and a rank whose whole range is dead
//    computes nothing: the merge leaves it out, which is what its empty
//    partial (m = -inf, l = 0, acc = 0) would add.  This is exact: once a
//    live key sets m, the oracle's masked terms are exp(-1e30 - m) = 0.0
//    in f32, so skipping changes only the order of the sum.  Rank 0
//    always holds window 0, which is live when pos > 0, so the merge never
//    forms -inf - (-inf).
// 3. Keep page loads in flight.  Each rank copies its range of the page
//    table into shared memory once.  Where a head's page rows are 16-byte
//    aligned (route `tma`), one thread streams the rank's windows through
//    a ring of 2-4 stages by the TMA: one 3-D tensor map per pool over
//    (P, page_size, KV * hd), box (1, page_size, hd) at (page, 0, h * hd),
//    K and V of a window landing on the stage's mbarrier; a stage is
//    refilled as soon as every warp is done with it, so `stages` windows
//    are in flight while one is computed.  Elsewhere (route `loads`) the
//    block copies each window with plain loads before computing it.
// 4. Compute on CUDA cores in f32, in registers, with no block barrier
//    inside a window.  A warp carries RC = 1, 2, 4 or 8 grouped queries
//    (q in registers) and takes every wpc-th step of NP = 8 / RC
//    positions of each window; ceil(rep / RC) x wpc warps (up to 8) cover
//    the block.  A lane takes 8 elements of a row at most (d = lane + 32 j,
//    so hd <= 256).  A step's RC x NP = 8 dot products are added across
//    the warp in one transposing reduction (9 shuffles, 5 deep, instead of
//    40 for 8 plain ones), after which each group of 4 lanes holds one
//    score; the step's row maxima, exponentials and sums are shuffles too,
//    and each warp keeps its own running softmax and its RC x hd
//    accumulator in registers, so the setup's loads (q, pos and the page
//    ids, issued together) are the only other chain of latencies before
//    the first page.  rep x hd is not capped by a block's lanes: rep <= 64
//    (glm4-9b's 16 x 128 included).  At the end the warps' partials are
//    merged in warp order, then the ranks'.
//
// C interface (loaded with ctypes): pa_launch(...) returns the launch's
// error, 0 on success; pa_smem_bytes(...) the dynamic shared bytes a block
// takes, as `smem_bytes` in the wrapper computes them.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxHeadDim = 256;      // 8 elements a lane
constexpr int kScores = 8;            // scores a warp step reduces at once
constexpr int kMaxWpc = 4;            // warps sharing a row group
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 227 * 1024;
constexpr float kNegInf = -1e30f;     // the reference's masking constant
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
      "PA_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra PA_DONE;\n"
      "bra PA_WAIT;\n"
      "PA_DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// The box of `map` at (c0, c1, c2) into shared memory by the TMA, counted
// on the mbarrier at `bar` when it lands.
__device__ __forceinline__ void tma_box3(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sums over the warp of RC values per lane (v[r] is the lane's share
// of value r): halving steps swap half the values with the lane `o` away,
// so after log2(RC) of them each lane holds one value, value lane / (32 /
// RC), summed over 2^steps lanes; plain steps add the rest.  Every lane of
// a value's group returns that value's full sum.
template <int RC>
__device__ __forceinline__ float rows_sum(float (&v)[RC], int lane) {
  constexpr int kSteps = RC == 8 ? 3 : RC == 4 ? 2 : RC == 2 ? 1 : 0;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int half = RC >> (step + 1), o = 16 >> step;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? v[k] : v[k + half];
      const float keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = 16 / RC; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__host__ __device__ inline size_t up128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Byte offsets of a block's shared memory (from a 128-byte aligned base):
// the ring of K and V tiles, reused after the windows for the warps'
// partials and then the rank's partial; the rank's page ids; one
// mbarrier per stage.
struct Layout {
  size_t tile, rank_part, table, bars, total;
};

__host__ __device__ inline Layout layout(int rep, int hd, int ps,
                                         int per_rank, int rows, int warps,
                                         int stages, int elem) {
  Layout L;
  L.tile = up128(static_cast<size_t>(ps) * hd * elem);
  const size_t ring = static_cast<size_t>(stages) * 2 * L.tile;
  L.rank_part = up128(static_cast<size_t>(warps) * rows * (hd + 2) * 4);
  const size_t parts =
      L.rank_part + up128((static_cast<size_t>(rep) * hd + 2 * rep) * 4);
  L.table = ring > parts ? ring : parts;
  L.bars = L.table + up128(static_cast<size_t>(per_rank) * 4);
  L.total = L.bars + 8 * static_cast<size_t>(stages) + 128;
  return L;
}

// grid (splits, KV, slots), clusters of (splits, 1, 1); 32 * warps
// threads.  Warp w carries rows [(w / wpc) * RC, +RC) of the grouped
// queries; a window's positions go in steps of NP = 8 / RC, and the warp
// takes steps w % wpc (mod wpc), so a step's RC x NP = 8 scores are one
// transposing reduction: lane group vi = lane / 4 ends up with the score
// of row vi / NP at position vi % NP of the step.
template <typename T, int RC, int JM>
__global__ void __launch_bounds__(kMaxThreads)
paged_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ pos,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int num_pages, int kvh,
                       int rep, int hd, int ps, int windows, int per_rank,
                       int wpc, int stages, int tma) {
  constexpr int NP = kScores / RC;      // positions a step
  const int rank = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int sub = warp % wpc, r0 = (warp / wpc) * RC;
  const int my_r = (lane >> 2) / NP, my_p = (lane >> 2) % NP;
  const int steps = (ps + NP - 1) / NP;            // >= wpc
  const Layout L = layout(rep, hd, ps, per_rank, RC, warps, stages,
                          sizeof(T));
  extern __shared__ __align__(16) uint8_t dyn[];
  uint8_t* base = dyn + ((128 - (smem_u32(dyn) & 127)) & 127);
  T* ring = reinterpret_cast<T*>(base);
  float* wpart = reinterpret_cast<float*>(base);
  float* rpart = reinterpret_cast<float*>(base + L.rank_part);
  int* table = reinterpret_cast<int*>(base + L.table);
  const uint32_t bars = smem_u32(base + L.bars);
  const size_t tile_elems = L.tile / sizeof(T);
  const size_t head = static_cast<size_t>(s) * kvh + h;
  const int rh = rep * hd;

  // q, pos and the rank's page ids are loaded together, none waiting on
  // another.  Loads here and below are unconditional, from indices
  // clamped into range, and a select drops what lies outside: a load
  // under a condition becomes a branch that waits for it, one at a time.
  float qr[RC][JM];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      const int d = lane + 32 * j;
      const float x = to_f32(q[(head * rep + min(r0 + r, rep - 1)) * hd
                               + min(d, hd - 1)]);
      qr[r][j] = (r0 + r < rep && d < hd) ? x : 0.f;
    }
  const int live = pos[s];
  const int w0 = rank * per_rank;
  const int w1 = min(windows, w0 + per_rank);
  for (int j = tid; j < w1 - w0; j += blockDim.x) {
    // a memory-safety guard: the allocator never hands out ids outside
    // the pool, and JAX's gather clamps them the same way
    table[j] = min(max(page_table[static_cast<size_t>(s) * windows + w0
                                  + j], 0), num_pages - 1);
  }
  if (tma && tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the windows this rank loads: its range, cut at pos when pos > 0
  const int nlive = live > 0 ? min(windows, (live - 1) / ps + 1) : windows;
  const int n = max(0, min(w1, nlive) - w0);
  __syncthreads();

  if (n > 0) {
    float acc[RC][JM];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < JM; ++j) acc[r][j] = 0.f;
    float m_row = -INFINITY, l_row = 0.f;    // row my_r's statistics
    int dcol[JM];                             // this lane's columns
#pragma unroll
    for (int j = 0; j < JM; ++j) dcol[j] = min(lane + 32 * j, hd - 1);

    const size_t row_stride = static_cast<size_t>(kvh) * hd;
    const size_t page_stride = static_cast<size_t>(ps) * row_stride;
    const T* k_head = k_pages + static_cast<size_t>(h) * hd;
    const T* v_head = v_pages + static_cast<size_t>(h) * hd;
    const uint32_t box_bytes = static_cast<uint32_t>(ps) * hd * sizeof(T);
    // window i of the range into stage i % stages (one thread)
    auto issue = [&](int i) {
      const int st = i % stages;
      const uint32_t bar = bars + 8 * st;
      const uint32_t dst = smem_u32(ring) + st * 2 * L.tile;
      mbar_expect_tx(bar, 2 * box_bytes);
      tma_box3(dst, &kmap, h * hd, 0, table[i], bar);
      tma_box3(dst + L.tile, &vmap, h * hd, 0, table[i], bar);
    };
    if (tma && tid == 0)
      for (int i = 0; i < min(stages, n); ++i) issue(i);

    for (int i = 0; i < n; ++i) {
      const int st = tma ? i % stages : 0;
      const T* ks = ring + st * 2 * tile_elems;
      const T* vs = ks + tile_elems;
      if (tma) {
        mbar_wait(bars + 8 * st, (i / stages) & 1);
      } else {
        T* kd = ring;
        T* vd = ring + tile_elems;
        const size_t pg = static_cast<size_t>(table[i]) * page_stride;
        for (int e = tid; e < ps * hd; e += blockDim.x) {
          const int t = e / hd, d = e - t * hd;
          const size_t off = pg + t * row_stride + d;
          kd[e] = k_head[off];
          vd[e] = v_head[off];
        }
        __syncthreads();
      }
      const int g0 = (w0 + i) * ps;    // context position of row 0
      for (int step = sub; step < steps; step += wpc) {
        const int t0 = step * NP;
        // rows past the page read its last row and lanes past hd its last
        // column; the score and q's zeros discard them
        int trow[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) trow[p] = min(t0 + p, ps - 1) * hd;
        float kr[NP][JM];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < JM; ++j) kr[p][j] = to_f32(ks[trow[p] + dcol[j]]);
        float part[kScores];
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < JM; ++j) a = fmaf(qr[r][j], kr[p][j], a);
            part[r * NP + p] = a;
          }
        float sc = rows_sum<kScores>(part, lane);
        const int t = t0 + my_p;
        // past the page: no position (0 in l); at or past pos: -1e30
        sc = t >= ps ? -INFINITY : g0 + t < live ? sc : kNegInf;
        // the running softmax of row my_r over the step's positions,
        // which sit in the lane groups 4 * (my_r * NP + p)
        float mx = sc;
#pragma unroll
        for (int o = 4; o < 4 * NP; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m_row, mx);
        const float corr = expf(m_row - m_new);    // 0 on the first step
        const float pv = expf(sc - m_new);
        float sum = pv;
#pragma unroll
        for (int o = 4; o < 4 * NP; o <<= 1)
          sum += __shfl_xor_sync(kFull, sum, o);
        l_row = l_row * corr + sum;
        m_row = m_new;
        // acc: every row's rescale, then the step's V rows
        float vr[NP][JM];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < JM; ++j) vr[p][j] = to_f32(vs[trow[p] + dcol[j]]);
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const float c = __shfl_sync(kFull, corr, 4 * r * NP);
#pragma unroll
          for (int j = 0; j < JM; ++j) acc[r][j] *= c;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const float pr = __shfl_sync(kFull, pv, 4 * (r * NP + p));
#pragma unroll
            for (int j = 0; j < JM; ++j)
              acc[r][j] = fmaf(pr, vr[p][j], acc[r][j]);
          }
        }
      }
      __syncthreads();   // every warp is done with stage st
      if (tma && tid == 0 && i + stages < n) issue(i + stages);
    }

    // the ring is free: each warp's partial, [row][hd] acc then m and l
    float* wp = wpart + warp * RC * (hd + 2);
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < JM; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) wp[r * hd + d] = acc[r][j];
      }
    if ((lane & (4 * NP - 1)) == 0) {
      wp[RC * hd + my_r] = m_row;
      wp[RC * hd + RC + my_r] = l_row;
    }
    __syncthreads();
    // the rank's partial: the warps of each row group in warp order
    float* dst_acc = splits == 1 ? acc_out + head * rh : rpart;
    float* dst_m = splits == 1 ? m_out + head * rep : rpart + rh;
    float* dst_l = splits == 1 ? l_out + head * rep : rpart + rh + rep;
    for (int idx = tid; idx < rh; idx += blockDim.x) {
      const int r = idx / hd, d = idx - r * hd;
      const float* w = wpart + (r / RC) * wpc * RC * (hd + 2);
      const int rr = r % RC;
      float mu[kMaxWpc], lu[kMaxWpc], au[kMaxWpc];
#pragma unroll
      for (int u = 0; u < kMaxWpc; ++u) {
        const float* wu = w + min(u, wpc - 1) * RC * (hd + 2);
        const float mv = wu[RC * hd + rr], lv = wu[RC * hd + RC + rr],
                    av = wu[rr * hd + d];
        mu[u] = u < wpc ? mv : -INFINITY;
        lu[u] = u < wpc ? lv : 0.f;
        au[u] = u < wpc ? av : 0.f;
      }
      float m = mu[0];
#pragma unroll
      for (int u = 1; u < kMaxWpc; ++u) m = fmaxf(m, mu[u]);
      float a = 0.f, lsum = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxWpc; ++u)
        if (u < wpc) {
          const float e = expf(mu[u] - m);
          a += au[u] * e;
          lsum += lu[u] * e;
        }
      dst_acc[idx] = a;
      if (d == 0) {
        dst_m[r] = m;
        dst_l[r] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // the cluster's merge: this rank's slice of the lanes, over the live
  // ranks' partials in rank order
  cluster_arrive_release();
  cluster_wait();                       // every partial has landed
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks_live = min(splits, (nlive + per_rank - 1) / per_rank);
  const int slice = (rh + splits - 1) / splits;
  const int end = min(rh, (rank + 1) * slice);
  for (int idx = rank * slice + tid; idx < end; idx += blockDim.x) {
    const int r = idx / hd;
    float mz[kMaxCluster], lz[kMaxCluster], az[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      const float* p = cluster.map_shared_rank(rpart,
                                               min(z, ranks_live - 1));
      const float mv = p[rh + r], lv = p[rh + rep + r], av = p[idx];
      mz[z] = z < ranks_live ? mv : -INFINITY;
      lz[z] = z < ranks_live ? lv : 0.f;
      az[z] = z < ranks_live ? av : 0.f;
    }
    float m = mz[0];
#pragma unroll
    for (int z = 1; z < kMaxCluster; ++z) m = fmaxf(m, mz[z]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z)
      if (z < ranks_live) {
        const float e = expf(mz[z] - m);
        a += az[z] * e;
        lsum += lz[z] * e;
      }
    acc_out[head * rh + idx] = a;
    if (idx - r * hd == 0) {
      m_out[head * rep + r] = m;
      l_out[head * rep + r] = lsum;
    }
  }
  cluster_arrive_release();
  cluster_wait();                       // no partial is read any more
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

// A page pool (P, ps, KV * hd) read in boxes of one page's ps rows of one
// head's hd elements.
cudaError_t page_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int elem, int pages, int ps,
                     int kvh, int hd) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(kvh) * hd;
  const cuuint64_t dim[3] = {row, static_cast<cuuint64_t>(ps),
                             static_cast<cuuint64_t>(pages)};
  const cuuint64_t stride[2] = {row * elem, row * elem * ps};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(hd),
                             static_cast<cuuint32_t>(ps), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dim, stride, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v, *table, *pos;
  void *acc, *m, *l;
  int slots, pages, kvh, rep, hd, ps, windows, splits, per_rank, wpc,
      stages, tma;
  size_t smem;
  cudaStream_t stream;
};

// Lets paged_attention_kernel<T, RC, JM> take up to kSmemLimit bytes of
// dynamic shared memory on the current device: one driver call per
// device, and only for plans above the default 48 KB.
template <typename T, int RC, int JM>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_attention_kernel<T, RC, JM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int RC, int JM>
cudaError_t launch(const Args& a) {
  cudaError_t err = allow_smem<T, RC, JM>(a.smem);
  if (err != cudaSuccess) return err;
  CUtensorMap kmap = {}, vmap = {};
  if (a.tma) {
    const CUtensorMapDataType type = sizeof(T) == 2
        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    err = page_map(&kmap, type, a.k, sizeof(T), a.pages, a.ps, a.kvh, a.hd);
    if (err != cudaSuccess) return err;
    err = page_map(&vmap, type, a.v, sizeof(T), a.pages, a.ps, a.kvh, a.hd);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (a.rep + RC - 1) / RC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kvh, a.slots);
  cfg.blockDim = dim3(32 * chunks * a.wpc);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<T, RC, JM>, kmap, vmap,
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.table),
      static_cast<const int*>(a.pos), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.pages, a.kvh,
      a.rep, a.hd, a.ps, a.windows, a.per_rank, a.wpc, a.stages, a.tma);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Args& a, int rows) {
  const bool wide = a.hd > 128;
  switch (rows) {
    case 1: return wide ? launch<T, 1, 8>(a) : launch<T, 1, 4>(a);
    case 2: return wide ? launch<T, 2, 8>(a) : launch<T, 2, 4>(a);
    case 4: return wide ? launch<T, 4, 8>(a) : launch<T, 4, 4>(a);
    case 8: return wide ? launch<T, 8, 8>(a) : launch<T, 8, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

int rows_of(int rep) {
  int rows = 1;
  while (rows < rep && rows < 8) rows *= 2;
  return rows;
}

}  // namespace

extern "C" {

// Dynamic shared bytes of a block (`smem_bytes` in the wrapper).
size_t pa_smem_bytes(int rep, int hd, int ps, int per_rank, int rows,
                     int warps, int stages, int elem_bytes) {
  return layout(rep, hd, ps, per_rank, rows, warps, stages, elem_bytes)
      .total;
}

int pa_launch(const void* q, const void* k_pages, const void* v_pages,
              const void* page_table, const void* pos, void* acc, void* m,
              void* l, int slots, int num_pages, int kvh, int rep, int hd,
              int ps, int windows, int splits, int per_rank, int wpc,
              int stages, int is_bf16, int tma, void* stream) {
  const int rows = rows_of(rep);
  const int warps = (rep + rows - 1) / rows * wpc;
  const int steps = (ps + kScores / rows - 1) / (kScores / rows);
  const bool ok = slots >= 1 && num_pages >= 1 && kvh >= 1 && rep >= 1
      && hd >= 1 && hd <= kMaxHeadDim && ps >= 1 && windows >= 1
      && (splits == 1 || splits == 2 || splits == 4 || splits == 8)
      && per_rank >= 1 && (splits - 1) * per_rank < windows
      && windows <= splits * per_rank && wpc >= 1 && wpc <= kMaxWpc
      && wpc <= steps
      && warps <= kMaxThreads / 32 && stages >= 1
      && slots <= 65535 && kvh <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pages, v_pages, page_table, pos, acc, m, l, slots, num_pages,
         kvh, rep, hd, ps, windows, splits, per_rank, wpc, stages, tma,
         layout(rep, hd, ps, per_rank, rows, warps, stages,
                is_bf16 ? 2 : 4).total,
         static_cast<cudaStream_t>(stream)};
  if (a.smem > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(is_bf16 ? launch_rows<__nv_bfloat16>(a, rows)
                                  : launch_rows<float>(a, rows));
}

}  // extern "C"
