// The encoder's projection GEMM on Hopper (sm_90a): out = epilogue(A (M, K)
// · W + bias), a TMA + wgmma kernel shared by K1 (csrc/layer.cu: bf16, and
// f32 as 3xTF32) and K4 (csrc/layer_i8.cu: W8A8, s8 · s8 -> s32). Each
// includer instantiates the element types it launches (internal linkage).
//
// A CTA owns a BM x 128 output tile (BM = 64 or 128: one or two consumer
// warpgroups of 64 rows each) and one producer warp. The producer keeps a
// ring of k stages filled by TMA loads under the 128-byte swizzle, each
// stage completing on an mbarrier; the consumers issue wgmma and free a
// stage (a second mbarrier) once the wgmma group that read it has retired.
// A stage holds 128 bytes of k of every row: 64 bf16, 32 f32 or 128 s8.
// Three mainloops share the ring:
//   mainloop_bf16  wgmma.m64n128k16 from shared memory; W in the
//                  reference's (in, out) layout, read MN-major through the
//                  transpose bit (two 64-column boxes a stage)
//   mainloop_tf32  3xTF32: A split in registers, wgmma.m64n128k8 with A
//                  from registers, W as prepared (N, K) (W_hi, W_lo)
//   mainloop_s8    wgmma.m64n128k32.s32.s8.s8 from shared memory; the i8
//                  weight codes prepared as (N, K), since 8-bit wgmma reads
//                  both operands K-major
// Rows past M read zeros (TMA's out-of-bounds fill) and are masked on the
// store. N need not be a multiple of 128 (K7 takes every N % 8 == 0, f32
// N % 4 == 0): the RAGGED instances' grid has ceil(N / 128) column tiles,
// W's columns past N read zeros through the same fill (a bf16 box wholly
// past N reads only zeros), and the bias, LayerNorm parameters, resid and
// the store are masked at c < N. The masks are compiled only into RAGGED
// instances, which only K7's bf16 and f32 GELU and LayerNorm launches take
// (never s8): compiled into every instance they slowed K1's and K4's GEMMs
// by 2-40% on an H100 (PERF.md §6). Tensor maps are encoded on the host at every call and passed as
// __grid_constant__ parameters, so a CUDA graph that captured a launch
// keeps valid maps. BM = 128 where 128-row tiles give the card a full
// wave (>= 132 CTAs), else 64.
//
// Epilogues: + bias (EPI_BIAS), + bias -> GELU (EPI_GELU), + bias + resid
// -> LayerNorm (EPI_LN). The LayerNorm needs whole rows: a thread-block
// cluster of ceil(N/128) CTAs spans one BM-row block; each CTA writes
// per-row partial sums of its valid columns (the last CTA's may be fewer
// than 128) to shared memory, reads every CTA's
// partials through distributed shared memory in cluster-rank order after
// a cluster barrier (so every CTA gets the same mean), then does the same
// for Σ(v − mean)² over its valid columns (the mean and the variance
// divide by N), and normalises its own columns. The cluster shape is
// checked with cudaOccupancyMaxActiveClusters and refused, never shrunk.
//
// W8A8 (T = int8_t, K4's contract): the s32 sums are dequantized as
// ((f32(acc) · rf[row]) · ws[col]) + b, each step rounded once, and the
// LayerNorm is rounded op by op as its twin's, so nvcc contracts no FMA
// the twin does not do. Three hooks carry K4's per-row activation
// quantizations (s = max(absmax, 1e-6), codes = round_half_even(v ·
// (127 / s)), rf = s · f32(1/127): quant_rows_kernel's arithmetic):
//   QOUT  (LayerNorm, q_out) the epilogue quantizes its f32 output rows:
//         the cluster holds whole rows, and their absmax is gathered
//         through distributed shared memory like the LayerNorm's sums
//   PART  (GELU, part) the epilogue leaves each row's absmax over its
//         128 columns, one f32 a (row, CTA)
//   QA    (LayerNorm, a32) a prologue quantizes the f32 A rows of its row
//         block, their absmax the max of PART's partials: each CTA of the
//         cluster reads its K / cx of the columns once and writes their
//         codes, and a generic-to-async proxy fence and a cluster barrier
//         order them before the TMA loads that read them

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BN = 128;                // GEMM output columns per CTA
constexpr int EPI_BIAS = 0;
constexpr int EPI_GELU = 1;
constexpr int EPI_LN = 2;
constexpr int ROW_BYTES = 128;         // a swizzled row: 128 bytes of k
constexpr int MAX_CLUSTER = 16;        // non-portable cluster limit
constexpr float INV127 = 1.0f / 127.0f;  // f32(1/127), as the reference folds it

// Shared memory of a BM-row CTA with A elements T: the stage ring, its full
// / empty mbarriers, the LayerNorm epilogue's per-row partials (two passes;
// s8: also the output's row absmax) and, for s8, A's row factors.
// A stage holds BM rows of A (BK of k each) and W's boxes: for bf16 the
// (in, out) matrix's two 64-column halves of BK rows (MN-major, 8 KB
// each); for f32 W_hi and W_lo, 128 rows of BK each (K-major, 16 KB each);
// for s8 the (N, K) codes, 128 rows of BK (16 KB). 1 KB of slack aligns
// the ring to the swizzle's 1024-byte atom.
template <int BM, typename T>
struct Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool I8 = sizeof(T) == 1;
  static constexpr int NC = BM / 64;               // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;    // + the producer warp
  static constexpr int BK = ROW_BYTES / sizeof(T);  // k per stage
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int W_BOX = (sizeof(T) == 2 ? 64 : BN) * ROW_BYTES;
  static constexpr int W_BOXES = I8 ? 1 : 2;
  static constexpr int STAGE = A_BYTES + W_BOXES * W_BOX;
  // bf16 and s8: 96 KB at BM = 128, so two CTAs share an SM; f32: four
  // stages (192 KB at BM = 128, 160 KB at 64): its registers (the
  // accumulator, a stage's partial sums and the A fragments) allow one CTA
  // an SM
  static constexpr int STAGES = F32 ? 4 : (BM == 128 ? 3 : 4);
  static constexpr int RED = I8 ? 4 : 2;           // BM-float slots
  static constexpr size_t bars = (size_t)STAGES * STAGE;
  static constexpr size_t red = bars + 2 * STAGES * sizeof(uint64_t);
  static constexpr size_t bytes = red + RED * BM * sizeof(float) + 1024;
};

// What a launch reads and writes besides its A and W tiles. The s8 fields
// are K4's: rf its A rows' factors (unread with QA), ws W's column scales,
// a32 / aq the f32 rows QA quantizes and their codes (map_a's matrix),
// part the (M, K / 128) partial absmax QA reads or the (M, N / 128) one
// PART writes, q_out / rf_out QOUT's codes and factors of the output rows.
struct GemmArgs {
  const float* bias;
  const void* resid;
  const float* ln_s;
  const float* ln_b;
  void* out;
  const float* rf;
  const float* ws;
  const float* a32;
  int8_t* aq;
  float* part;
  int8_t* q_out;
  float* rf_out;
  int M, N, K;
  float eps;
  int cx;                              // CTAs of the LayerNorm cluster
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// two adjacent elements as f32, and two f32 stored as T
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// (f32(acc) · row factor) · column scale + bias, each step rounded once
__device__ __forceinline__ float dequant(int acc, float rf, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rf), ws), b);
}

// v quantized with the factor r = 127 / s, rounded half to even
__device__ __forceinline__ signed char quant(float v, float r) {
  return (signed char)__float2int_rn(__fmul_rn(v, r));
}

// Σ (MAX: max) over the n CTAs of the cluster, in rank order, of the f32
// at p's offset and at p + 8 (a thread's two rows); the loads go four
// ranks at a time
template <bool MAX = false>
__device__ __forceinline__ float2 cluster_rows(const float* p, int n) {
  float2 tot = make_float2(0.0f, 0.0f);
  for (int q0 = 0; q0 < n; q0 += 4) {
    float v[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < n) {
        v[0][q] = sm90::ld_dsmem(p, q0 + q);
        v[1][q] = sm90::ld_dsmem(p + 8, q0 + q);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < n) {
        tot.x = MAX ? fmaxf(tot.x, v[0][q]) : tot.x + v[0][q];
        tot.y = MAX ? fmaxf(tot.y, v[1][q]) : tot.y + v[1][q];
      }
  }
  return tot;
}

// bf16 mainloop: both operands from shared memory, wgmma.m64n128k16 with
// W's transpose bit set; a stage is freed once the group after it has
// been issued and its own has retired
template <int BM>
__device__ __forceinline__ void mainloop_bf16(float (&acc)[64],
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int kt, int warp, int lane) {
  using L = Tile<BM, bf16>;
  const int wg = warp / 4;
  for (int t = 0; t < kt; ++t) {
    const int s = t % L::STAGES;
    sm90::mbar_wait(&full[s], (t / L::STAGES) & 1);
    const unsigned char* a = smem + s * L::STAGE + wg * 64 * ROW_BYTES;
    const unsigned char* w = smem + s * L::STAGE + L::A_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk)
      sm90::wgmma_m64n128k16_tb(acc, sm90::wgmma_desc_kmajor(a + kk * 32),
                                sm90::wgmma_desc(w + kk * 2048, L::W_BOX, 1024));
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    // the group of stage t - 1 has retired: its buffers are free
    sm90::wgmma_wait<1>();
    if (t > 0 && lane == 0) sm90::mbar_arrive(&empty[(t - 1) % L::STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// s8 mainloop: mainloop_bf16's pipeline with both operands K-major (the
// (N, K) codes), wgmma.m64n128k32 into exact s32 sums, four a stage
template <int BM>
__device__ __forceinline__ void mainloop_s8(int (&acc)[64],
                                            unsigned char* smem,
                                            uint64_t* full, uint64_t* empty,
                                            int kt, int warp, int lane) {
  using L = Tile<BM, int8_t>;
  const int wg = warp / 4;
  for (int t = 0; t < kt; ++t) {
    const int s = t % L::STAGES;
    sm90::mbar_wait(&full[s], (t / L::STAGES) & 1);
    const unsigned char* a = smem + s * L::STAGE + wg * 64 * ROW_BYTES;
    const unsigned char* w = smem + s * L::STAGE + L::A_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 32; ++kk)
      sm90::wgmma_m64n128k32_s8(acc, sm90::wgmma_desc_kmajor(a + kk * 32),
                                sm90::wgmma_desc_kmajor(w + kk * 32));
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    sm90::wgmma_wait<1>();
    if (t > 0 && lane == 0) sm90::mbar_arrive(&empty[(t - 1) % L::STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// f32 mainloop, 3xTF32: each thread loads its A fragments from the
// swizzled stage (a 16-byte chunk c of row r lies at chunk c ^ (r % 8):
// conflict-free), splits them into hi and lo in registers, and issues
// wgmma.m64n128k8 with A from registers, three a k8 step (A_lo·W_hi,
// A_hi·W_lo, A_hi·W_hi). The tensor cores round their f32 accumulation
// toward zero, a bias that grows with the number of accumulations (over K
// = 1536 it reached 1.2e-5 of the output's scale on the card): so each
// stage's 32 k accumulate into a fresh `part`, which is added to acc on
// the CUDA cores (round to nearest). The fragments are read
// asynchronously, so each stage's group retires before the stage is freed
// and its registers are reused.
template <int BM>
__device__ __forceinline__ void mainloop_tf32(float (&acc)[64],
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int kt, int warp, int lane) {
  using L = Tile<BM, float>;
  constexpr int KS = L::BK / 8;                       // k8 steps a stage
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int t4 = lane % 4;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  for (int t = 0; t < kt; ++t) {
    const int s = t % L::STAGES;
    sm90::mbar_wait(&full[s], (t / L::STAGES) & 1);
    const unsigned char* st = smem + s * L::STAGE;
    const float* a = reinterpret_cast<const float*>(st);
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // fragment register i: row r0 (+8 for odd i), k t4 (+4 for i >= 2)
        const int r = r0 + 8 * (i & 1), c = kk * 8 + t4 + 4 * (i >> 1);
        const float x = a[r * L::BK + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)];
        sm90::split_tf32(x, ah[kk][i], al[kk][i]);
      }
    const unsigned char* wh = st + L::A_BYTES;
    const unsigned char* wl = wh + L::W_BOX;
    sm90::fence_regs(part);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      sm90::wgmma_m64n128k8_tf32(part, al[kk],
                                 sm90::wgmma_desc_kmajor(wh + kk * 32),
                                 kk > 0);
      sm90::wgmma_m64n128k8_tf32(part, ah[kk],
                                 sm90::wgmma_desc_kmajor(wl + kk * 32), 1);
      sm90::wgmma_m64n128k8_tf32(part, ah[kk],
                                 sm90::wgmma_desc_kmajor(wh + kk * 32), 1);
    }
    sm90::wgmma_commit();
    sm90::fence_regs(part);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      sm90::fence_regs(ah[kk]);
      sm90::fence_regs(al[kk]);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// QA's prologue: every thread of the CTA quantizes its share of the f32
// rows of this row block into g.aq and leaves each row's factor in rfs. A
// row's absmax is the max of its K / 128 partials in g.part. CTA rank q of
// the cx-CTA cluster takes columns [q·K/cx, (q+1)·K/cx) (in fours); a warp
// takes QA_ROWS rows at a time and issues all their loads (partials, then
// each 128-column step's values, through the read-only path) before it
// uses any: the pass is bound by load latency at a B = 1 query.
constexpr int QA_ROWS = 8;

template <int BM, int THREADS>
__device__ __forceinline__ void quantize_a(const GemmArgs& g, int m0,
                                           float* rfs, int warp, int lane) {
  constexpr int NW = THREADS / 32, U = QA_ROWS;
  const int q = blockIdx.x, n4 = g.K / 4, np = g.K / 128;
  const int lo = q * n4 / g.cx * 4, hi = (q + 1) * n4 / g.cx * 4;
  const float* __restrict__ a32 = g.a32;
  const float* __restrict__ part = g.part;
  int8_t* __restrict__ aq = g.aq;
  for (int r0 = warp * U; r0 < BM; r0 += NW * U) {
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) live[u] = r0 + u < BM && m0 + r0 + u < g.M;
    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) m[u] = 0.0f;
    for (int i = lane; i < np; i += 32) {
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        p[u] = live[u] ? __ldg(part + (size_t)(m0 + r0 + u) * np + i) : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) m[u] = fmaxf(m[u], p[u]);
    }
    float rc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = fmaxf(warp_max(m[u]), 1e-6f);
      if (lane == 0 && r0 + u < BM) rfs[r0 + u] = __fmul_rn(s, INV127);
      rc[u] = __fdiv_rn(127.0f, s);
    }
    for (int c = lo + 4 * lane; c < hi; c += 128) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = live[u] ? __ldg(reinterpret_cast<const float4*>(
                             a32 + (size_t)(m0 + r0 + u) * g.K + c))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
        char4 o;
        o.x = quant(v[u].x, rc[u]);
        o.y = quant(v[u].y, rc[u]);
        o.z = quant(v[u].z, rc[u]);
        o.w = quant(v[u].w, rc[u]);
        *reinterpret_cast<char4*>(aq + (size_t)(m0 + r0 + u) * g.K + c) = o;
      }
    }
  }
  // every CTA's codes reach the async proxy before any CTA of the cluster
  // reads them with TMA
  sm90::fence_proxy_async_global();
  __syncwarp();
  sm90::cluster_sync();
}

// grid (ceil(N / 128), ceil(M / BM)); EPI_LN: clusters of (ceil(N / 128),
// 1, 1), so
// a cluster is one row block and blockIdx.x its rank (cx CTAs). A of type
// T; resid R and out O (K1: both T). T = bf16: map_w covers the (K, N)
// matrix; float: map_w and map_wl its (N, K) hi and lo halves; int8_t:
// map_w the (N, K) codes. A consumer thread holds acc[4j + 2h + e] =
// C[row0 + 8h, n0 + 8j + 2(lane % 4) + e], row0 = m0 + 64·wg + 16·(warp %
// 4) + lane / 4 (wgmma's accumulator layout, the same for every type).
template <int BM, int EPI, typename T, typename R, typename O, bool RAGGED>
__global__ void __launch_bounds__(Tile<BM, T>::THREADS)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_wl, const GemmArgs g) {
  using L = Tile<BM, T>;
  using Acc = typename std::conditional<L::I8, int, float>::type;
  static_assert(!(L::I8 && RAGGED), "K4's widths are N % 128 == 0");
  // QA and QOUT (s8 LayerNorm GEMMs only; QOUT with f32 out): the
  // launcher checks them
  const bool qa = L::I8 && EPI == EPI_LN && g.a32 != nullptr;
  const bool qout = L::I8 && sizeof(O) == 4 && g.q_out != nullptr;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::STAGES;
  float* red = reinterpret_cast<float*>(smem + L::red);   // [RED][BM]
  float* rfs = red + 3 * BM;                              // s8: A's rf
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < L::NC * 4;                 // warp-uniform
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = g.M, N = g.N, K = g.K, cx = g.cx;
  const int kt = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], L::NC * 4);  // lane 0 of each consumer warp
    }
    sm90::fence_mbar_init();
  }
  if constexpr (L::I8) {
    if (qa) {
      quantize_a<BM, L::THREADS>(g, m0, rfs, warp, lane);
    } else {
      for (int r = threadIdx.x; r < BM; r += L::THREADS)
        rfs[r] = m0 + r < M ? g.rf[m0 + r] : 0.0f;
    }
  }
  __syncthreads();

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if (!consumer) {
    if (lane == 0) {
      // QA: the codes the cluster just wrote are read by this thread's TMA
      if (qa) sm90::fence_proxy_async_global();
      sm90::prefetch_tensormap(&map_a);
      sm90::prefetch_tensormap(&map_w);
      if (L::F32) sm90::prefetch_tensormap(&map_wl);
      for (int t = 0; t < kt; ++t) {
        const int s = t % L::STAGES;
        if (t >= L::STAGES)
          sm90::mbar_wait(&empty[s], ((t / L::STAGES) - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        unsigned char* w = st + L::A_BYTES;
        const int k0 = t * L::BK;
        sm90::mbar_expect_tx(&full[s], L::STAGE);
        sm90::tma_load_2d(st, &map_a, &full[s], k0, m0);
        if (L::F32) {
          sm90::tma_load_2d(w, &map_w, &full[s], k0, n0);
          sm90::tma_load_2d(w + L::W_BOX, &map_wl, &full[s], k0, n0);
        } else if (L::I8) {
          sm90::tma_load_2d(w, &map_w, &full[s], k0, n0);
        } else {
          sm90::tma_load_2d(w, &map_w, &full[s], n0, k0);
          sm90::tma_load_2d(w + L::W_BOX, &map_w, &full[s], n0 + 64, k0);
        }
      }
    }
    __syncwarp();
  } else if constexpr (L::I8) {
    mainloop_s8<BM>(acc, smem, full, empty, kt, warp, lane);
  } else if constexpr (L::F32) {
    mainloop_tf32<BM>(acc, smem, full, empty, kt, warp, lane);
  } else {
    mainloop_bf16<BM>(acc, smem, full, empty, kt, warp, lane);
  }

  const int rl = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // local row
  const int c0 = n0 + (lane % 4) * 2;
  // v = acc + bias (s8: dequantized)
  float v[64];
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      // columns past N (a ragged last tile) are zeros: their W read zeros
      const bool live = !RAGGED || c < N;
      const float b[2] = {live ? g.bias[c] : 0.0f, live ? g.bias[c + 1] : 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        if constexpr (L::I8)
          v[i] = dequant(acc[i], rfs[rl + 8 * (e / 2)],
                         g.ws[c + e % 2], b[e % 2]);
        else
          v[i] = acc[i] + b[e % 2];
      }
    }
  }
  O* out = static_cast<O*>(g.out);
  if (EPI != EPI_LN) {
    if (!consumer) return;
    float amax[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        float v0 = v[4 * j + 2 * h];
        float v1 = v[4 * j + 2 * h + 1];
        if (EPI == EPI_GELU) {
          v0 = gelu_as(v0);
          v1 = gelu_as(v1);
        }
        if (r < M && (!RAGGED || c < N))
          store2(out + (size_t)r * N + c, v0, v1);
        amax[h] = fmaxf(amax[h], fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
    if (L::I8 && EPI == EPI_GELU) {
      // PART: each row's absmax over this CTA's 128 columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m = quad_max(amax[h]);
        const int r = m0 + rl + 8 * h;
        if (lane % 4 == 0 && r < M)
          g.part[(size_t)r * gridDim.x + blockIdx.x] = m;
      }
    }
    return;
  }

  // LayerNorm across the cluster: pass 1 the mean, pass 2 the variance of
  // the deviations; every thread (the producer warp too) meets the
  // cluster barriers
  const R* resid = static_cast<const R*>(g.resid);
  float part[2] = {0.0f, 0.0f};
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      if (RAGGED && c >= N) continue;      // past a ragged N: not in the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        const float2 x = r < M ? load2(resid + (size_t)r * N + c)
                               : make_float2(0.0f, 0.0f);
        float& v0 = v[4 * j + 2 * h];
        float& v1 = v[4 * j + 2 * h + 1];
        v0 = v0 + x.x;
        v1 = v1 + x.y;
        part[h] += v0;
        part[h] += v1;
      }
    }
  }
  part[0] = quad_sum(part[0]);
  part[1] = quad_sum(part[1]);
  if (consumer && lane % 4 == 0) {
    red[rl] = part[0];
    red[rl + 8] = part[1];
  }
  __syncwarp();
  sm90::cluster_sync();
  float mean[2] = {0.0f, 0.0f};
  part[0] = part[1] = 0.0f;
  if (consumer) {
    const float2 tot = cluster_rows(red + rl, cx);
    mean[0] = tot.x / N;
    mean[1] = tot.y / N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (RAGGED && c0 + j * 8 >= N) continue;  // past a ragged N
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[4 * j + e] - mean[e / 2];
        part[e / 2] += d * d;
      }
    }
  }
  part[0] = quad_sum(part[0]);
  part[1] = quad_sum(part[1]);
  if (consumer && lane % 4 == 0) {
    red[BM + rl] = part[0];
    red[BM + rl + 8] = part[1];
  }
  __syncwarp();
  sm90::cluster_sync();
  float rstd[2] = {0.0f, 0.0f};
  if (consumer) {
    const float2 tot = cluster_rows(red + BM + rl, cx);
    rstd[0] = rsqrtf(tot.x / N + g.eps);
    rstd[1] = rsqrtf(tot.y / N + g.eps);
  }
  // the normalised value of v: K1's expression; s8 rounds each step once,
  // as its twin
  auto norm = [&](float x, int h, float s, float b) {
    if constexpr (L::I8)
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean[h]), rstd[h]), s),
                       b);
    else
      return (x - mean[h]) * rstd[h] * s + b;
  };
  float amax[2] = {0.0f, 0.0f};
  if (!qout) {
    // this CTA has read its peers' partials: it arrives now and waits only
    // before it leaves, so no CTA frees shared memory a peer still reads
    __syncwarp();
    sm90::cluster_arrive();
  }
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      if (RAGGED && c >= N) continue;      // past a ragged N
      const float s0 = g.ln_s[c], s1 = g.ln_s[c + 1];
      const float b0 = g.ln_b[c], b1 = g.ln_b[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        const float y0 = norm(v[4 * j + 2 * h], h, s0, b0);
        const float y1 = norm(v[4 * j + 2 * h + 1], h, s1, b1);
        if (r < M) store2(out + (size_t)r * N + c, y0, y1);
        if (qout) {
          v[4 * j + 2 * h] = y0;
          v[4 * j + 2 * h + 1] = y1;
          amax[h] = fmaxf(amax[h], fmaxf(fabsf(y0), fabsf(y1)));
        }
      }
    }
  }
  if (L::I8 && qout) {
    // the output rows' absmax across the cluster, then their codes
    amax[0] = quad_max(amax[0]);
    amax[1] = quad_max(amax[1]);
    if (consumer && lane % 4 == 0) {
      red[2 * BM + rl] = amax[0];
      red[2 * BM + rl + 8] = amax[1];
    }
    __syncwarp();
    sm90::cluster_sync();
    float2 m = make_float2(0.0f, 0.0f);
    if (consumer) m = cluster_rows<true>(red + 2 * BM + rl, cx);
    __syncwarp();
    sm90::cluster_arrive();
    if (consumer) {
      const float s[2] = {fmaxf(m.x, 1e-6f), fmaxf(m.y, 1e-6f)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        if (r >= M) continue;
        const float rc = __fdiv_rn(127.0f, s[h]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          char2 o;
          o.x = quant(v[4 * j + 2 * h], rc);
          o.y = quant(v[4 * j + 2 * h + 1], rc);
          *reinterpret_cast<char2*>(g.q_out + (size_t)r * N + c0 + j * 8) = o;
        }
        if (blockIdx.x == 0 && lane % 4 == 0)
          g.rf_out[r] = __fmul_rn(s[h], INV127);
      }
    }
  }
  __syncwarp();
  sm90::cluster_wait();
}

// a: A's matrix (QA: the codes the prologue writes, g.aq); w: bf16 the
// (K, N) matrix, f32 W_hi (N, K) with w_lo its W_lo, s8 the (N, K) codes
template <int BM, int EPI, typename T, typename R, typename O, bool RAGGED>
cudaError_t launch_gemm(const void* a, const void* w, const void* w_lo,
                        GemmArgs g, cudaStream_t stream) {
  using L = Tile<BM, T>;
  const int M = g.M, N = g.N, K = g.K;
  CUtensorMap map_a, map_w, map_wl;
  cudaError_t err = sm90::tensor_map_2d(&map_a, a, sizeof(T), M, K, BM, L::BK);
  if (err == cudaSuccess)
    err = sizeof(T) == 2
              ? sm90::tensor_map_2d(&map_w, w, sizeof(T), K, N, L::BK, 64)
              : sm90::tensor_map_2d(&map_w, w, sizeof(T), N, K, BN, L::BK);
  if (err != cudaSuccess) return err;
  if (L::F32) {
    err = sm90::tensor_map_2d(&map_wl, w_lo, sizeof(T), N, K, BN, L::BK);
    if (err != cudaSuccess) return err;
  } else {
    map_wl = map_w;  // unread
  }
  auto kernel = gemm_kernel<BM, EPI, T, R, O, RAGGED>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err == cudaSuccess && EPI == EPI_LN)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // LN: one row block a cluster
  const int nt = (N + BN - 1) / BN;
  g.cx = EPI == EPI_LN ? nt : 1;
  if (g.cx > MAX_CLUSTER) return cudaErrorInvalidValue;
  // K4's s8 GEMMs take their hooks as the layer runs them: the GELU one
  // writes PART; a LayerNorm one is the attention-out form (QOUT, f32 out)
  // or the FFN-out one (QA, with its partials). No other GEMM takes any.
  const bool hooks = g.q_out || g.a32 || g.part;
  bool hooks_ok = !hooks;
  if (sizeof(T) == 1 && EPI == EPI_GELU)
    hooks_ok = g.part && !g.q_out && !g.a32;
  else if (sizeof(T) == 1 && EPI == EPI_LN)
    hooks_ok = g.q_out ? sizeof(O) == 4 && !g.a32 && !g.part
                       : g.a32 && g.part;
  if (!hooks_ok) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, (M + BM - 1) / BM);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (g.cx > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cx;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = sm90::cluster_fits(reinterpret_cast<const void*>(kernel), cfg);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&map_a, &map_w, &map_wl, &g};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BM = 128 where its tiles fill a wave of the card's 132 SMs, else 64.
// N % 128 != 0 needs a RAGGED instance; the others refuse it.
template <int EPI, typename T, typename R, typename O, bool RAGGED = false>
cudaError_t launch_gemm_bm(const void* a, const void* w, const void* w_lo,
                           const GemmArgs& g, cudaStream_t s) {
  if (!RAGGED && g.N % BN != 0) return cudaErrorInvalidValue;
  if ((long long)((g.M + 127) / 128) * ((g.N + BN - 1) / BN) >= 132)
    return launch_gemm<128, EPI, T, R, O, RAGGED>(a, w, w_lo, g, s);
  return launch_gemm<64, EPI, T, R, O, RAGGED>(a, w, w_lo, g, s);
}

}  // namespace
