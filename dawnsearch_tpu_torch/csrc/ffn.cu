// K7: the fused FFN of the per-op encoder on Hopper (sm_90a), bf16 in / out
// or f32 in / out (compute_dtype = "f32").
//
// Replaces the TPU kernel dawnsearch_tpu/ops/ffn.py::fused_ffn (body
// _ffn_kernel, pallas_call at :89). Same contract, rounding point for
// rounding point (ffn.py:51-66):
//
//   h = dt(GELU(x·W1 + b1))           dt: x's dtype, bf16 or f32; GELU
//                                      with the A&S 7.1.26 erf polynomial
//                                      of ffn.py:36-46
//   y = (h·W2 + b2) + x               f32
//   out = dt(LN(y)·g + beta)           LN in f32, eps from the caller
//
// Design. The TPU kernel keeps an M-tile's (rows, I) intermediate in VMEM;
// keeping it on chip is what separates K7 from two dense calls with an HBM
// round trip (ffn_impl="xla"). Here one CTA (8 warps) owns BM whole rows
// and runs both GEMMs back to back: x's rows sit in shared memory, GEMM 1
// walks I in 128-column chunks and writes bf16 GELU(h) for its rows into
// shared memory, GEMM 2 reads that h as its A operand and leaves y as f32
// rows in shared memory, and the residual add and LayerNorm run there. h
// and y never touch HBM. BM is the largest of 64, 32, 16 rows whose x, h,
// y and the weight ring fit the SM's 227 KB (MiniLM 384/1536 and TinyBERT
// 312/1200: 32; BERT-base 768/3072: 16); a width whose 16 rows do not fit
// is refused, not spilled. Weight tiles (64 x 128 bf16) stream through a
// ring of three shared-memory buffers filled by cp.async two tiles ahead
// of the MMAs; the products are bf16 WMMA 16x16x16 with f32 accumulate.
// H and I need only be multiples of 8 (16-byte loads): the GEMM depth is
// zero-padded to a multiple of 16 in shared memory, and columns past N
// of a 128-column chunk are zero weights whose results are dropped.
//
// What bounds it. At MiniLM width and M = 8192 rows it does 19.3 GFLOP and
// must move 13.5 MB (x, out, weights), so the tensor cores bound it (19.5
// µs at 989 TFLOP/s dense bf16). Every CTA streams all of W1 and W2 (2.4
// MB at MiniLM width) from L2, 32 rows of work per weight byte, with 4-8
// WMMAs per warp per barrier and one CTA per SM, so this version is bound
// by L2 traffic and WMMA dispatch, far from either peak; wgmma fed by TMA,
// with more rows per weight tile, is the fast shape, later work.
//
// The f32 instance (ffn_f32_kernel) keeps the same plan with f32 rows: x,
// the unrounded h and y of a row block in shared memory, both GEMMs back
// to back. The H100 has no f32 MMA and one TF32 pass keeps 10 mantissa
// bits, so its products are f32 FMAs on the CUDA cores: each 128-column
// chunk is a register-tiled block product (256 threads, a 2 x 8, 1 x 8 or
// 1 x 4 micro-tile for 32, 16 or 8 rows) over 16-row weight slabs in two
// shared-memory buffers, the next slab's loads in registers while the
// current one computes. f32 doubles every row's bytes, so the block is
// the largest of 32, 16 and 8 rows that fits (MiniLM and TinyBERT: 16;
// BERT-base and BERT-large: 8). What bounds it: 4·M·H·I f32 FMAs at
// 67 TFLOP/s; this version is bound by shared-memory operand reads, and
// every CTA streams all of W1 and W2 from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;        // 8 warps
constexpr int BN = 128;             // output columns per chunk
constexpr int BK = 64;              // weight rows per staged tile
constexpr int NSTAGE = 3;           // weight tiles in flight (cp.async ring)
constexpr int W_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr size_t SMEM_MAX = 227 * 1024;

__host__ __device__ int round16(int x) { return (x + 15) & ~15; }

// Shared-memory plan of a BM-row CTA at width H, FFN width I.
struct Plan {
  int xld, hld, yld;                // row pitches (elements)
  size_t x, h, w, y, bytes;         // byte offsets and total
  __host__ __device__ Plan(int bm, int H, int I) {
    xld = round16(H) + 8;
    hld = round16(I) + 8;
    yld = (H + BN - 1) / BN * BN + 4;
    x = 0;
    h = x + align128((size_t)bm * xld * sizeof(bf16));
    w = h + align128((size_t)bm * hld * sizeof(bf16));
    y = w + NSTAGE * align128((size_t)BK * W_LD * sizeof(bf16));
    bytes = y + align128((size_t)bm * yld * sizeof(float));
  }
};

int block_rows(int H, int I) {
  for (int bm = 64; bm >= 16; bm /= 2)
    if (Plan(bm, H, I).bytes <= SMEM_MAX) return bm;
  return 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out = A · W over every 128-column chunk of N, chunk by chunk: acc[j]
// (16 x 16 each) holds rows [wm·16, +16) and columns n0 + (wn·FN + j)·16
// of the chunk, and epilogue(n0, acc) runs after each chunk. A (BM x K,
// pitch ald) is in shared memory, zero past K up to round16(K). W (K x N,
// row-major, N % 8 == 0) streams through a ring of NSTAGE shared-memory
// tiles of BK x BN, filled by cp.async (zero past K and past N) NSTAGE - 1
// tiles ahead of the MMAs, across chunk boundaries.
template <int FN, typename Epilogue>
__device__ __forceinline__ void gemm(const bf16* As, int ald,
                                     const bf16* __restrict__ W, int K, int N,
                                     bf16* Ws, int wm, int wn,
                                     Epilogue epilogue) {
  constexpr size_t TILE = align128((size_t)BK * W_LD * sizeof(bf16)) /
                          sizeof(bf16);
  const int kp = round16(K);
  const int kt = (kp + BK - 1) / BK;
  const int tiles = (N + BN - 1) / BN * kt;
  auto prefetch = [&](int t) {
    if (t < tiles) {
      const int n0 = t / kt * BN, k0 = t % kt * BK;
      bf16* dst = Ws + (t % NSTAGE) * TILE;
      for (int idx = threadIdx.x; idx < BK * (BN / 8); idx += THREADS) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(dst + r * W_LD + c,
                   ok ? W + (size_t)(k0 + r) * N + n0 + c : W, ok);
      }
    }
    cp_async_commit();                  // an empty group keeps the count
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
  for (int t = 0; t < NSTAGE - 1; ++t) prefetch(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();        // this thread's copies of tile t
    __syncthreads();                    // everyone's; tile t - 1 is consumed
    prefetch(t + NSTAGE - 1);           // into tile t - 1's buffer
    const int k0 = t % kt * BK;
    if (k0 == 0) {
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
    }
    const bf16* Wt = Ws + (t % NSTAGE) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (k0 + kk >= kp) break;         // uniform: the last tile of a ragged K
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + wm * 16 * ald + k0 + kk, ald);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Wt + kk * W_LD + (wn * FN + j) * 16, W_LD);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    if (t % kt == kt - 1) epilogue(t / kt * BN, acc);
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the next GEMM
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, bf16* __restrict__ out, int M,
           int H, int I, float eps) {
  constexpr int WM = BM / 16;           // warps along the rows: 4, 2, 1
  constexpr int WN = 8 / WM;            // warps along a chunk's columns
  constexpr int FN = BN / 16 / WN;      // 16-column fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan pl(BM, H, I);
  bf16* Xs = reinterpret_cast<bf16*>(smem + pl.x);
  bf16* Hs = reinterpret_cast<bf16*>(smem + pl.h);
  bf16* Ws = reinterpret_cast<bf16*>(smem + pl.w);
  float* Ys = reinterpret_cast<float*>(smem + pl.y);
  float* Cs = Ys;                       // GEMM 1's chunk tile, before y exists

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM;
  const int hk = round16(H), ik = round16(I);

  // x rows, zero past H and past M
  for (int idx = tid; idx < BM * (hk / 8); idx += THREADS) {
    const int r = idx / (hk / 8), c = (idx % (hk / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M && c < H)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * H + c);
    *reinterpret_cast<uint4*>(Xs + r * pl.xld + c) = val;
  }

  // GEMM 1: h = bf16(GELU(x·W1 + b1)) into shared memory, zero past I
  gemm<FN>(Xs, pl.xld, w1, H, I, Ws, wm, wn, [&](int n0, auto& acc) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + wm * 16 * C_LD + (wn * FN + j) * 16, acc[j],
                              C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN, col = n0 + c;
      if (col >= ik) continue;
      float g = 0.0f;
      if (col < I) {
        g = gelu_as(Cs[r * C_LD + c] + b1[col]);
      }
      Hs[r * pl.hld + col] = __float2bfloat16(g);
    }
  });

  // GEMM 2: Ys = h·W2 (f32) for every 128-column chunk of H
  gemm<FN>(Hs, pl.hld, w2, I, H, Ws, wm, wn, [&](int n0, auto& acc) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Ys + wm * 16 * pl.yld + n0 + (wn * FN + j) * 16,
                              acc[j], pl.yld, wmma::mem_row_major);
  });

  // y = (h·W2 + b2) + x, then LayerNorm: one warp per row
  for (int r = warp; r < BM; r += THREADS / 32) {
    if (m0 + r >= M) continue;            // warp-uniform
    float* yr = Ys + r * pl.yld;
    const bf16* xr = Xs + r * pl.xld;
    float sum = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float v = (yr[c] + b2[c]) + __bfloat162float(xr[c]);
      yr[c] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / H;
    float sq = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float d = yr[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / H + eps);
    bf16* orow = out + (size_t)(m0 + r) * H;
    for (int c = lane; c < H; c += 32)
      orow[c] = __float2bfloat16((yr[c] - mean) * rstd * ln_s[c] + ln_b[c]);
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* ln_s,
                   const void* ln_b, void* out, int M, int H, int I, float eps,
                   cudaStream_t stream) {
  const size_t smem = Plan(BM, H, I).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ffn_kernel<BM><<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), M, H, I, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 instance.
constexpr int SBK = 16;             // weight rows per f32 slab

// Shared-memory plan of a BM-row f32 CTA at width H, FFN width I.
struct PlanF32 {
  int xld, hld, yld;                // row pitches (floats)
  size_t x, h, w, y, bytes;         // byte offsets and total
  __host__ __device__ PlanF32(int bm, int H, int I) {
    xld = round16(H) + 4;
    hld = round16(I) + 4;
    yld = (H + BN - 1) / BN * BN + 4;
    x = 0;
    h = x + align128((size_t)bm * xld * sizeof(float));
    w = h + align128((size_t)bm * hld * sizeof(float));
    y = w + 2 * align128((size_t)SBK * BN * sizeof(float));
    bytes = y + align128((size_t)bm * yld * sizeof(float));
  }
};

int block_rows_f32(int H, int I) {
  for (int bm = 32; bm >= 8; bm /= 2)
    if (PlanF32(bm, H, I).bytes <= SMEM_MAX) return bm;
  return 0;
}

// C (BM x N) = A (BM x K, shared memory, pitch ald, zero past K up to
// round16(K)) · W (K x N, global, row-major, N % 4 == 0), walked in
// 128-column chunks; epilogue(n0, acc) runs after each chunk. Thread
// (ty, tx) of RY x CX owns rows ty·TM + i and columns h·CX·4 + tx·4 + j of
// the chunk (TN = 4·NH columns). W's 16-row slabs go through the two
// buffers Ws (zero past K and past N).
template <int BM, typename Epilogue>
__device__ __forceinline__ void sgemm(const float* As, int ald,
                                      const float* __restrict__ W, int K,
                                      int N, float* Ws, Epilogue epilogue) {
  constexpr int RY = BM >= 16 ? 16 : 8;   // thread rows
  constexpr int CX = THREADS / RY;        // thread columns: 16 or 32
  constexpr int TM = BM / RY;             // 2, 1 or 1
  constexpr int NH = 128 / (CX * 4);      // float4 column groups: 2 or 1
  constexpr size_t SLAB = align128((size_t)SBK * BN * sizeof(float)) /
                          sizeof(float);
  const int tid = threadIdx.x, tx = tid % CX, ty = tid / CX;
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  const int kt = round16(K) / SBK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    float4 rb[2];
    auto fetch = [&](int t) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = t * SBK + br + 8 * u;
        rb[u] = k < K && n0 + bc < N
                    ? *reinterpret_cast<const float4*>(W + (size_t)k * N + n0 + bc)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto stage = [&](int buf) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float4*>(Ws + buf * SLAB + (br + 8 * u) * BN + bc) =
            rb[u];
    };
    float acc[TM][4 * NH];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NH; ++j) acc[i][j] = 0.0f;
    fetch(0);
    stage(0);
    __syncthreads();
    for (int t = 0; t < kt; ++t) {
      const int cur = t & 1;
      if (t + 1 < kt) fetch(t + 1);
      const float* b = Ws + cur * SLAB;
      const float* a = As + t * SBK;
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) {
        float av[TM], bv[4 * NH];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = a[(ty * TM + i) * ald + kk];
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          const float4 v = *reinterpret_cast<const float4*>(
              b + kk * BN + hh * CX * 4 + tx * 4);
          bv[4 * hh] = v.x; bv[4 * hh + 1] = v.y;
          bv[4 * hh + 2] = v.z; bv[4 * hh + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * NH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (t + 1 < kt) stage(cur ^ 1);   // read before the previous barrier
      __syncthreads();
    }
    // acc[i][hh·4 + j] is row ty·TM + i, column n0 + hh·CX·4 + tx·4 + j
    epilogue(n0, ty * TM, tx * 4, acc);
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, float* __restrict__ out, int M,
               int H, int I, float eps) {
  constexpr int RY = BM >= 16 ? 16 : 8;
  constexpr int CX = THREADS / RY;
  constexpr int TM = BM / RY;
  constexpr int NH = 128 / (CX * 4);
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanF32 pl(BM, H, I);
  float* Xs = reinterpret_cast<float*>(smem + pl.x);
  float* Hs = reinterpret_cast<float*>(smem + pl.h);
  float* Ws = reinterpret_cast<float*>(smem + pl.w);
  float* Ys = reinterpret_cast<float*>(smem + pl.y);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int hk = round16(H), ik = round16(I);

  // x rows, zero past H and past M
  for (int idx = tid; idx < BM * (hk / 4); idx += THREADS) {
    const int r = idx / (hk / 4), c = (idx % (hk / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < M && c < H)
      val = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * H + c);
    *reinterpret_cast<float4*>(Xs + r * pl.xld + c) = val;
  }
  __syncthreads();

  // GEMM 1: h = GELU(x·W1 + b1) into shared memory, unrounded, zero past I
  sgemm<BM>(Xs, pl.xld, w1, H, I, Ws,
            [&](int n0, int r0, int c0, float (&acc)[TM][4 * NH]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + hh * CX * 4 + c0 + j;
          if (col < ik)
            Hs[(r0 + i) * pl.hld + col] =
                col < I ? gelu_as(acc[i][hh * 4 + j] + b1[col]) : 0.0f;
        }
  });
  __syncthreads();                      // every chunk of h is written

  // GEMM 2: Ys = h·W2 (f32) for every 128-column chunk of H
  sgemm<BM>(Hs, pl.hld, w2, I, H, Ws,
            [&](int n0, int r0, int c0, float (&acc)[TM][4 * NH]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ys[(r0 + i) * pl.yld + n0 + hh * CX * 4 + c0 + j] =
              acc[i][hh * 4 + j];
  });
  __syncthreads();

  // y = (h·W2 + b2) + x, then LayerNorm: one warp per row
  for (int r = warp; r < BM; r += THREADS / 32) {
    if (m0 + r >= M) continue;            // warp-uniform
    float* yr = Ys + r * pl.yld;
    const float* xr = Xs + r * pl.xld;
    float sum = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float v = (yr[c] + b2[c]) + xr[c];
      yr[c] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / H;
    float sq = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float d = yr[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / H + eps);
    float* orow = out + (size_t)(m0 + r) * H;
    for (int c = lane; c < H; c += 32)
      orow[c] = (yr[c] - mean) * rstd * ln_s[c] + ln_b[c];
  }
}

template <int BM>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* ln_s,
                       const void* ln_b, void* out, int M, int H, int I,
                       float eps, cudaStream_t stream) {
  const size_t smem = PlanF32(BM, H, I).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_f32_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ffn_f32_kernel<BM><<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<float*>(out), M, H, I, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per CTA K7 uses at width H, FFN width I, for bf16 (f32 = 0) or f32
// (f32 = 1) rows; 0 if the smallest block (16 rows bf16, 8 rows f32) does
// not fit the SM's shared memory (the width is refused).
int dawn_ffn_block_rows(int H, int I, int f32) {
  if (H <= 0 || I <= 0 || H % 8 != 0 || I % 8 != 0) return 0;
  return f32 ? block_rows_f32(H, I) : block_rows(H, I);
}

// out (M, H) = LN((GELU(x·W1 + b1)·W2 + b2) + x); x, W1 (H, I), W2 (I, H)
// and out row-major, bf16 (f32 = 0) or f32 (f32 = 1), vectors f32.
// H % 8 == 0, I % 8 == 0, 16-byte aligned x, W1, W2. Returns a
// cudaError_t.
int dawn_ffn(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* ln_s, const void* ln_b, void* out,
             int M, int H, int I, float eps, int f32, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    switch (dawn_ffn_block_rows(H, I, 1)) {
      case 32:
        return (int)launch_f32<32>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I,
                                   eps, s);
      case 16:
        return (int)launch_f32<16>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I,
                                   eps, s);
      case 8:
        return (int)launch_f32<8>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I,
                                  eps, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dawn_ffn_block_rows(H, I, 0)) {
    case 64:
      return (int)launch<64>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I, eps, s);
    case 32:
      return (int)launch<32>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I, eps, s);
    case 16:
      return (int)launch<16>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, H, I, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
