// K1: one post-LN BERT layer on Hopper (sm_90a), bf16 in / bf16 out, or
// f32 in / f32 out (compute_dtype = "f32").
//
// Replaces the TPU kernel dawnsearch_tpu/ops/layer.py::fused_bert_layer
// (body _layer_kernel, pallas_call in _layer_pallas). Same contract:
//
//   qkv = dt(x·Wqkv + bqkv)                  dt: x's dtype, bf16 or f32
//   ctx = dt(per head: dt(exp(s - max)) · V  ·  1/Σexp(s - max)),
//         s = (q·kᵀ)/√hd + mask_bias [+ rel]   (softmax in f32, normalised
//         after PV; rel: the optional (nh, S, S) f32 shared score bias,
//         MPNet's relative-position bias, `has_rel` in the reference)
//   x1  = dt(LN(ctx·Wo + bo + x))
//   h   = dt(GELU(x1·W1 + b1))               GELU with the A&S 7.1.26 erf
//   y   = dt(LN(h·W2 + b2 + x1))          LN in f32, eps from the caller
//
// Design. The TPU kernel keeps a whole row block and every intermediate in
// ~64 MB of VMEM. A Hopper SM has 227 KB of shared memory, so the layer is
// split into five launches per layer, four of them this file's GEMM:
//   gemm_kernel<EPI_BIAS>  x·Wqkv + b            -> qkv  (M, 3H) bf16
//   attention              csrc/attention.cu's kernel (dawn_attention), q,
//                          k and v read as column views of qkv, rel
//                          passed through -> ctx
//   gemm_kernel<EPI_LN>    ctx·Wo + bo + x -> LN -> x1 (M, H) bf16
//   gemm_kernel<EPI_GELU>  x1·W1 + b1 -> GELU    -> h  (M, I) bf16
//   gemm_kernel<EPI_LN>    h·W2 + b2 + x1 -> LN  -> y  (M, H) bf16
// The bf16 GEMM is a TMA + wgmma kernel. A CTA owns a BM x 128 output tile
// (BM = 64 or 128: one or two consumer warpgroups of 64 rows each) and one
// producer warp. The producer keeps a ring of 64-deep k stages (4 at BM =
// 64, 3 at BM = 128: 96 KB, so two CTAs share an SM and one's epilogue
// overlaps the other's mainloop) filled by TMA loads under the 128-byte
// swizzle, each stage completing on an mbarrier; the consumers issue
// wgmma.m64n128k16 with both operands in shared memory and free a stage
// (a second mbarrier) once the wgmma group that read it has retired. A
// (the activations) is K-major. W keeps the reference's (in, out) layout,
// which is MN-major for the product: wgmma reads it with its transpose bit
// set, two 64-column TMA boxes per stage. Rows past M read zeros (TMA's
// out-of-bounds fill) and are masked on the store. Tensor maps are encoded
// on the host at every call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__
// parameters, so a CUDA graph that captured a launch keeps valid maps.
// BM = 128 where 128-row tiles give the card a full wave (>= 132 CTAs),
// else 64, which doubles the CTAs at small M (a B = 1 query is M = 128);
// 256-row tiles (four consumer warpgroups) moved a layer by 1-2.5% and
// are not instantiated.
// Not persistent: at these K (384 to 4096) a tile's mainloop is 6 to 64
// stages, and the second CTA per SM hides the prologue and epilogue. K is
// not split at small M: a B = 1 query's LayerNorm GEMMs read 10-15 µs on
// the card (PERF.md §6), under the 20 µs at which a second cluster
// dimension over K would pay for its extra f32 reduction.
//
// The LayerNorm epilogue needs whole rows. A thread-block cluster of N/128
// CTAs spans one BM-row block (3 at MiniLM, 6 at BERT-base, 8 at
// BERT-large, up to 13 at H = 1664 as a non-portable cluster): each CTA
// forms v = (acc + b) + resid in registers, writes per-row partial sums
// of its 128 columns to shared memory, reads every CTA's partials through
// distributed shared memory in cluster-rank order after a cluster
// barrier (so every CTA gets the same mean), then does the same for
// Σ(v − mean)², the twin's two-pass LayerNorm, and normalises its own
// columns. No f32 row block is kept in shared memory; the envelope is
// every H % 128 == 0 up to 16 CTAs (H = 2048). The cluster shape is
// checked with cudaOccupancyMaxActiveClusters and refused, never shrunk.
// The sums' order (within a CTA: each thread's 32 columns, then the quad
// of lanes sharing a row; across CTAs: rank order) differs from the
// twin's, an f32 rounding difference only.
//
// What bounds it. At MiniLM width (H=384, I=1536) the four projections are
// ~96% of the layer's FLOPs, and at B·S >= 8192 rows they are compute
// bound (about 3.5 MB of bf16 weights against GFLOPs of work): 989
// TFLOP/s of bf16 wgmma. At a B = 1 query (M = 128) each projection moves
// about 1-4 MB and is bound by bytes (about 1 µs), in practice by the
// latency of a K chain of 6-24 stages on 6-24 CTAs. This version runs at
// 150-420 TFLOP/s at M >= 4096 on the bias and GELU GEMMs and 90-380 on
// the LayerNorm ones (PERF.md §6): a 128 x 128 tile streams
// 32 KB from L2 per 64-deep stage (about 6 TB/s across the card on the
// qkv GEMM), and at MiniLM and BERT-base K is only 6-12 stages deep, so
// L2-to-shared bandwidth and each tile's pipeline fill and epilogue bound
// it. Sharing A and W by TMA multicast within 2-6-CTA clusters was tried
// and was slower: the cluster-wide stage barriers it needs cost more than
// the L2 reads it saved. A LayerNorm tile costs about twice a bias tile
// (three cluster barriers and two DSMEM gathers in its epilogue).
// Intermediates qkv, ctx, x1 and h make one HBM round trip each (the TPU
// kernel kept them in VMEM): ~2·M·(3H+H+H+I)·2 bytes per layer.
//
// The f32 instance (the reference's BertConfig(dtype=float32): f32
// operands into every projection, no rounding of qkv, ctx, x1, h or p, f32
// out) runs the same five launches on f32 buffers. The H100 has no f32
// MMA, and one TF32 pass keeps 10 mantissa bits (about 1e-3 relative), so
// its GEMM (sgemm_kernel) takes f32 FMAs on the CUDA cores: a 64 x 128 CTA
// tile (32 x 128 for the LayerNorm epilogue), a 4 x 8 (2 x 8) micro-tile
// per thread, K slabs of 16 through two shared-memory buffers, the next
// slab's global loads in registers while the current one computes. Same
// three epilogues. Its attention is csrc/attention.cu's fixed-order kernel
// on f32 q, k, v with p unrounded. What bounds it: the projections' FMAs
// at 67 TFLOP/s of f32; this version is bound by shared-memory reads of
// the micro-tile's operands.
//
// Differences from the TPU kernel that do not change the contract:
//  - heads are computed one at a time: the 128-lane block-diagonal packing
//    of ops/layer.py:70-112 is a TPU lane trick.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 128;                // GEMM output columns per CTA

constexpr int EPI_BIAS = 0;
constexpr int EPI_GELU = 1;
constexpr int EPI_LN = 2;

// The LayerNorm epilogue over a CTA's f32 row block in shared memory (bm
// rows of N + bias, pitch ldc): out = LN(C + bias + resid), one warp a row.
template <typename R, typename O>
__device__ __forceinline__ void ln_rows(float* Cs, int ldc, int bm, int m0,
                                        int M, int N,
                                        const float* __restrict__ bias,
                                        const R* __restrict__ resid,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b,
                                        O* __restrict__ out, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < bm; r += blockDim.x / 32) {
    if (m0 + r >= M) continue;  // warp-uniform
    float* row = Cs + r * ldc;
    const R* xr = resid + (size_t)(m0 + r) * N;
    float sum = 0.0f;
    for (int c = lane; c < N; c += 32) {
      const float v = (row[c] + bias[c]) + to_f32(xr[c]);
      row[c] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / N;
    float sq = 0.0f;
    for (int c = lane; c < N; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / N + eps);
    O* orow = out + (size_t)(m0 + r) * N;
    for (int c = lane; c < N; c += 32)
      store(orow + c, (row[c] - mean) * rstd * ln_s[c] + ln_b[c]);
  }
}

// ---------------------------------------------------------------------------
// The bf16 GEMM: out = epilogue(A (M,K) · W (K,N) + bias), TMA + wgmma.
constexpr int BK = 64;                 // bf16 per 128-byte swizzled row
constexpr int W_BOX = BK * 64 * 2;     // one 64 x 64 TMA box of W: 8 KB
constexpr int MAX_CLUSTER = 16;        // non-portable cluster limit

// Shared memory of a BM-row CTA: the stage ring (A: BM rows of 128 bytes;
// W: two 64-column boxes), its full / empty mbarriers, and the LayerNorm
// epilogue's per-row partial sums (two passes). 1 KB of slack aligns the
// ring to the swizzle's 1024-byte atom.
template <int BM>
struct Tile {
  static constexpr int NC = BM / 64;               // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;    // + the producer warp
  static constexpr int STAGES = BM == 128 ? 3 : 4;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + 2 * W_BOX;
  static constexpr size_t bars = (size_t)STAGES * STAGE;
  static constexpr size_t red = bars + 2 * STAGES * sizeof(uint64_t);
  static constexpr size_t bytes = red + 2 * BM * sizeof(float) + 1024;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Σ over the n CTAs of the cluster, in rank order, of the f32 at p's
// offset and at p + 8 (a thread's two rows); the loads go four ranks at a
// time
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
        tot.x += v[0][q];
        tot.y += v[1][q];
      }
  }
  return tot;
}

// grid (N / 128, ceil(M / BM)); EPI_LN: clusters of (N / 128, 1, 1), so
// a cluster is one row block and blockIdx.x its rank (cx CTAs). A
// consumer thread holds acc[4j + 2h + e] = C[row0 + 8h, n0 + 8j +
// 2(lane % 4) + e], row0 = m0 + 64·wg + 16·(warp % 4) + lane / 4
// (wgmma's accumulator layout).
template <int BM, int EPI>
__global__ void __launch_bounds__(Tile<BM>::THREADS)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ bias, const bf16* __restrict__ resid,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            bf16* __restrict__ out, int M, int N, int K, float eps,
            int cx) {
  using T = Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + T::STAGES;
  float* red = reinterpret_cast<float*>(smem + T::red);   // [2][BM]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < T::NC * 4;                 // warp-uniform
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], T::NC * 4);  // lane 0 of each consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (!consumer) {
    if (lane == 0) {
      sm90::prefetch_tensormap(&map_a);
      sm90::prefetch_tensormap(&map_w);
      for (int t = 0; t < kt; ++t) {
        const int s = t % T::STAGES;
        if (t >= T::STAGES)
          sm90::mbar_wait(&empty[s], ((t / T::STAGES) - 1) & 1);
        unsigned char* st = smem + s * T::STAGE;
        sm90::mbar_expect_tx(&full[s], T::STAGE);
        sm90::tma_load_2d(st, &map_a, &full[s], t * BK, m0);
        sm90::tma_load_2d(st + T::A_BYTES, &map_w, &full[s], n0, t * BK);
        sm90::tma_load_2d(st + T::A_BYTES + W_BOX, &map_w, &full[s], n0 + 64,
                          t * BK);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp / 4;
    for (int t = 0; t < kt; ++t) {
      const int s = t % T::STAGES;
      sm90::mbar_wait(&full[s], (t / T::STAGES) & 1);
      const unsigned char* a = smem + s * T::STAGE + wg * 64 * 128;
      const unsigned char* w = smem + s * T::STAGE + T::A_BYTES;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_m64n128k16_tb(acc, sm90::wgmma_desc(a + kk * 32, 16, 1024),
                                  sm90::wgmma_desc(w + kk * 2048, W_BOX, 1024));
      sm90::wgmma_commit();
      sm90::fence_regs(acc);
      // the group of stage t - 1 has retired: its buffers are free
      sm90::wgmma_wait<1>();
      if (t > 0 && lane == 0) sm90::mbar_arrive(&empty[(t - 1) % T::STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

  const int rl = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // local row
  const int c0 = n0 + (lane % 4) * 2;
  if (EPI != EPI_LN) {
    if (!consumer) return;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        float v0 = acc[4 * j + 2 * h] + b0;
        float v1 = acc[4 * j + 2 * h + 1] + b1;
        if (EPI == EPI_GELU) {
          v0 = gelu_as(v0);
          v1 = gelu_as(v1);
        }
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
    return;
  }

  // LayerNorm across the cluster: pass 1 the mean, pass 2 the variance of
  // the deviations; every thread (the producer warp too) meets the three
  // cluster barriers
  float part[2] = {0.0f, 0.0f};
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        float x0 = 0.0f, x1 = 0.0f;
        if (r < M) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(resid + (size_t)r * N + c);
          x0 = __low2float(xv);
          x1 = __high2float(xv);
        }
        float& v0 = acc[4 * j + 2 * h];
        float& v1 = acc[4 * j + 2 * h + 1];
        v0 = (v0 + b0) + x0;
        v1 = (v1 + b1) + x1;
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
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = acc[4 * j + e] - mean[e / 2];
        part[e / 2] += d * d;
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
    rstd[0] = rsqrtf(tot.x / N + eps);
    rstd[1] = rsqrtf(tot.y / N + eps);
  }
  // this CTA has read its peers' partials: it arrives now and waits only
  // before it leaves, so no CTA frees shared memory a peer still reads
  __syncwarp();
  sm90::cluster_arrive();
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float s0 = ln_s[c], s1 = ln_s[c + 1];
      const float b0 = ln_b[c], b1 = ln_b[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        const float y0 = (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * s0 + b0;
        const float y1 = (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * s1 + b1;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) =
              __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncwarp();
  sm90::cluster_wait();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (CUDA 12.5 added the versioned lookup and deprecated the other).
cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major (rows, cols) bf16 matrix as a 2-D tensor map of (box_rows,
// box_cols) boxes under the 128-byte swizzle; out-of-bounds reads are 0.
// Needs a 16-byte aligned base and cols % 8 == 0.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows, int box_cols) {
  EncodeTiledFn encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether clusters of cx CTAs of gemm_kernel<BM, EPI> fit the card
// (cached: the answer depends only on the kernel and cx). A refusal is an
// error, never a smaller cluster.
template <int BM, int EPI>
cudaError_t cluster_fits(const cudaLaunchConfig_t& cfg, int cx) {
  static signed char fits[MAX_CLUSTER + 1] = {};
  signed char& f = fits[cx];
  if (f == 0) {
    int n = 0;
    auto kernel = gemm_kernel<BM, EPI>;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    f = n > 0 ? 1 : -1;
  }
  return f > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int BM, int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias,
                        const void* resid, const void* ln_s, const void* ln_b,
                        void* out, int M, int N, int K, float eps,
                        cudaStream_t stream) {
  using T = Tile<BM>;
  CUtensorMap map_a, map_w;
  cudaError_t err = tensor_map(&map_a, a, M, K, BM, BK);
  if (err != cudaSuccess) return err;
  err = tensor_map(&map_w, w, K, N, BK, 64);
  if (err != cudaSuccess) return err;
  auto kernel = gemm_kernel<BM, EPI>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::bytes);
  if (err == cudaSuccess && EPI == EPI_LN)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // LN: one row block a cluster
  int cx = EPI == EPI_LN ? N / BN : 1;
  if (cx > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cx > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cx;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cluster_fits<BM, EPI>(cfg, cx);
    if (err != cudaSuccess) return err;
  }
  const float* bias_p = static_cast<const float*>(bias);
  const bf16* resid_p = static_cast<const bf16*>(resid);
  const float* ln_s_p = static_cast<const float*>(ln_s);
  const float* ln_b_p = static_cast<const float*>(ln_b);
  bf16* out_p = static_cast<bf16*>(out);
  void* args[] = {&map_a, &map_w, &bias_p, &resid_p, &ln_s_p, &ln_b_p,
                  &out_p, &M, &N, &K, &eps, &cx};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BM = 128 where its tiles fill a wave of the card's 132 SMs, else 64
template <int EPI>
cudaError_t launch_gemm_bm(const void* a, const void* w, const void* bias,
                           const void* resid, const void* ln_s,
                           const void* ln_b, void* out, int M, int N, int K,
                           float eps, cudaStream_t s) {
  if ((long long)((M + 127) / 128) * (N / BN) >= 132)
    return launch_gemm<128, EPI>(a, w, bias, resid, ln_s, ln_b, out, M, N, K,
                                 eps, s);
  return launch_gemm<64, EPI>(a, w, bias, resid, ln_s, ln_b, out, M, N, K,
                              eps, s);
}

// ---------------------------------------------------------------------------
// The f32 instance's GEMM: out = epilogue(A (M,K) · W (K,N) + bias), all
// f32, row-major, on the CUDA cores. 256 threads as 16 (rows) x 16
// (columns); thread (ty, tx) owns rows ty·TM + i and columns tx·4 + j and
// 64 + tx·4 + j of each 128-column chunk. A's slab is staged transposed
// (k-major) so a k-step reads TM row values and two float4s of W.
// EPI_LN: grid.x == 1 and the CTA covers all N columns of its BM rows,
// keeping them in an f32 row block for ln_rows.
constexpr int SG_THREADS = 256;         // f32 GEMM: 16 x 16 threads
constexpr int SBK = 16;                 // f32 GEMM depth per smem stage
constexpr int SA_LD = 4;                // A slab pitch: BM + SA_LD

size_t sgemm_smem_bytes(int bm, int epi, int N) {
  return 2 * align128((size_t)SBK * (bm + SA_LD) * sizeof(float)) +
         2 * align128((size_t)SBK * BN * sizeof(float)) +
         (epi == EPI_LN ? (size_t)bm * (N + 4) * sizeof(float) : 0);
}

template <int BM, int EPI>
__global__ void __launch_bounds__(SG_THREADS)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
             const float* __restrict__ bias, const float* __restrict__ resid,
             const float* __restrict__ ln_s, const float* __restrict__ ln_b,
             float* __restrict__ out, int M, int N, int K, float eps) {
  constexpr int TM = BM / 16;           // rows per thread: 4 or 2
  constexpr int LDA = BM + SA_LD;
  constexpr int A_VEC = BM * SBK / 4;   // float4s of an A slab: <= 256
  extern __shared__ __align__(128) unsigned char smem[];
  float* As[2];
  float* Bs[2];
  const size_t a_bytes = align128((size_t)SBK * LDA * sizeof(float));
  const size_t b_bytes = align128((size_t)SBK * BN * sizeof(float));
  As[0] = reinterpret_cast<float*>(smem);
  As[1] = reinterpret_cast<float*>(smem + a_bytes);
  Bs[0] = reinterpret_cast<float*>(smem + 2 * a_bytes);
  Bs[1] = reinterpret_cast<float*>(smem + 2 * a_bytes + b_bytes);
  float* Cs = reinterpret_cast<float*>(smem + 2 * a_bytes + 2 * b_bytes);
  const int ldc = N + 4;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n_begin = (EPI == EPI_LN) ? 0 : blockIdx.x * BN;
  const int n_end = (EPI == EPI_LN) ? N : n_begin + BN;
  // this thread's share of a slab: one float4 of A (row ar, k ac..ac+3; the
  // threads past A_VEC load none) and two of W (k-rows br, br + 8)
  const int ar = tid / (SBK / 4), ac = (tid % (SBK / 4)) * 4;
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  const int kt = K / SBK;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb0, rb1;
    auto fetch = [&](int t) {
      const int k0 = t * SBK;
      if (tid < A_VEC && m0 + ar < M)
        ra = *reinterpret_cast<const float4*>(A + (size_t)(m0 + ar) * K + k0 +
                                              ac);
      rb0 = *reinterpret_cast<const float4*>(W + (size_t)(k0 + br) * N + n0 +
                                             bc);
      rb1 = *reinterpret_cast<const float4*>(W + (size_t)(k0 + br + 8) * N +
                                             n0 + bc);
    };
    auto stage = [&](int buf) {
      if (tid < A_VEC) {
        float* a = As[buf];
        a[(ac + 0) * LDA + ar] = ra.x;
        a[(ac + 1) * LDA + ar] = ra.y;
        a[(ac + 2) * LDA + ar] = ra.z;
        a[(ac + 3) * LDA + ar] = ra.w;
      }
      *reinterpret_cast<float4*>(Bs[buf] + br * BN + bc) = rb0;
      *reinterpret_cast<float4*>(Bs[buf] + (br + 8) * BN + bc) = rb1;
    };
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    fetch(0);
    stage(0);
    __syncthreads();
    for (int t = 0; t < kt; ++t) {
      const int cur = t & 1;
      if (t + 1 < kt) fetch(t + 1);
      const float* a = As[cur];
      const float* b = Bs[cur];
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) {
        float av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = a[kk * LDA + ty * TM + i];
        const float4 b0 = *reinterpret_cast<const float4*>(b + kk * BN + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b + kk * BN + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // the other buffer was last read before the previous barrier
      if (t + 1 < kt) stage(cur ^ 1);
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = half * 64 + tx * 4;     // column within the chunk
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[i][half * 4 + j];
        if (EPI == EPI_LN) {
          *reinterpret_cast<float4*>(Cs + r * ldc + n0 + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else if (m0 + r < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = v[j] + bias[n0 + c + j];
            if (EPI == EPI_GELU) v[j] = gelu_as(v[j]);
          }
          *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }

  if (EPI == EPI_LN) {
    __syncthreads();
    ln_rows(Cs, ldc, BM, m0, M, N, bias, resid, ln_s, ln_b, out, eps);
  }
}

template <int BM, int EPI>
cudaError_t launch_sgemm(const void* a, const void* w, const void* bias,
                         const void* resid, const void* ln_s,
                         const void* ln_b, void* out, int M, int N, int K,
                         float eps, cudaStream_t stream) {
  const size_t smem = sgemm_smem_bytes(BM, EPI, N);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sgemm_kernel<BM, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(EPI == EPI_LN ? 1 : N / BN, (M + BM - 1) / BM);
  sgemm_kernel<BM, EPI><<<grid, SG_THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(resid),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<float*>(out), M, N, K, eps);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// One of the layer's four projections. epi: 0 = +bias, 1 = +bias -> GELU,
// 2 = +bias +resid -> LayerNorm(ln_s, ln_b, eps). f32 = 0: a, w, resid and
// out bf16 (TMA + wgmma; the LayerNorm as a cluster of N / 128 CTAs);
// f32 = 1: all f32 (CUDA-core FMAs). Needs N % 128 == 0 (bf16 LayerNorm:
// N <= 2048) and K % 8 == 0 with 16-byte aligned a and w (bf16) or K % 16
// == 0 with 16-byte aligned a, w and out (f32); resid/ln_* are read only
// for epi 2. Returns a cudaError_t: a tensor map, shared-memory size or
// cluster shape the card refuses is an error, never a smaller launch.
int dawn_bert_gemm(const void* a, const void* w, const void* bias,
                   const void* resid, const void* ln_s, const void* ln_b,
                   void* out, int M, int N, int K, int epi, float eps, int f32,
                   void* stream) {
  if (M <= 0 || N % BN != 0 || K <= 0 || K % (f32 ? SBK : 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    switch (epi) {
      case EPI_BIAS:
        return (int)launch_sgemm<64, EPI_BIAS>(a, w, bias, resid, ln_s, ln_b,
                                               out, M, N, K, eps, s);
      case EPI_GELU:
        return (int)launch_sgemm<64, EPI_GELU>(a, w, bias, resid, ln_s, ln_b,
                                               out, M, N, K, eps, s);
      case EPI_LN:
        return (int)launch_sgemm<32, EPI_LN>(a, w, bias, resid, ln_s, ln_b,
                                             out, M, N, K, eps, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (epi) {
    case EPI_BIAS:
      return (int)launch_gemm_bm<EPI_BIAS>(a, w, bias, resid, ln_s, ln_b, out,
                                           M, N, K, eps, s);
    case EPI_GELU:
      return (int)launch_gemm_bm<EPI_GELU>(a, w, bias, resid, ln_s, ln_b, out,
                                           M, N, K, eps, s);
    case EPI_LN:
      return (int)launch_gemm_bm<EPI_LN>(a, w, bias, resid, ln_s, ln_b, out,
                                         M, N, K, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dawn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
