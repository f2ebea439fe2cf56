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
// The GEMM is bf16 x bf16 -> f32 on the tensor cores (WMMA 16x16x16),
// 64x128 output tiles staged through shared memory for the epilogue. For
// the LayerNorm epilogue one CTA owns 32 whole rows: it walks every
// 128-column chunk of N, keeps the f32 row block in shared memory and
// normalises it there, so the residual add and LN never touch HBM in f32
// (at H = 1024 the row block is 129 KB). The attention kernel pads the
// head dim to 16, 32, 64 or 128, so every width of the reference's
// envelope (128 % hd == 0, H % 128 == 0) runs; the wrapper
// (ops/layer.py::_layer_cuda) makes the five launches.
//
// What bounds it. At MiniLM width (H=384, I=1536) the four projections are
// ~96% of the layer's FLOPs, and at B·S >= 8192 rows they are compute bound
// (about 3.5 MB of bf16 weights against GFLOPs of work). This first version
// loads tiles synchronously (no cp.async / TMA pipeline, no wgmma), so it is
// bound by tensor-core issue stalls on shared-memory loads; the fast shape
// (TMA ring + wgmma, persistent CTAs) is later work. Intermediates qkv, ctx,
// x1 and h do make one HBM round trip each (the TPU kernel kept them in
// VMEM): ~2·M·(3H+H+H+I)·2 bytes per layer.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 32;                 // GEMM depth per smem stage
constexpr int BN = 128;                // GEMM output columns per tile
constexpr int GEMM_THREADS = 256;      // 8 warps laid out 2 (M) x 4 (N)
constexpr int A_LD = BK + 8;           // padded smem rows (bf16 elements)
constexpr int B_LD = BN + 8;

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

size_t gemm_smem_bytes(int bm, int epi, int N) {
  const int ldc = (epi == EPI_LN ? N : BN) + 4;
  return align128((size_t)bm * A_LD * sizeof(bf16)) +
         align128((size_t)BK * B_LD * sizeof(bf16)) +
         (size_t)bm * ldc * sizeof(float);
}

// out = epilogue(A (M,K) · W (K,N) + bias). Row-major everywhere.
// EPI_LN: grid.x == 1 and the CTA covers all N columns of its BM rows.
template <int BM, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const bf16* __restrict__ resid,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            bf16* __restrict__ out, int M, int N, int K, float eps) {
  constexpr int FM = BM / 32;          // 16-row fragments per warp
  constexpr int FN = 2;                // warp tile is (BM/2) x 32
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(
      smem + align128((size_t)BM * A_LD * sizeof(bf16)));
  float* Cs = reinterpret_cast<float*>(
      smem + align128((size_t)BM * A_LD * sizeof(bf16)) +
      align128((size_t)BK * B_LD * sizeof(bf16)));
  const int ldc = (EPI == EPI_LN ? N : BN) + 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM;
  const int n_begin = (EPI == EPI_LN) ? 0 : blockIdx.x * BN;
  const int n_end = (EPI == EPI_LN) ? N : n_begin + BN;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int idx = tid; idx < BM * (BK / 8); idx += GEMM_THREADS) {
        const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * A_LD + c) = v;
      }
      for (int idx = tid; idx < BK * (BN / 8); idx += GEMM_THREADS) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * B_LD + c) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * FM * 16 + i * 16) * A_LD + kk,
                                 A_LD);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bfr[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
      __syncthreads();
    }

    const int cbase = (EPI == EPI_LN) ? n0 : 0;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * FM * 16 + i * 16) * ldc + cbase + wn * 32 + j * 16,
            acc[i][j], ldc, wmma::mem_row_major);

    if (EPI != EPI_LN) {
      __syncthreads();
      for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
        const int r = idx / BN, c = idx % BN;
        if (m0 + r >= M) continue;
        float h = Cs[r * ldc + c] + bias[n0 + c];
        if (EPI == EPI_GELU) h = gelu_as(h);
        out[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(h);
      }
    }
  }

  if (EPI == EPI_LN) {
    __syncthreads();
    ln_rows(Cs, ldc, BM, m0, M, N, bias, resid, ln_s, ln_b, out, eps);
  }
}

template <int BM, int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias,
                        const void* resid, const void* ln_s, const void* ln_b,
                        void* out, int M, int N, int K, float eps,
                        cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes(BM, EPI, N);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BM, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(EPI == EPI_LN ? 1 : N / BN, (M + BM - 1) / BM);
  gemm_kernel<BM, EPI><<<grid, GEMM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(resid),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<bf16*>(out), M, N, K, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 instance's GEMM: out = epilogue(A (M,K) · W (K,N) + bias), all
// f32, row-major, on the CUDA cores. 256 threads as 16 (rows) x 16
// (columns); thread (ty, tx) owns rows ty·TM + i and columns tx·4 + j and
// 64 + tx·4 + j of each 128-column chunk. A's slab is staged transposed
// (k-major) so a k-step reads TM row values and two float4s of W.
// EPI_LN: grid.x == 1 and the CTA covers all N columns of its BM rows,
// keeping them in an f32 row block for ln_rows.
constexpr int SBK = 16;                 // f32 GEMM depth per smem stage
constexpr int SA_LD = 4;                // A slab pitch: BM + SA_LD

size_t sgemm_smem_bytes(int bm, int epi, int N) {
  return 2 * align128((size_t)SBK * (bm + SA_LD) * sizeof(float)) +
         2 * align128((size_t)SBK * BN * sizeof(float)) +
         (epi == EPI_LN ? (size_t)bm * (N + 4) * sizeof(float) : 0);
}

template <int BM, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
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
  sgemm_kernel<BM, EPI><<<grid, GEMM_THREADS, smem, stream>>>(
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
// out bf16 (WMMA); f32 = 1: all f32 (CUDA-core FMAs). Needs N % 128 == 0
// and K % 32 == 0 (bf16) or K % 16 == 0 (f32), and for f32 16-byte aligned
// a, w and out; resid/ln_* are read only for epi 2. Returns a cudaError_t.
int dawn_bert_gemm(const void* a, const void* w, const void* bias,
                   const void* resid, const void* ln_s, const void* ln_b,
                   void* out, int M, int N, int K, int epi, float eps, int f32,
                   void* stream) {
  if (M <= 0 || N % BN != 0 || K <= 0 || K % (f32 ? SBK : BK) != 0)
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
      return (int)launch_gemm<64, EPI_BIAS>(a, w, bias, resid, ln_s, ln_b, out,
                                            M, N, K, eps, s);
    case EPI_GELU:
      return (int)launch_gemm<64, EPI_GELU>(a, w, bias, resid, ln_s, ln_b, out,
                                            M, N, K, eps, s);
    case EPI_LN:
      if (gemm_smem_bytes(32, EPI_LN, N) > 227 * 1024)
        return (int)cudaErrorInvalidValue;
      return (int)launch_gemm<32, EPI_LN>(a, w, bias, resid, ln_s, ln_b, out,
                                          M, N, K, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dawn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
