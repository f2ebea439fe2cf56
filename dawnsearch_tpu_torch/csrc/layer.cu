// K1: one post-LN BERT layer on Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel dawnsearch_tpu/ops/layer.py::fused_bert_layer
// (body _layer_kernel, pallas_call in _layer_pallas). Same contract:
//
//   qkv = bf16(x·Wqkv + bqkv)
//   ctx = bf16(per head: bf16(exp(s - max)) · V  ·  1/Σexp(s - max)),
//         s = (q·kᵀ)/√hd + mask_bias [+ rel]   (softmax in f32, normalised
//         after PV; rel: the optional (nh, S, S) f32 shared score bias,
//         MPNet's relative-position bias, `has_rel` in the reference)
//   x1  = bf16(LN(ctx·Wo + bo + x))
//   h   = bf16(GELU_erf(x1·W1 + b1))
//   y   = bf16(LN(h·W2 + b2 + x1))          LN in f32, eps from the caller
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
// Differences from the TPU kernel that do not change the contract:
//  - heads are computed one at a time: the 128-lane block-diagonal packing
//    of ops/layer.py:70-112 is a TPU lane trick;
//  - GELU uses erff (CUDA's correctly rounded-to-2-ulp erf) where the TPU
//    kernel uses the A&S 7.1.26 polynomial (|err| <= 1.5e-7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
        if (EPI == EPI_GELU)
          h = 0.5f * h * (1.0f + erff(h * 0.70710678118654752440f));
        out[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(h);
      }
    }
  }

  if (EPI == EPI_LN) {
    __syncthreads();
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      if (m0 + r >= M) continue;  // warp-uniform
      float* row = Cs + r * ldc;
      const bf16* xr = resid + (size_t)(m0 + r) * N;
      float sum = 0.0f;
      for (int c = lane; c < N; c += 32) {
        const float v = (row[c] + bias[c]) + __bfloat162float(xr[c]);
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
      bf16* orow = out + (size_t)(m0 + r) * N;
      for (int c = lane; c < N; c += 32)
        orow[c] = __float2bfloat16((row[c] - mean) * rstd * ln_s[c] + ln_b[c]);
    }
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

}  // namespace

extern "C" {

// One of the layer's four projections. epi: 0 = +bias, 1 = +bias -> GELU,
// 2 = +bias +resid -> LayerNorm(ln_s, ln_b, eps). Needs N % 128 == 0 and
// K % 32 == 0; resid/ln_* are read only for epi 2. Returns a cudaError_t.
int dawn_bert_gemm(const void* a, const void* w, const void* bias,
                   const void* resid, const void* ln_s, const void* ln_b,
                   void* out, int M, int N, int K, int epi, float eps,
                   void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
