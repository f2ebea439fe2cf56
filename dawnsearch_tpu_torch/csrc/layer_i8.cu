// K4: one post-LN BERT layer with W8A8 projections on Hopper (sm_90a),
// bf16 in / bf16 out, or f32 in / f32 out (compute_dtype = "f32").
//
// Replaces the TPU kernel dawnsearch_tpu/ops/layer.py::fused_bert_layer_i8
// (body _layer_kernel_i8 with _mm_i8, pallas_call in _layer_pallas). Same
// contract, rounding point for rounding point:
//
//   mm_i8(a32, Wq, ws):  s   = max(rowabsmax(a32), 1e-6)
//                        aq  = round_half_even(a32 · (127 / s))      i8
//                        acc = aq · Wq                  s8·s8 -> s32, exact
//                        out = (f32(acc) · (s · f32(1/127))) · ws[col]
//   qkv = dt(mm_i8(f32(x), Wqkv) + bqkv)                dt: x's dtype
//   ctx = f32 attention of q, k, v (p rounded to dt before PV, 1/Σp from
//         the f32 p, no rounding of the output; every sum in one fixed
//         order: csrc/attention.cu's out_f32 kernel)
//   x1  = LN(mm_i8(ctx, Wo) + bo + f32(x))                         f32
//   h   = GELU_AS(mm_i8(x1, W1) + b1)                              f32
//   y   = dt(LN(mm_i8(h, W2) + b2 + x1))
//
// At f32 (the reference's BertConfig(dtype=float32), _layer_kernel_i8 on an
// f32 x) the projections stay W8A8, since mm_i8 quantizes f32 activations
// anyway: x is read as f32, qkv is kept in f32, the attention takes f32
// q, k, v with p unrounded, and y is written in f32.
//
// Weights Wq are (K, N) row-major i8 codes with per-column f32 scales ws,
// quantized once from the f32 parameters (ops/layer.py::quant_cols). GELU
// uses the reference's A&S 7.1.26 erf polynomial (ops/layer.py:53-59).
// Every dequant and epilogue step is written with __fmul_rn / __fadd_rn in
// the reference's order, so nvcc cannot contract an FMA the reference does
// not do: the s32 sums are exact, so a projection equals the plain twin's
// (ops/layer.py::bert_layer_i8_plain) wherever the activation codes agree.
//
// Design. The TPU kernel keeps a row block and every intermediate in VMEM;
// here the layer is nine launches on one stream, issued by one C call
// (dawn_bert_layer_i8):
//   quant_rows   x (dt) -> aq, row factor s·(1/127)          one warp a row
//   gemm<QKV>    aq·Wqkv -> dequant + b -> qkv (M, 3H) dt
//   attention    dawn_attention (csrc/attention.cu, fixed_order: the
//                fixed-order kernel, f32 out), q, k, v as column views
//                of qkv -> ctx (M, H) f32
//   quant_rows   ctx -> aq;  gemm<LN>  aq·Wo -> dequant + bo + x -> LN -> x1
//   quant_rows   x1  -> aq;  gemm<GELU> aq·W1 -> dequant + b1 -> GELU -> h
//   quant_rows   h   -> aq;  gemm<LN>  aq·W2 -> dequant + b2 + x1 -> LN -> y
// The GEMM is K1's shape (csrc/layer.cu) on the s8 tensor cores: WMMA
// 16x16x16 signed char with int accumulators, 64x128 output tiles (32 whole
// rows for the LayerNorm epilogues, which walk every 128-column chunk of N
// and keep the s32 row block in shared memory), 256 threads as 2 x 4 warps,
// k-depth 64 per stage. Shared tiles are stored as 16-byte k-slabs
// ([slab][row][16]) so every WMMA fragment starts on a 256-byte boundary.
//
// What bounds it. The four projections are ~96% of the layer's operations
// at MiniLM width and more at BERT-base; at 1,979 int8 TOP/s they take half
// the bf16 time. This first version stages tiles synchronously (no
// cp.async / TMA ring, no wgmma) and makes one HBM round trip for every
// intermediate, in f32 where the reference keeps f32 (ctx, x1, h), plus the
// four activation quantizations: about M·(12H + 10I) bytes beyond K1's per
// layer. Fusing the quantization into the producing epilogue and a wgmma
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

extern "C" int dawn_attention(const void* q, const void* k, const void* v,
                              const void* bias, const void* rel, void* out,
                              int B, int nh, int S, int hd, long long in_b,
                              long long in_h,
                              long long in_r, long long out_b, long long out_h,
                              long long out_r, float scale, int out_f32,
                              int in_f32, int fixed_order, void* stream);

namespace {

constexpr int BN = 128;                 // GEMM output columns per tile
constexpr int BK = 64;                  // GEMM depth per stage (bytes of i8)
constexpr int KS = BK / 16;             // 16-deep k-slabs per stage
constexpr int NS = BN / 16;             // 16-wide column slabs of B
constexpr int B_SLAB = BK * 16 + 64;    // bytes per B slab (+64: no conflicts)
constexpr int THREADS = 256;            // 8 warps, 2 (M) x 4 (N)
constexpr int QUANT_ROWS = THREADS / 32;

constexpr int EPI_QKV = 0;              // + b -> bf16
constexpr int EPI_GELU = 1;             // + b -> GELU -> f32
constexpr int EPI_LN = 2;               // + b + resid -> LayerNorm

constexpr float INV127 = 1.0f / 127.0f;  // f32(1/127), as the reference folds it

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four consecutive elements (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// (f32(acc) · row factor) · column scale + bias
__device__ __forceinline__ float dequant(int acc, float rf, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rf), ws), b);
}

// Per-row symmetric i8 quantization of (M, K) activations: one warp a row,
// K % 128 == 0. Writes the codes and the row factor s·f32(1/127).
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ rf, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * QUANT_ROWS + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float m = 0.0f;
  for (int c = lane * 4; c < K; c += 128) {
    float v[4];
    load4(xr + c, v);
    m = fmaxf(fmaxf(m, fabsf(v[0])), fmaxf(fabsf(v[1]), fmaxf(fabsf(v[2]),
                                                              fabsf(v[3]))));
  }
  const float s = fmaxf(warp_max(m), 1e-6f);
  const float r = __fdiv_rn(127.0f, s);
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane * 4; c < K; c += 128) {
    float v[4];
    load4(xr + c, v);
    char4 o;
    o.x = (signed char)__float2int_rn(__fmul_rn(v[0], r));
    o.y = (signed char)__float2int_rn(__fmul_rn(v[1], r));
    o.z = (signed char)__float2int_rn(__fmul_rn(v[2], r));
    o.w = (signed char)__float2int_rn(__fmul_rn(v[3], r));
    *reinterpret_cast<char4*>(qr + c) = o;
  }
  if (lane == 0) rf[row] = __fmul_rn(s, INV127);
}

size_t gemm_smem_bytes(int bm, int epi, int N) {
  const int ldc = (epi == EPI_LN ? N : BN) + 4;
  return align128((size_t)KS * bm * 16) + align128((size_t)NS * B_SLAB) +
         (size_t)bm * ldc * sizeof(int);
}

// out = epilogue(dequant(Aq (M,K) · Wq (K,N))). Row-major i8 operands.
// EPI_LN: grid.x == 1 and the CTA covers all N columns of its BM rows;
// resid is R (M, N), the output O. Otherwise out is O (M, N).
template <int BM, int EPI, typename R, typename O>
__global__ void __launch_bounds__(THREADS)
gemm_i8_kernel(const int8_t* __restrict__ A, const float* __restrict__ rf,
               const int8_t* __restrict__ W, const float* __restrict__ ws,
               const float* __restrict__ bias, const R* __restrict__ resid,
               const float* __restrict__ ln_s, const float* __restrict__ ln_b,
               O* __restrict__ out, int M, int N, int K, float eps) {
  constexpr int FM = BM / 32;          // 16-row fragments per warp
  constexpr int FN = 2;                // warp tile is (BM/2) x 32
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);   // [KS][BM][16]
  signed char* Bs = reinterpret_cast<signed char*>(
      smem + align128((size_t)KS * BM * 16));                // [NS][B_SLAB]
  int* Cs = reinterpret_cast<int*>(
      smem + align128((size_t)KS * BM * 16) + align128((size_t)NS * B_SLAB));
  const int ldc = (EPI == EPI_LN ? N : BN) + 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM;
  const int n_begin = (EPI == EPI_LN) ? 0 : blockIdx.x * BN;
  const int n_end = (EPI == EPI_LN) ? N : n_begin + BN;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

    for (int k0 = 0; k0 < K; k0 += BK) {
      // A: 16 bytes of one row's k-slab per thread (four threads read one
      // row's 64 contiguous bytes; eight rows fill one 128-byte line of a slab)
      for (int idx = tid; idx < BM * KS; idx += THREADS) {
        const int r = idx / KS, ks = idx % KS;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 +
                                              ks * 16);
        *reinterpret_cast<uint4*>(As + (ks * BM + r) * 16) = v;
      }
      // B: 16 columns of one k-row per thread (eight threads read a row's
      // 128 contiguous bytes)
      for (int idx = tid; idx < BK * NS; idx += THREADS) {
        const int r = idx / NS, ns = idx % NS;
        *reinterpret_cast<uint4*>(Bs + ns * B_SLAB + r * 16) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 +
                                            ns * 16);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> bfr[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              af[i], As + (ks * BM + wm * FM * 16 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(
              bfr[j], Bs + (wn * 2 + j) * B_SLAB + ks * 16 * 16, 16);
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
      for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN;
        if (m0 + r >= M) continue;
        float v = dequant(Cs[r * ldc + c], rf[m0 + r], ws[n0 + c],
                          bias[n0 + c]);
        if (EPI == EPI_GELU) v = gelu_as(v);
        store(out + (size_t)(m0 + r) * N + n0 + c, v);
      }
    }
  }

  if (EPI == EPI_LN) {
    __syncthreads();
    for (int r = warp; r < BM; r += THREADS / 32) {
      if (m0 + r >= M) continue;  // warp-uniform
      int* row = Cs + r * ldc;
      const float rfr = rf[m0 + r];
      const R* xr = resid + (size_t)(m0 + r) * N;
      float sum = 0.0f;
      for (int c = lane; c < N; c += 32) {
        const float v = __fadd_rn(dequant(row[c], rfr, ws[c], bias[c]),
                                  to_f32(xr[c]));
        row[c] = __float_as_int(v);
        sum += v;
      }
      const float mean = warp_sum(sum) / N;
      float sq = 0.0f;
      for (int c = lane; c < N; c += 32) {
        const float d = __int_as_float(row[c]) - mean;
        sq += d * d;
      }
      const float rstd = rsqrtf(warp_sum(sq) / N + eps);
      O* orow = out + (size_t)(m0 + r) * N;
      for (int c = lane; c < N; c += 32) {
        const float d = __fmul_rn(__fsub_rn(__int_as_float(row[c]), mean), rstd);
        store(orow + c, __fadd_rn(__fmul_rn(d, ln_s[c]), ln_b[c]));
      }
    }
  }
}

template <typename T>
cudaError_t quant_rows(const T* x, int8_t* q, float* rf, int M, int K,
                       cudaStream_t s) {
  quant_rows_kernel<T><<<(M + QUANT_ROWS - 1) / QUANT_ROWS, THREADS, 0, s>>>(
      x, q, rf, M, K);
  return cudaGetLastError();
}

template <int BM, int EPI, typename R, typename O>
cudaError_t gemm(const int8_t* a, const float* rf, const void* wq,
                 const void* ws, const void* bias, const R* resid,
                 const void* ln_s, const void* ln_b, O* out, int M, int N,
                 int K, float eps, cudaStream_t s) {
  const size_t smem = gemm_smem_bytes(BM, EPI, N);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_i8_kernel<BM, EPI, R, O>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(EPI == EPI_LN ? 1 : N / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<BM, EPI, R, O><<<grid, THREADS, smem, s>>>(
      a, rf, static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), resid,
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), out,
      M, N, K, eps);
  return cudaGetLastError();
}

// dawn_bert_layer_i8's nine launches with activations of type T (x, qkv, y)
template <typename T>
int layer_i8(const void* const* p, int B, int S, int H, int nh, int I,
             float eps, void* stream) {
  const int hd = H / nh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const T* x = static_cast<const T*>(p[0]);
  int8_t* aq = static_cast<int8_t*>(const_cast<void*>(p[19]));
  float* rf = static_cast<float*>(const_cast<void*>(p[20]));
  T* qkv = static_cast<T*>(const_cast<void*>(p[21]));
  float* f = static_cast<float*>(const_cast<void*>(p[22]));
  float* x1 = static_cast<float*>(const_cast<void*>(p[23]));
  T* y = static_cast<T*>(const_cast<void*>(p[18]));
  const float scale = (float)(1.0 / sqrt((double)hd));
  const int in_f32 = sizeof(T) == sizeof(float);
  cudaError_t e;
  if ((e = quant_rows(x, aq, rf, M, H, s))) return (int)e;
  if ((e = gemm<64, EPI_QKV, float, T>(aq, rf, p[2], p[3], p[4], nullptr,
                                       nullptr, nullptr, qkv, M, 3 * H, H, eps,
                                       s)))
    return (int)e;
  const long long S3H = 3LL * S * H, SH = (long long)S * H;
  int ae = dawn_attention(qkv, qkv + H, qkv + 2 * H, p[1], p[24], f, B, nh,
                          S, hd, S3H, hd, 3 * H, SH, hd, H, scale, 1, in_f32,
                          1, stream);
  if (ae) return ae;
  if ((e = quant_rows<float>(f, aq, rf, M, H, s))) return (int)e;
  if ((e = gemm<32, EPI_LN, T, float>(aq, rf, p[5], p[6], p[7], x, p[8],
                                      p[9], x1, M, H, H, eps, s)))
    return (int)e;
  if ((e = quant_rows<float>(x1, aq, rf, M, H, s))) return (int)e;
  if ((e = gemm<64, EPI_GELU, float, float>(aq, rf, p[10], p[11], p[12],
                                            nullptr, nullptr, nullptr, f, M, I,
                                            H, eps, s)))
    return (int)e;
  if ((e = quant_rows<float>(f, aq, rf, M, I, s))) return (int)e;
  return (int)gemm<32, EPI_LN, float, T>(aq, rf, p[13], p[14], p[15], x1,
                                         p[16], p[17], y, M, H, I, eps, s);
}

}  // namespace

extern "C" {

// One BERT layer with W8A8 projections (K4). p holds 25 device pointers:
//   0 x (B·S, H) dt          1 bias (B, S) f32 additive key bias
//   2 qkv_wq (H, 3H) i8      3 qkv_ws (3H) f32   4 qkv_b (3H) f32
//   5 ao_wq (H, H) i8        6 ao_ws (H)         7 ao_b (H)
//   8 aln_s (H)              9 aln_b (H)
//  10 w1q (H, I) i8         11 w1s (I)          12 b1 (I)
//  13 w2q (I, H) i8         14 w2s (H)          15 b2 (H)
//  16 fln_s (H)             17 fln_b (H)
//  18 y (B·S, H) dt, the output
//  scratch, with W = max(H, I):
//          19 aq (B·S, W) i8   20 rf (B·S) f32   21 qkv (B·S, 3H) dt
//          22 f (B·S, W) f32 (ctx, then h)       23 x1 (B·S, H) f32
//  24 rel (nh, S, S) f32 shared score bias (MPNet's rel_bias), or null
// dt is bf16, or f32 when f32 != 0. Needs H = nh·hd with hd <= 128,
// H % 128 == 0, I % 128 == 0, S % 16 == 0, S <= 512, 16-byte aligned
// pointers. Returns a cudaError_t.
int dawn_bert_layer_i8(const void* const* p, int B, int S, int H, int nh,
                       int I, float eps, int f32, void* stream) {
  const int hd = nh > 0 ? H / nh : 0;
  if (B <= 0 || nh <= 0 || hd * nh != H || hd > 128 || H % 128 != 0 ||
      I % 128 != 0 || S <= 0 || S % 16 != 0 || S > 512)
    return (int)cudaErrorInvalidValue;
  return f32 ? layer_i8<float>(p, B, S, H, nh, I, eps, stream)
             : layer_i8<bf16>(p, B, S, H, nh, I, eps, stream);
}

}  // extern "C"
