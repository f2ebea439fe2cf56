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
// Weights are i8 codes with per-column f32 scales ws, quantized once from
// the f32 parameters (ops/layer.py::quant_cols) and laid out (N, K), the
// transpose of the reference's (K, N), when the model is built
// (ops/layer.py::i8_weight): 8-bit wgmma reads both operands K-major. GELU
// uses the reference's A&S 7.1.26 erf polynomial (ops/layer.py:53-59).
// Every dequant and epilogue step is written with __fmul_rn / __fadd_rn in
// the reference's order, so nvcc cannot contract an FMA the reference does
// not do: the s32 sums are exact, so a projection equals the plain twin's
// (ops/layer.py::bert_layer_i8_plain) wherever the activation codes agree.
//
// Design. The TPU kernel keeps a row block and every intermediate in VMEM;
// here the layer is seven launches on one stream, issued by one C call
// (dawn_bert_layer_i8):
//   quant_rows   x (dt) -> codes, row factor s·(1/127)        one warp a row
//   gemm<QKV>    codes·Wqkv -> dequant + b -> qkv (M, 3H) dt
//   attention    dawn_attention (csrc/attention.cu, fixed_order: the
//                fixed-order kernel, f32 out), q, k, v as column views
//                of qkv -> ctx (M, H) f32
//   quant_rows   ctx -> codes, row factors
//   gemm<LN>     codes·Wo -> dequant + bo + x -> LN -> x1 (M, H) f32, and
//                x1's codes and factors (QOUT)
//   gemm<GELU>   x1 codes·W1 -> dequant + b1 -> GELU -> h (M, I) f32, and
//                each row's absmax over each 128 columns (PART)
//   gemm<LN>     quantize h (QA) · W2 -> dequant + b2 + x1 -> LN -> y
// The four projections are csrc/gemm.cuh's TMA + wgmma kernel, K1's, with
// its s8 mainloop: wgmma.m64n128k32 on the s8 tensor cores, 128-deep
// stages of 32 KB at BM = 128 (A and the (N, K) codes under the 128-byte
// swizzle), a producer warp keeping three to four stages in flight. Both
// LayerNorm GEMMs run over a thread-block cluster of N / 128 CTAs that
// holds whole rows, as K1's: at a B = 1 query (M = 128) that is 2·H/128
// CTAs, not the one CTA a 32-row block of the first version had.
// Registers per thread (-Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py phase
// build prints them): 96-99 for the QKV and GELU GEMMs, 128-161 for the
// LayerNorm ones; no spills. Shared memory: 96 KB of ring a CTA (two an
// SM), as K1's bf16 GEMM.
//
// Which activation quantizations are fused, and why. Each needs its row's
// absmax before any code is written:
//   x1   in the attention-out LayerNorm epilogue (QOUT): the cluster holds
//        whole rows, and their absmax is gathered through distributed
//        shared memory like the LayerNorm's sums. One launch and one read
//        of x1 fewer.
//   h    split over the two GEMMs around it: the GELU epilogue leaves each
//        row's absmax over its 128 columns (the GEMM's N = I needs 12-32
//        CTAs a row, past the 16-CTA cluster limit, so it cannot gather
//        them), and the FFN-out GEMM's prologue (QA) takes their max and
//        writes the codes, each CTA of its cluster reading its K / cx of
//        the columns once, then a proxy fence and a cluster barrier put
//        them before the TMA loads that read them. One launch and one
//        read of h fewer than quant_rows: on the card it beats a
//        quant_rows launch plus the GEMM from codes at M >= 4096 and
//        trails them by ~5 µs at M = 128, where its loads' latency shows
//        (PERF.md §6).
//   ctx  keeps its quant_rows launch: quantized in the attention-out GEMM's
//        prologue it read slower than the launch (PERF.md §6), and the
//        attention kernel, which holds K4 to its twin, stays as it is.
//   x    keeps its quant_rows launch: the QKV GEMM's N = 3H needs 9-24
//        CTAs a row block, and x is the layer's input.
// Every one is quant_rows_kernel's arithmetic, so the codes are the same.
//
// What bounds it. The four projections are ~96% of the layer's operations
// at MiniLM width and more at BERT-base; at 1,979 int8 TOP/s they take half
// the bf16 time. The attention stays the fixed-order CUDA-core kernel,
// whose summation order the twin repeats: each i8 re-quantization
// amplifies a one-ulp difference, so it is what holds K4 to its twin and
// what now takes most of K4's time at S >= 128 (a third at S = 128, two
// thirds at S = 512). Intermediates qkv (dt), ctx, x1 and h (f32, as the
// reference keeps them) and the codes of x, ctx, x1 and h make one HBM
// round trip each: about M·(12H + 9I) bytes a layer beyond K1's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

extern "C" int dawn_attention(const void* q, const void* k, const void* v,
                              const void* bias, const void* rel, void* out,
                              int B, int nh, int S, int hd, long long in_b,
                              long long in_h,
                              long long in_r, long long out_b, long long out_h,
                              long long out_r, float scale, int out_f32,
                              int in_f32, int fixed_order, void* stream);

namespace {

constexpr int QUANT_THREADS = 256;
constexpr int QUANT_ROWS = QUANT_THREADS / 32;

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

// Per-row symmetric i8 quantization of (M, K) activations: one warp a row,
// K % 128 == 0. Writes the codes and the row factor s·f32(1/127).
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
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
    o.x = quant(v[0], r);
    o.y = quant(v[1], r);
    o.z = quant(v[2], r);
    o.w = quant(v[3], r);
    *reinterpret_cast<char4*>(qr + c) = o;
  }
  if (lane == 0) rf[row] = __fmul_rn(s, INV127);
}

template <typename T>
cudaError_t quant_rows(const T* x, int8_t* q, float* rf, int M, int K,
                       cudaStream_t s) {
  quant_rows_kernel<T><<<(M + QUANT_ROWS - 1) / QUANT_ROWS, QUANT_THREADS, 0,
                         s>>>(x, q, rf, M, K);
  return cudaGetLastError();
}

// One of K4's four projections with activations of type T (x, qkv, y),
// as the layer runs it: epi 0 the QKV GEMM (codes a, factors rf; out T);
// 1 the GELU GEMM (codes a, rf; out f32, each row's absmax over each 128
// columns into the (M, N / 128) part); 2 with q_out the attention-out
// LayerNorm GEMM (codes a, rf; resid T, out f32, its rows' codes and
// factors into q_out / rf_out); 2 with a32 the FFN-out one (the f32 A
// quantized into `a` first, its row absmax from the (M, K / 128) part;
// resid f32, out T). launch_gemm refuses any other combination.
template <typename T>
cudaError_t i8_gemm(int epi, void* a, const void* rf, const void* a32,
                    void* part, const void* w, const void* ws,
                    const void* bias, const void* resid, const void* ln_s,
                    const void* ln_b, void* out, void* q_out, void* rf_out,
                    int M, int N, int K, float eps, cudaStream_t s) {
  if ((a32 == nullptr) == (rf == nullptr) ||
      (q_out == nullptr) != (rf_out == nullptr))
    return cudaErrorInvalidValue;
  GemmArgs g = {};
  g.bias = static_cast<const float*>(bias);
  g.resid = resid;
  g.ln_s = static_cast<const float*>(ln_s);
  g.ln_b = static_cast<const float*>(ln_b);
  g.out = out;
  g.rf = static_cast<const float*>(rf);
  g.ws = static_cast<const float*>(ws);
  g.a32 = static_cast<const float*>(a32);
  g.aq = static_cast<int8_t*>(a);
  g.part = static_cast<float*>(part);
  g.q_out = static_cast<int8_t*>(q_out);
  g.rf_out = static_cast<float*>(rf_out);
  g.M = M;
  g.N = N;
  g.K = K;
  g.eps = eps;
  if (epi == EPI_BIAS)
    return launch_gemm_bm<EPI_BIAS, int8_t, T, T>(a, w, nullptr, g, s);
  if (epi == EPI_GELU)
    return launch_gemm_bm<EPI_GELU, int8_t, float, float>(a, w, nullptr, g, s);
  if (epi != EPI_LN) return cudaErrorInvalidValue;
  if (q_out != nullptr)
    return launch_gemm_bm<EPI_LN, int8_t, T, float>(a, w, nullptr, g, s);
  return launch_gemm_bm<EPI_LN, int8_t, float, T>(a, w, nullptr, g, s);
}

// dawn_bert_layer_i8's seven launches with activations of type T (x, qkv,
// y)
template <typename T>
int layer_i8(const void* const* p, int B, int S, int H, int nh, int I,
             float eps, void* stream) {
  const int hd = H / nh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const T* x = static_cast<const T*>(p[0]);
  void* aq = const_cast<void*>(p[19]);
  float* rf = static_cast<float*>(const_cast<void*>(p[20]));
  T* qkv = static_cast<T*>(const_cast<void*>(p[21]));
  float* f = static_cast<float*>(const_cast<void*>(p[22]));
  void* x1 = const_cast<void*>(p[23]);
  void* aq1 = const_cast<void*>(p[25]);
  void* rf1 = const_cast<void*>(p[26]);
  void* hpart = const_cast<void*>(p[27]);
  void* y = const_cast<void*>(p[18]);
  int8_t* codes = static_cast<int8_t*>(aq);
  const float scale = (float)(1.0 / sqrt((double)hd));
  const int in_f32 = sizeof(T) == sizeof(float);
  cudaError_t e;
  if ((e = quant_rows(x, codes, rf, M, H, s))) return (int)e;
  if ((e = i8_gemm<T>(EPI_BIAS, aq, rf, nullptr, nullptr, p[2], p[3], p[4],
                      nullptr, nullptr, nullptr, qkv, nullptr, nullptr, M,
                      3 * H, H, eps, s)))
    return (int)e;
  const long long S3H = 3LL * S * H, SH = (long long)S * H;
  int ae = dawn_attention(qkv, qkv + H, qkv + 2 * H, p[1], p[24], f, B, nh,
                          S, hd, S3H, hd, 3 * H, SH, hd, H, scale, 1, in_f32,
                          1, stream);
  if (ae) return ae;
  if ((e = quant_rows<float>(f, codes, rf, M, H, s))) return (int)e;
  if ((e = i8_gemm<T>(EPI_LN, aq, rf, nullptr, nullptr, p[5], p[6], p[7], x,
                      p[8], p[9], x1, aq1, rf1, M, H, H, eps, s)))
    return (int)e;
  if ((e = i8_gemm<T>(EPI_GELU, aq1, rf1, nullptr, hpart, p[10], p[11],
                      p[12], nullptr, nullptr, nullptr, f, nullptr, nullptr,
                      M, I, H, eps, s)))
    return (int)e;
  return (int)i8_gemm<T>(EPI_LN, aq, nullptr, f, hpart, p[13], p[14], p[15],
                         x1, p[16], p[17], y, nullptr, nullptr, M, H, I, eps,
                         s);
}

}  // namespace

extern "C" {

// One BERT layer with W8A8 projections (K4). p holds 28 device pointers:
//   0 x (B·S, H) dt          1 bias (B, S) f32 additive key bias
//   2 qkv_wq (3H, H) i8      3 qkv_ws (3H) f32   4 qkv_b (3H) f32
//   5 ao_wq (H, H) i8        6 ao_ws (H)         7 ao_b (H)
//   8 aln_s (H)              9 aln_b (H)
//  10 w1q (I, H) i8         11 w1s (I)          12 b1 (I)
//  13 w2q (H, I) i8         14 w2s (H)          15 b2 (H)
//  16 fln_s (H)             17 fln_b (H)
//  18 y (B·S, H) dt, the output
//  scratch, with W = max(H, I):
//          19 aq (B·S, W) i8   20 rf (B·S) f32   21 qkv (B·S, 3H) dt
//          22 f (B·S, W) f32 (ctx, then h)       23 x1 (B·S, H) f32
//  24 rel (nh, S, S) f32 shared score bias (MPNet's rel_bias), or null
//  scratch: 25 x1's codes (B·S, H) i8           26 x1's factors (B·S) f32
//           27 h's absmax over each 128 columns (B·S, I / 128) f32
// Weight codes are (N, K): the transpose of the reference's (in, out). dt
// is bf16, or f32 when f32 != 0. Needs H = nh·hd with hd <= 128,
// H % 128 == 0, H <= 2048, I % 128 == 0, S % 16 == 0, S <= 512, 16-byte
// aligned pointers. Returns a cudaError_t.
int dawn_bert_layer_i8(const void* const* p, int B, int S, int H, int nh,
                       int I, float eps, int f32, void* stream) {
  const int hd = nh > 0 ? H / nh : 0;
  if (B <= 0 || nh <= 0 || hd * nh != H || hd > 128 || H % 128 != 0 ||
      H > 2048 || I % 128 != 0 || S <= 0 || S % 16 != 0 || S > 512)
    return (int)cudaErrorInvalidValue;
  return f32 ? layer_i8<float>(p, B, S, H, nh, I, eps, stream)
             : layer_i8<bf16>(p, B, S, H, nh, I, eps, stream);
}

// One of K4's projections alone, in one of the four forms the layer runs
// (i8_gemm above): epi 0 QKV, 1 GELU (part receives h's partial absmax),
// 2 the attention-out LayerNorm (q_out / rf_out) or the FFN-out one (a32
// and its (M, K / 128) partial absmax `part`, quantized into a first).
// w the (N, K) codes, ws and bias (N,) f32; rf the factors of the codes
// a where a32 is null. f32 picks dt. Needs N % 128 == 0 (N <= 2048 for
// epi 2), K % 128 == 0, 16-byte aligned pointers. Returns a cudaError_t.
int dawn_i8_gemm(void* a, const void* rf, const void* a32, void* part,
                 const void* w, const void* ws, const void* bias,
                 const void* resid, const void* ln_s, const void* ln_b,
                 void* out, void* q_out, void* rf_out, int M, int N, int K,
                 int epi, int f32, float eps, void* stream) {
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % 128 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? (int)i8_gemm<float>(epi, a, rf, a32, part, w, ws, bias, resid,
                                   ln_s, ln_b, out, q_out, rf_out, M, N, K,
                                   eps, s)
             : (int)i8_gemm<bf16>(epi, a, rf, a32, part, w, ws, bias, resid,
                                  ln_s, ln_b, out, q_out, rf_out, M, N, K, eps,
                                  s);
}

}  // extern "C"
