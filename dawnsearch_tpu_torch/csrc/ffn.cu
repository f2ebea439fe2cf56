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
// Design. K7 holds no kernel of its own: it is two launches of
// csrc/gemm.cuh::gemm_kernel, the TMA + wgmma ring of K1's projections,
// through csrc/layer.cu::dawn_bert_gemm (layer.cu instantiates the ring
// for both), on the caller's stream:
//   EPI_GELU  x·W1 + b1 -> GELU            -> h   (M, I) in dt
//   EPI_LN    h·W2 + b2 + x (resid) -> LN  -> out (M, H) in dt
// These are K1's last two launches, whose epilogues round where K7's
// contract rounds. bf16 reads W (in, out) MN-major through wgmma's
// transpose bit; f32 multiplies 3xTF32 (hi·hi + hi·lo + lo·hi of TF32
// operands, each stage's products flushed into round-to-nearest adds)
// with each matrix as its (W_hi, W_lo) pair, each (out, in), made once at
// model build (ops/layer.py::tf32_pair): TF32 wgmma reads W K-major.
//
// Why h makes one HBM round trip. The TPU kernel keeps a (256, I) block of
// h in VMEM. An SM's 227 KB holds 16 rows of BERT-base h: the kernel this
// replaced kept h on chip by giving each 8-warp CTA 8-64 rows and both
// GEMMs, so every CTA streamed all of W1 and W2 from L2 (32 rows of work a
// weight byte), on WMMA or CUDA-core FMAs, with 2-8 CTAs at M = 128. Here
// each GEMM tiles its own output across the card, and h costs 2·M·I·bytes
// of traffic: about 100 MB (30 µs at 3.35 TB/s, part of it in the 50 MB
// L2) at BERT-base, bf16, M = 8192.
//
// Widths. H and I need only be multiples of 8 (16-byte rows). A launch
// whose N is not a multiple of 128 takes the ring's RAGGED instance: the
// last column tile is ragged, W's columns past N read zeros through TMA's
// out-of-bounds fill and the epilogues mask the rest (gemm.cuh). The
// LayerNorm launch spans a cluster of ceil(H / 128) CTAs (3 at TinyBERT's
// 312), so H <= 2048; a cluster the card cannot place is refused, never
// shrunk. Nothing else bounds the widths: no row block lives in shared
// memory.
//
// What bounds it. 4·M·H·I multiply-adds: at M = 8192 the tensor cores
// (MiniLM 384/1536: 19.3 GFLOP, 19.5 µs at 989 TFLOP/s bf16; f32 at three
// TF32 products a multiply-add, 495 TFLOP/s); at M = 128 the bytes of W1
// and W2 and, in practice, each launch's K chain on few CTAs. The two
// launches run at the rates of K1's GEMMs, whose limits csrc/layer.cu
// states (L2-to-shared traffic, pipeline fill, the LayerNorm cluster's
// barriers). Readings: PERF.md §6.

#include <cuda_runtime.h>

// csrc/layer.cu: one projection on the ring; epi 1 = +bias -> GELU, 2 =
// +bias +resid -> LayerNorm
extern "C" int dawn_bert_gemm(const void* a, const void* w, const void* w_lo,
                              const void* bias, const void* resid,
                              const void* ln_s, const void* ln_b, void* out,
                              int M, int N, int K, int epi, float eps, int f32,
                              void* stream);

extern "C" {

// out (M, H) = LN((GELU(x·W1 + b1)·W2 + b2) + x), x and out row-major, h
// the caller's (M, I) buffer, all in x's dtype (f32 = 0: bf16; 1: f32),
// vectors f32. bf16: w1 (H, I) and w2 (I, H), w1_lo and w2_lo unread;
// f32: w1, w1_lo the (I, H) W_hi, W_lo of W1 and w2, w2_lo the (H, I) ones
// of W2. H % 8 == 0, I % 8 == 0, H <= 2048, 16-byte aligned x, h and the
// matrices. Returns a cudaError_t (the first launch's, if it failed).
int dawn_ffn(const void* x, const void* w1, const void* w1_lo, const void* b1,
             const void* w2, const void* w2_lo, const void* b2,
             const void* ln_s, const void* ln_b, void* h, void* out, int M,
             int H, int I, float eps, int f32, void* stream) {
  if (M <= 0 || H <= 0 || I <= 0 || H % 8 != 0 || I % 8 != 0 || H > 2048)
    return (int)cudaErrorInvalidValue;
  const int err = dawn_bert_gemm(x, w1, w1_lo, b1, nullptr, nullptr, nullptr,
                                 h, M, I, H, 1, eps, f32, stream);
  if (err != 0) return err;
  return dawn_bert_gemm(h, w2, w2_lo, b2, x, ln_s, ln_b, out, M, H, I, 2, eps,
                        f32, stream);
}

}  // extern "C"
