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
// split into five launches per layer, four of them the GEMM of
// csrc/gemm.cuh (its ring, mainloops and epilogues, shared with K4; this
// file instantiates its bf16 and f32 forms behind dawn_bert_gemm):
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
// out) runs the same five launches on f32 buffers, on the same kernel and
// epilogues. The H100 has no f32 MMA, and one TF32 product keeps 10
// mantissa bits (about 1e-3 relative), so every product is 3xTF32: each
// f32 operand x = hi + lo (hi = tf32(x), lo = tf32(x − hi), rounded to
// nearest with cvt.rna), and A·W = A_hi·W_hi + A_hi·W_lo + A_lo·W_hi in
// f32 accumulators, each term to about 2^-21 relative. TF32 wgmma reads
// both operands K-major (the transpose bit exists for 16-bit types only),
// so the f32 weights are prepared once, when the model is built: W_hi and
// W_lo, each (N, K) with TF32-rounded values (ops/layer.py::tf32_pair;
// twice K1's f32 weight memory, 0.68 GB at BERT-base). A stage holds 32 k
// of A (BM rows of 128 bytes, 128-byte swizzle) and 128 rows of 32 k of
// W_hi and of W_lo; the consumers load their A fragments from the
// swizzled stage, split them in registers and issue wgmma.m64n128k8 with
// A from registers, three a k8 step. The tensor cores round their f32
// accumulation toward zero, a bias that grows with K (1.2e-5 of the
// scale at K = 1536 on the card, over K1's 1e-4 bound at BERT-base), so
// each stage's products accumulate in a fresh register tile that is then
// added to the running sum on the CUDA cores, rounded to nearest. Its
// registers (the running sum, the stage's tile and its fragments: about
// 170) allow one CTA an SM, with four stages; splitting the next stage's
// fragments while a stage's products run (a second fragment set) spilled
// and was slower. Its attention is csrc/attention.cu's 3xTF32 mma.sync
// kernel. What bounds it: the projections' multiply-adds x3 at 495
// TFLOP/s of TF32 (BERT-base, B = 64, S = 128: 0.70 ms), against 67
// TFLOP/s of f32 FMA on the CUDA cores (1.73 ms). This version reads
// 50-106 TFLOP/s at M = 8192 (PERF.md §6): each stage brings 48 KB from
// L2 for 32 k (W_lo doubles W's bytes), 3.8-4.9 TB/s of L2-to-shared
// traffic at those rates, and a warpgroup waits for its stage's products
// before it adds them and splits the next stage's fragments.
//
// Differences from the TPU kernel that do not change the contract:
//  - heads are computed one at a time: the 128-lane block-diagonal packing
//    of ops/layer.py:70-112 is a TPU lane trick.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

// the RAGGED instance (the last column tile masked) only where N % 128
// != 0, and only for K7's two launches (GELU, LayerNorm): K1's N never
// are, and no caller takes a ragged bias GEMM
template <int EPI, typename T>
cudaError_t launch_n(const void* a, const void* w, const void* w_lo,
                     const GemmArgs& g, cudaStream_t s) {
  if constexpr (EPI != EPI_BIAS) {
    if (g.N % BN != 0)
      return launch_gemm_bm<EPI, T, T, T, true>(a, w, w_lo, g, s);
  }
  return launch_gemm_bm<EPI, T, T, T, false>(a, w, w_lo, g, s);
}

template <typename T>
cudaError_t launch_epi(int epi, const void* a, const void* w, const void* w_lo,
                       const GemmArgs& g, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS:
      return launch_n<EPI_BIAS, T>(a, w, w_lo, g, s);
    case EPI_GELU:
      return launch_n<EPI_GELU, T>(a, w, w_lo, g, s);
    case EPI_LN:
      return launch_n<EPI_LN, T>(a, w, w_lo, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One of the layer's four projections. epi: 0 = +bias, 1 = +bias -> GELU,
// 2 = +bias +resid -> LayerNorm(ln_s, ln_b, eps), the LayerNorm over a
// cluster of N / 128 CTAs. f32 = 0: a, resid and out bf16, w the bf16
// (K, N) matrix, w_lo unread; f32 = 1: a, resid and out f32, w and w_lo
// the (N, K) f32 W_hi and W_lo of the (K, N) matrix (3xTF32; ops/layer.py::
// tf32_pair). Also K7's two launches (csrc/ffn.cu::dawn_ffn). Needs K a
// multiple of 16 bytes of elements (K % 8 bf16, K % 4 f32); N likewise at
// epi 1 and 2 (a last column tile past N is masked; K1 itself keeps
// N % 128 == 0) and N % 128 == 0 at epi 0; N <= 2048 for the LayerNorm
// (a cluster of ceil(N / 128) CTAs); 16-byte aligned a, w and w_lo;
// resid/ln_* are read only for epi 2. Returns a cudaError_t: a tensor
// map, shared-memory size or cluster shape the card refuses is an error,
// never a smaller launch.
int dawn_bert_gemm(const void* a, const void* w, const void* w_lo,
                   const void* bias, const void* resid, const void* ln_s,
                   const void* ln_b, void* out, int M, int N, int K, int epi,
                   float eps, int f32, void* stream) {
  const int vec = f32 ? 4 : 8;  // elements in 16 bytes
  if (M <= 0 || N <= 0 || N % vec != 0 || K <= 0 || K % vec != 0 ||
      (epi == EPI_BIAS && N % BN != 0) || (f32 && w_lo == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs g = {};
  g.bias = static_cast<const float*>(bias);
  g.resid = resid;
  g.ln_s = static_cast<const float*>(ln_s);
  g.ln_b = static_cast<const float*>(ln_b);
  g.out = out;
  g.M = M;
  g.N = N;
  g.K = K;
  g.eps = eps;
  if (f32) return (int)launch_epi<float>(epi, a, w, w_lo, g, s);
  return (int)launch_epi<bf16>(epi, a, w, w_lo, g, s);
}

const char* dawn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
