// K5 + K6: masked multi-head attention on Hopper (sm_90a), bf16 or f32.
//
// One C entry (dawn_attention) replaces two TPU kernels of
// dawnsearch_tpu/ops/attention.py:
//   K5 fused_attention_packed (body _packed_kernel, pallas_call at :198):
//      q, k, v (B, S, H), the heads packed on the feature axis;
//   K6 fused_attention (body _attn_kernel, pallas_call at :105):
//      q, k, v (B, nh, S, hd), any head dim.
// It is also K1's attention step (ops/layer.py) and K4's (csrc/
// layer_i8.cu). Three kernels, chosen by the caller's flags alone:
//   attention_kernel        bf16 in and out: K1, K5, K6 at bf16;
//   attention_tf32_kernel   f32 in and out: K1, K5, K6 at f32;
//   attention_seq_kernel    f32 out, every sum in a fixed order: K4 only,
//                           at bf16 and at f32 (its notes are below).
// Each takes base pointers with (batch, head, row) element strides, so K5
// reads q, k and v as column slices of the projection's (B·S, 3H) output
// (row stride 3H, head offset h·hd) with no split copy, and K6 reads
// head-major tensors (row stride hd). The contract keeps the reference's
// rounding points (ops/attention.py:63-77 and :157-174):
//
//   s = f32(q·kᵀ)·(1/√hd) + bias [+ rel]   softmax in f32, bias (B, S) additive
//   p = exp(s − rowmax),  l = Σ p            l over the unrounded f32 p
//   o = out_dtype( f32(dt(p)·v) · (1/l) )    dt: the compute dtype
//
// rel is the optional (nh, S, S) f32 score bias every sequence shares:
// MPNet's relative-position bias, K1's and K4's `rel_bias` operand
// (dawnsearch_tpu/ops/layer.py:70-112, `has_rel`). Each of the three terms
// rounds once, in the reference's order (scale, then bias, then rel). The
// mma.sync kernels read it from global memory in the score accumulator's
// layout (a quad of lanes reads 32 contiguous bytes of a row), issued
// before the tile's QKᵀ; it stays L2-resident across the batch (12.6 MB
// at nh = 12, S = 512, in the card's 50 MB L2).
//
// Design (the bf16 kernel). The TPU kernels hold every (S, S) score tile
// of a batch row in VMEM. A Hopper SM has 227 KB of shared memory, and K
// and V of one (sequence, head) at S = 512, hd = 128 alone take 278 KB, so
// the keys are walked in tiles of 64, twice: pass 1 finds each row's
// exact max, pass 2 recomputes the scores, forms p against that final max,
// sums l and accumulates bf16(p)·V. An online-softmax rescale would move
// the point where p is rounded; computing QKᵀ twice costs about a quarter
// more attention FLOPs (QKᵀ and PV are half each) for the exact contract.
// One CTA owns 64 query rows of one (sequence, head), 16 per warp. QKᵀ and
// PV run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with fragments
// read by ldmatrix (.trans for V) from rows padded to an odd number of 16
// bytes (no bank conflicts); the head dim is zero-padded to the next of
// 16, 32, 64 or 128 (hd = 26 runs as 32). Each warp's Q fragments stay in
// registers for both passes and its O accumulators across all key tiles.
// The scores never leave registers: scale, bias and rel are applied in the
// accumulator's layout with __fmul_rn / __fadd_rn (nvcc cannot contract
// them into an FMA the reference does not do), the row max and l are
// reduced by shuffles within the quad of lanes that shares a row, and in
// pass 2 the f32 p is rounded to bf16 in registers and used as PV's A
// fragment directly (the m16n8 accumulator layout of two key blocks is the
// A layout of m16n8k16). Both passes compute each score by the same
// instructions from the same operands, so they see bit-identical scores.
// K (pass 1) and K and V (pass 2) are staged through a ring of two
// buffers by 16-byte cp.async: tile j + 1, and the first tile of pass 2,
// are in flight while tile j computes. Rows of a head dim that is not a
// multiple of 8 (hd = 26: 52 bytes), or not 16-byte aligned, are staged
// element by element into the same ring. Each padded head dim has an
// instance with rel and one without: K5 and K6 pass none, and the
// registers of a rel tile would cost them occupancy.
//
// Design (the f32 kernel). The H100 has no f32 MMA, and one TF32 product
// keeps 10 mantissa bits. 3xTF32 splits each f32 operand x = hi + lo with
// hi = tf32(x), lo = tf32(x − hi) (cvt.rna, in registers, as a fragment
// is loaded: the tensor cores truncate an unrounded operand) and sums
// hi·hi + hi·lo + lo·hi on mma.sync m16n8k8 TF32 with f32 accumulators:
// each product to about 2^-21 relative, f32-level. QKᵀ and PV both take
// three products a k8 step. p is not rounded at f32, so the kernel runs
// one pass with a running max: each 64-key tile's scores give a new row
// max m', the context and l are rescaled by exp(m − m'), and p = exp(s −
// m') enters l and PV at once. That changes only f32 rounding (the
// reference rounds nothing there at f32) and computes QKᵀ once, which
// 3xTF32 makes three times as dear. The tensor cores round their f32
// accumulation toward zero, a bias that grows with the number of steps,
// so each tile's PV goes to fresh accumulators and the context is carried
// across tiles on the CUDA cores (o = o·corr + PV, rounded to nearest);
// a score takes at most 48 steps (hd 128). The tile shapes, the ring of
// two K and V buffers by cp.async, the quad shuffles and the rel reads are
// the bf16 kernel's; Q and K are read as two k-adjacent floats a lane (the k index
// of an m16n8k8 step is permuted, see the kernel), so no fragment is
// shuffled, and a score block's accumulator is PV's A fragment as it lies.
// Rows of a head dim that is not a multiple of 4 floats (hd = 26), or not
// 16-byte aligned, are staged element by element.
//
// What bounds them. Attention is ~1% of a MiniLM layer's FLOPs: at B = 64,
// S = 128, H = 384 it does 1.6 GFLOP and must move 25 MB of bf16 (q, k, v,
// out), so the byte bound (7.5 µs at 3.35 TB/s) is the larger one; in f32
// it moves twice the bytes and does three TF32 products for each
// multiply-add, 4.9 GFLOP at 495 TFLOP/s (9.9 µs). K and V are re-read once
// per 64-query tile (and per pass in bf16), from L2, and a warp's work
// between two barriers is one 16 x 64 score tile: at S = 512 the bf16
// kernel is bound by that per-tile latency, the second QKᵀ and the
// softmax's exact expf, and reads about 1.4x SDPA (PERF.md §6), which
// computes QKᵀ once under an online softmax. The f32 kernel also splits
// every operand it loads: three CUDA-core instructions (two cvt and a
// subtract) per element, beside the three tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 64;          // query rows per CTA: 16 per warp
constexpr int KT = 64;          // keys per staged tile
constexpr int THREADS = 128;
constexpr int MAX_S = 512;

struct Strides {
  long long b, h, r;            // elements between batches, heads, rows
};

// Shared memory of the HDP (padded head dim) instance, in bytes: Q (QT
// rows), the ring of two K and two V tiles (KT rows each), as bf16 rows of
// HDP + 8 (16-byte aligned, an odd number of 16 bytes apart); the key bias
// row (S).
template <int HDP>
struct Smem {
  static constexpr int LD = HDP + 8;
  static constexpr size_t tile = align128((size_t)KT * LD * sizeof(bf16));
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128((size_t)QT * LD * sizeof(bf16));
  static constexpr size_t v = k + 2 * tile;
  static constexpr size_t bias = v + 2 * tile;
  static constexpr size_t bytes(int S) {
    return bias + align128((size_t)S * sizeof(float));
  }
};

// rows x HDP tile of a strided source into shared memory (row pitch
// HDP + 8): rows >= valid and columns >= hd are zero. vec (hd, the row
// stride and the base are multiples of 8 elements): 16-byte cp.async, in
// flight until the caller's cp_async_wait; else element by element.
template <int HDP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long rstride, int rows, int valid,
                                      int hd, bool vec) {
  constexpr int LD = HDP + 8;
  if (vec) {
    constexpr int CPR = HDP / 8;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      const bool ok = r < valid && c < hd;
      sm90::cp_async16(dst + r * LD + c, ok ? src + r * rstride + c : src,
                       ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int idx = threadIdx.x; idx < rows * HDP; idx += THREADS) {
      const int r = idx / HDP, c = idx % HDP;
      dst[r * LD + c] = (r < valid && c < hd) ? src[r * rstride + c] : zero;
    }
  }
}

// grid (ceil(S / QT), nh, B): query rows [blockIdx.x·QT, +QT) of head
// blockIdx.y of sequence blockIdx.z. S % 16 == 0, so a warp's 16 rows are
// all valid or all past the end, and a key tile holds a multiple of 16
// keys. A lane holds the scores and outputs of rows g = lane / 4 and g + 8
// of its warp's 16, at columns 8·n + 2·(lane % 4) + {0, 1} of each 8-wide
// block n (element e of a block: row g + 8·(e / 2), column + e % 2).
template <int HDP, bool REL>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ rel, bf16* __restrict__ out, int S,
                 int hd, Strides in, Strides ot, float scale, int vec_in,
                 int vec_out) {
  using L = Smem<HDP>;
  constexpr int LD = L::LD;
  constexpr int NK = HDP / 16;   // k16 steps of QKᵀ
  constexpr int NO = HDP / 8;    // 8-wide output blocks
  constexpr int NS = KT / 8;     // 8-wide score blocks of a key tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  float* Bs = reinterpret_cast<float*>(smem + L::bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long in_off = (long long)b * in.b + (long long)h * in.h;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;
  const bool active = q0 + warp * 16 < S;   // warp-uniform
  const int tiles = (S + KT - 1) / KT;
  // step j < tiles: pass 1 over key tile j (K); step tiles + j: pass 2
  // over tile j (K and V); step s uses ring buffer s & 1
  auto issue = [&](int step) {
    const int k0 = (step < tiles ? step : step - tiles) * KT;
    const int kn = min(KT, S - k0);
    bf16* kd = reinterpret_cast<bf16*>(smem + L::k + (step & 1) * L::tile);
    stage<HDP>(kd, kb + (long long)k0 * in.r, in.r, KT, kn, hd, vec_in);
    if (step >= tiles) {
      bf16* vd = reinterpret_cast<bf16*>(smem + L::v + (step & 1) * L::tile);
      stage<HDP>(vd, vb + (long long)k0 * in.r, in.r, KT, kn, hd, vec_in);
    }
  };

  stage<HDP>(Qs, q + in_off + (long long)q0 * in.r, in.r, QT,
             min(QT, S - q0), hd, vec_in);
  issue(0);
  sm90::cp_async_commit();
  for (int j = threadIdx.x; j < S; j += THREADS)
    Bs[j] = bias[(long long)b * S + j];

  uint32_t qf[NK][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float* relw =
      REL ? rel + ((long long)h * S + q0 + warp * 16 + g) * S : nullptr;

  for (int step = 0; step < 2 * tiles; ++step) {
    if (step + 1 < 2 * tiles) issue(step + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();               // this step's tiles have landed
    __syncthreads();
    const bool pass2 = step >= tiles;
    const int k0 = (pass2 ? step - tiles : step) * KT;
    const int kn = min(KT, S - k0);
    const bf16* Kt =
        reinterpret_cast<const bf16*>(smem + L::k + (step & 1) * L::tile);
    const bf16* Vt =
        reinterpret_cast<const bf16*>(smem + L::v + (step & 1) * L::tile);
    if (active) {
      if (step == 0) {
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          sm90::ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 8 +
                                          ((lane / 8) % 2) * 8) * LD +
                                             kc * 16 + (lane / 16) * 8);
      }
      float rv[NS][4];
      if (REL) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (n * 8 < kn) {
            const int c = k0 + n * 8 + 2 * t4;
            rv[n][0] = relw[c];
            rv[n][1] = relw[c + 1];
            rv[n][2] = relw[8LL * S + c];
            rv[n][3] = relw[8LL * S + c + 1];
          }
      }
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        if (np * 16 < kn) {
#pragma unroll
          for (int kc = 0; kc < NK; ++kc) {
            uint32_t kf[4];
            sm90::ldmatrix_x4(kf, Kt + ((2 * np + lane / 16) * 8 + lane % 8) *
                                           LD + kc * 16 + ((lane / 8) % 2) * 8);
            sm90::mma_bf16_16816(s[2 * np], qf[kc], kf[0], kf[1]);
            sm90::mma_bf16_16816(s[2 * np + 1], qf[kc], kf[2], kf[3]);
          }
        }
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n * 8 < kn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sc = __fadd_rn(__fmul_rn(s[n][e], scale),
                                 Bs[k0 + n * 8 + 2 * t4 + (e & 1)]);
            if (REL) sc = __fadd_rn(sc, rv[n][e]);
            if (!pass2) {
              m[e / 2] = fmaxf(m[e / 2], sc);
            } else {
              const float p = expf(__fsub_rn(sc, m[e / 2]));
              l[e / 2] += p;
              s[n][e] = p;
            }
          }
        }
      if (pass2) {
#pragma unroll
        for (int kc = 0; kc < KT / 16; ++kc)
          if (kc * 16 < kn) {
            const uint32_t pa[4] = {
                sm90::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                sm90::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                sm90::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                sm90::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
            for (int op = 0; op < NO / 2; ++op) {
              uint32_t vf[4];
              sm90::ldmatrix_x4_trans(
                  vf, Vt + (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                          (2 * op + lane / 16) * 8);
              sm90::mma_bf16_16816(o[2 * op], pa, vf[0], vf[1]);
              sm90::mma_bf16_16816(o[2 * op + 1], pa, vf[2], vf[3]);
            }
          }
      } else if (step == tiles - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
        }
      }
    }
    __syncthreads();                        // the buffer is refilled next
  }

  // o = out_dtype(O · (1/l)), straight from the accumulators
  if (active) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.0f / l[i];
    }
    bf16* ob = out + (long long)b * ot.b + (long long)h * ot.h +
               (long long)(q0 + warp * 16 + g) * ot.r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bf16* row = ob + i * 8 * ot.r;
        const float y0 = __fmul_rn(o[n][2 * i], inv[i]);
        const float y1 = __fmul_rn(o[n][2 * i + 1], inv[i]);
        if (vec_out) {
          if (c < hd)
            *reinterpret_cast<__nv_bfloat162*>(row + c) =
                __floats2bfloat162_rn(y0, y1);
        } else {
          if (c < hd) row[c] = __float2bfloat16(y0);
          if (c + 1 < hd) row[c + 1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

template <int HDP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, const float* rel, bf16* out, int B,
                   int nh, int S, int hd, Strides in, Strides ot, float scale,
                   bool vec_in, bool vec_out, cudaStream_t stream) {
  // an instance without rel spares the registers of its tile
  auto kernel = rel ? attention_kernel<HDP, true> : attention_kernel<HDP, false>;
  const size_t smem = Smem<HDP>::bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + QT - 1) / QT, nh, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, bias, rel, out, S, hd, in,
                                          ot, scale, vec_in, vec_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 kernel: K1's attention step, K5 and K6 at compute_dtype = "f32"
// (f32 q, k, v and out, p unrounded), on mma.sync m16n8k8 TF32 with every
// product split 3xTF32. Notes at the head of the file.

// Shared memory of the HDP instance, in bytes: Q (QT rows) and the ring of
// two K tiles as f32 rows of HDP + 8 (a lane's two k-adjacent fragment
// values are one conflict-free 8-byte load), two V tiles as rows of HDP +
// 4 (a lane reads one column at a key pair: conflict-free 4-byte loads);
// the key bias row (S).
template <int HDP>
struct Smem32 {
  static constexpr int LDK = HDP + 8;
  static constexpr int LDV = HDP + 4;
  static constexpr size_t ktile = align128((size_t)KT * LDK * sizeof(float));
  static constexpr size_t vtile = align128((size_t)KT * LDV * sizeof(float));
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128((size_t)QT * LDK * sizeof(float));
  static constexpr size_t v = k + 2 * ktile;
  static constexpr size_t bias = v + 2 * vtile;
  static constexpr size_t bytes(int S) {
    return bias + align128((size_t)S * sizeof(float));
  }
};

// rows x HDP f32 tile of a strided source into shared memory (row pitch
// LD): rows >= valid and columns >= hd are zero. vec (hd, the row stride
// and the base are multiples of 4 elements): 16-byte cp.async; else
// element by element.
template <int LD, int HDP>
__device__ __forceinline__ void stage32(float* dst, const float* src,
                                        long long rstride, int rows,
                                        int valid, int hd, bool vec) {
  if (vec) {
    constexpr int CPR = HDP / 4;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 4;
      const bool ok = r < valid && c < hd;
      sm90::cp_async16(dst + r * LD + c, ok ? src + r * rstride + c : src,
                       ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * HDP; idx += THREADS) {
      const int r = idx / HDP, c = idx % HDP;
      dst[r * LD + c] = (r < valid && c < hd) ? src[r * rstride + c] : 0.0f;
    }
  }
}

// grid (ceil(S / QT), nh, B), as the bf16 kernel. A lane's scores and
// outputs are mma_tf32_1688's accumulator: rows g and g + 8 of its warp's
// 16, columns 8·n + 2·t4 + {0, 1} of each 8-wide block n. Within every k8
// step the operands' k index t4 stands for element 2·t4 and t4 + 4 for
// 2·t4 + 1 (a sum over k is the same in any order): so a lane's Q and K
// fragments are two adjacent floats of a row, and a score block's
// accumulator is PV's A fragment as it lies (c0, c2, c1, c3 = keys 2·t4 of
// rows g, g + 8, then keys 2·t4 + 1), with V read at the same key pairs.
template <int HDP, bool REL>
__global__ void __launch_bounds__(THREADS)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ rel, float* __restrict__ out,
                      int S, int hd, Strides in, Strides ot, float scale,
                      int vec_in, int vec_out) {
  using L = Smem32<HDP>;
  constexpr int LDK = L::LDK, LDV = L::LDV;
  constexpr int NK = HDP / 8;    // k8 steps of QKᵀ
  constexpr int NO = HDP / 8;    // 8-wide output blocks
  constexpr int NS = KT / 8;     // 8-wide score blocks of a key tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Bs = reinterpret_cast<float*>(smem + L::bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long in_off = (long long)b * in.b + (long long)h * in.h;
  const float* kb = k + in_off;
  const float* vb = v + in_off;
  const bool active = q0 + warp * 16 < S;   // warp-uniform
  const int tiles = (S + KT - 1) / KT;
  // key tile j into ring buffer j & 1
  auto issue = [&](int j) {
    const int k0 = j * KT, kn = min(KT, S - k0);
    stage32<LDK, HDP>(reinterpret_cast<float*>(smem + L::k + (j & 1) * L::ktile),
                      kb + (long long)k0 * in.r, in.r, KT, kn, hd, vec_in);
    stage32<LDV, HDP>(reinterpret_cast<float*>(smem + L::v + (j & 1) * L::vtile),
                      vb + (long long)k0 * in.r, in.r, KT, kn, hd, vec_in);
  };

  stage32<LDK, HDP>(Qs, q + in_off + (long long)q0 * in.r, in.r, QT,
                    min(QT, S - q0), hd, vec_in);
  issue(0);
  sm90::cp_async_commit();
  for (int j = threadIdx.x; j < S; j += THREADS)
    Bs[j] = bias[(long long)b * S + j];

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float* relw =
      REL ? rel + ((long long)h * S + q0 + warp * 16 + g) * S : nullptr;
  const float* Qw = Qs + (warp * 16 + g) * LDK + 2 * t4;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) issue(j + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();               // tile j has landed
    __syncthreads();
    const int k0 = j * KT, kn = min(KT, S - k0);
    const float* Kt =
        reinterpret_cast<const float*>(smem + L::k + (j & 1) * L::ktile);
    const float* Vt =
        reinterpret_cast<const float*>(smem + L::v + (j & 1) * L::vtile);
    if (active) {
      float rv[NS][4];
      if (REL) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (n * 8 < kn) {
            const int c = k0 + n * 8 + 2 * t4;
            rv[n][0] = relw[c];
            rv[n][1] = relw[c + 1];
            rv[n][2] = relw[8LL * S + c];
            rv[n][3] = relw[8LL * S + c + 1];
          }
      }
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        const float2 qa = *reinterpret_cast<const float2*>(Qw + kc * 8);
        const float2 qc = *reinterpret_cast<const float2*>(Qw + 8 * LDK + kc * 8);
        uint32_t ah[4], al[4];
        sm90::split_tf32(qa.x, ah[0], al[0]);
        sm90::split_tf32(qc.x, ah[1], al[1]);
        sm90::split_tf32(qa.y, ah[2], al[2]);
        sm90::split_tf32(qc.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (n * 8 < kn) {
            const float2 kv = *reinterpret_cast<const float2*>(
                Kt + (n * 8 + g) * LDK + kc * 8 + 2 * t4);
            uint32_t bh0, bl0, bh1, bl1;
            sm90::split_tf32(kv.x, bh0, bl0);
            sm90::split_tf32(kv.y, bh1, bl1);
            sm90::mma_tf32x3_1688(s[n], ah, al, bh0, bh1, bl0, bl1);
          }
      }
      // s = ((dot·scale) + bias) + rel, then the running max over the
      // tile's valid keys (a quad of lanes shares a row)
      float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n * 8 < kn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sc = __fadd_rn(__fmul_rn(s[n][e], scale),
                                 Bs[k0 + n * 8 + 2 * t4 + (e & 1)]);
            if (REL) sc = __fadd_rn(sc, rv[n][e]);
            s[n][e] = sc;
            tm[e / 2] = fmaxf(tm[e / 2], sc);
          }
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
        tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 2));
        const float mn = fmaxf(m[i], tm[i]);
        corr[i] = expf(m[i] - mn);            // 0 at the first tile
        m[i] = mn;
        l[i] *= corr[i];
      }
      // p = exp(s − m) against the running max, l, and the tile's PV in
      // fresh accumulators: the tensor cores round their f32 sums toward
      // zero, so the context is carried across tiles on the CUDA cores,
      // o = o·corr + PV rounded to nearest
      float pv[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < NS; ++kc)
        if (kc * 8 < kn) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = expf(__fsub_rn(s[kc][e], m[e / 2]));
            l[e / 2] += p[e];
          }
          uint32_t ah[4], al[4];
          sm90::split_tf32(p[0], ah[0], al[0]);
          sm90::split_tf32(p[2], ah[1], al[1]);
          sm90::split_tf32(p[1], ah[2], al[2]);
          sm90::split_tf32(p[3], ah[3], al[3]);
          const float* vr = Vt + (kc * 8 + 2 * t4) * LDV + g;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            sm90::split_tf32(vr[n * 8], bh0, bl0);
            sm90::split_tf32(vr[LDV + n * 8], bh1, bl1);
            sm90::mma_tf32x3_1688(pv[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = fmaf(o[n][e], corr[e / 2], pv[n][e]);
    }
    __syncthreads();                        // the buffer is refilled next
  }

  // o = O · (1/l), straight from the accumulators
  if (active) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.0f / l[i];
    }
    float* ob = out + (long long)b * ot.b + (long long)h * ot.h +
                (long long)(q0 + warp * 16 + g) * ot.r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = ob + i * 8 * ot.r;
        const float y0 = __fmul_rn(o[n][2 * i], inv[i]);
        const float y1 = __fmul_rn(o[n][2 * i + 1], inv[i]);
        if (vec_out) {
          if (c < hd) *reinterpret_cast<float2*>(row + c) = make_float2(y0, y1);
        } else {
          if (c < hd) row[c] = y0;
          if (c + 1 < hd) row[c + 1] = y1;
        }
      }
    }
  }
}

template <int HDP>
cudaError_t launch_tf32(const float* q, const float* k, const float* v,
                        const float* bias, const float* rel, float* out, int B,
                        int nh, int S, int hd, Strides in, Strides ot,
                        float scale, bool vec_in, bool vec_out,
                        cudaStream_t stream) {
  auto kernel = rel ? attention_tf32_kernel<HDP, true>
                    : attention_tf32_kernel<HDP, false>;
  const size_t smem = Smem32<HDP>::bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + QT - 1) / QT, nh, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, bias, rel, out, S, hd, in,
                                          ot, scale, vec_in, vec_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fixed-order kernel: K4's attention step, at bf16 and at f32, and
// nothing else. The same contract with an f32 output, as
// dawnsearch_tpu/ops/layer.py::_layer_kernel_i8 keeps its context in f32
// (:199-201), and with every sum in one fixed order:
//
//   s_ij = (((q_i0·k_j0) + q_i1·k_j1) + ...)   over d ascending
//   l_i  = ((p_i0 + p_i1) + ...)               over keys ascending
//   o_id = ((p̂_i0·v_0d + p̂_i1·v_1d) + ...)     over keys ascending
//
// p̂ is p rounded to bf16 for bf16 inputs and p itself for f32 inputs:
// the reference rounds p to the compute dtype (ops/layer.py:104,
// ops/attention.py:73,166). Every step rounds once, as a plain twin
// written as the same ascending loops does (ops/layer.py::
// attention_f32_plain): a bf16 x bf16 product is exact in f32, so an FMA
// rounds as a product-then-add does; an f32 x f32 product is not, so the
// f32 instance writes each step as __fadd_rn(acc, __fmul_rn(a, b)), which
// nvcc cannot contract, as eager torch rounds the product and the sum.
// Why: K4 re-quantizes the context to i8 per row, and one ulp of
// difference in ctx can flip a code, which the next three quantizations
// amplify; with the tensor cores' accumulation order a few tokens in 4096
// drift to a cosine of 0.9999 from a plain twin that sums in another
// order. Fixed-order sums keep K4 and its twin equal. K1, K5 and K6 are
// held to a tolerance, not to their twins' bits, and run the mma.sync
// kernels above; K4 asks for this one by dawn_attention's fixed_order.
//
// Design: CUDA-core FMAs (no tensor cores). One CTA owns 32 query rows of
// one (sequence, head) and all S of their scores, kept in shared memory
// (64 KB at S = 512): pass 1 walks 64-key tiles of K, computes each score
// once and the row maxima; pass 2 walks the tiles of V, turns the stored
// scores into p, sums l and accumulates PV. Q, K and V are staged as f32.
// A thread computes a 4 x 4 block of scores (queries qb + 8i, keys
// kb + 16j) and a 4 x DPT block of outputs; 32 threads sum l, one row
// each. The order of every sum is the loop order above, whatever the
// thread mapping. It costs 2·B·nh·S²·hd f32 FMAs (QKᵀ and PV once each):
// at 67 TFLOP/s of f32 FMA that bounds it, far above the bytes it moves.
// rel, when given, is added to each score after the bias, as in the
// mma.sync kernels; the staged rows past the sequence's end read none
// (they add 0 and are never written out).
constexpr int SQ_QT = 32;
constexpr int SQ_KT = 64;
constexpr int SQ_THREADS = 128;

__host__ __device__ constexpr int sq_ld(int hdp) { return hdp + 1; }

size_t sq_smem_bytes(int hdp, int S) {
  return sizeof(float) * ((size_t)SQ_QT * sq_ld(hdp) +          // Q
                          (size_t)SQ_KT * sq_ld(hdp) +          // K or V
                          (size_t)SQ_QT * (S + 1) +             // s, then p
                          (size_t)SQ_QT * (SQ_KT + 1) +         // p̂ tile
                          SQ_QT + (size_t)S);                   // l, bias
}

// acc + a·b rounded as the plain twin rounds it: one FMA for bf16 inputs
// (the product is exact), a rounded product then a rounded sum for f32
template <typename T>
__device__ __forceinline__ float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
template <>
__device__ __forceinline__ float mac<float>(float a, float b, float acc) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// p̂: p rounded to the input dtype
template <typename T>
__device__ __forceinline__ float rounded(float p) {
  return __bfloat162float(__float2bfloat16(p));
}
template <>
__device__ __forceinline__ float rounded<float>(float p) { return p; }

// rows x hd tile of a strided source as f32 (row pitch ld); rows >= valid
// are zero
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src,
                                         long long rstride, int rows,
                                         int valid, int hd) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += SQ_THREADS) {
    const int r = idx / hd, c = idx % hd;
    dst[r * ld + c] = r < valid ? to_f32(src[r * rstride + c]) : 0.0f;
  }
}

template <int HDP, typename T>
__global__ void __launch_bounds__(SQ_THREADS)
attention_seq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ rel, float* __restrict__ out,
                     int S, int hd, Strides in, Strides ot, float scale) {
  constexpr int LD = sq_ld(HDP), PLD = SQ_KT + 1, DPT = HDP / 16;
  extern __shared__ __align__(16) float sm[];
  const int SLD = S + 1;
  float* Qs = sm;
  float* Ts = Qs + SQ_QT * LD;        // the staged K (pass 1) or V (pass 2)
  float* Ss = Ts + SQ_KT * LD;        // every score of the CTA's rows, then p
  float* Pb = Ss + SQ_QT * SLD;       // p̂ of one key tile
  float* Ls = Pb + SQ_QT * PLD;
  float* Bs = Ls + SQ_QT;

  const int t = threadIdx.x, qb = t / 16, kb = t % 16;
  const int q0 = blockIdx.x * SQ_QT, h = blockIdx.y, b = blockIdx.z;
  const long long in_off = (long long)b * in.b + (long long)h * in.h;
  const int q_valid = min(SQ_QT, S - q0);
  load_f32(Qs, LD, q + in_off + (long long)q0 * in.r, in.r, SQ_QT, q_valid, hd);
  for (int j = t; j < S; j += SQ_THREADS) Bs[j] = bias[(long long)b * S + j];

  const float* relq = rel ? rel + ((long long)h * S + q0) * S : nullptr;

  // pass 1: s = (q·k)·scale + bias [+ rel] for queries qb + 8i and keys kb + 16j
  // of each tile (keys past the tile's kn are computed on zero rows and
  // dropped), and the row maxima (order-free). The tile's rel values are
  // loaded before its dot products, which hide their latency.
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < S; k0 += SQ_KT) {
    const int kn = min(SQ_KT, S - k0);
    float rv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = qb + 8 * i, key = kb + 16 * j;
        rv[i][j] = relq && r < q_valid && key < kn
                       ? relq[(long long)r * S + k0 + key] : 0.0f;
      }
    __syncthreads();
    load_f32(Ts, LD, k + in_off + (long long)k0 * in.r, in.r, SQ_KT, kn, hd);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(qb + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ts[(kb + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = mac<T>(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kb + 16 * j;
      if (key >= kn) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = qb + 8 * i;
        float sv = __fadd_rn(__fmul_rn(sc[i][j], scale), Bs[k0 + key]);
        if (relq) sv = __fadd_rn(sv, rv[i][j]);
        Ss[r * SLD + k0 + key] = sv;
        m[i] = fmaxf(m[i], sv);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));

  // pass 2: p, l and PV, each summed over keys in ascending order
  const int db = t % 16;               // PV: queries qb + 8i, dims db + 16e
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.0f;
  float l = 0.0f;                      // threads t < SQ_QT: row t's sum
  for (int k0 = 0; k0 < S; k0 += SQ_KT) {
    const int kn = min(SQ_KT, S - k0);
    __syncthreads();
    load_f32(Ts, LD, v + in_off + (long long)k0 * in.r, in.r, SQ_KT, kn, hd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kb + 16 * j;
      if (key >= kn) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* sp = Ss + (qb + 8 * i) * SLD + k0 + key;
        const float p = expf(__fsub_rn(*sp, m[i]));
        *sp = p;
        Pb[(qb + 8 * i) * PLD + key] = rounded<T>(p);
      }
    }
    __syncthreads();
    if (t < SQ_QT)
      for (int j = 0; j < kn; ++j) l = __fadd_rn(l, Ss[t * SLD + k0 + j]);
    for (int j = 0; j < kn; ++j) {
      float vv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = Ts[j * LD + db + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pb = Pb[(qb + 8 * i) * PLD + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = mac<T>(pb, vv[e], acc[i][e]);
      }
    }
  }
  if (t < SQ_QT) Ls[t] = l;
  __syncthreads();

  float* ob = out + (long long)b * ot.b + (long long)h * ot.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = qb + 8 * i;
    if (r >= q_valid) continue;
    const float inv = 1.0f / Ls[r];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = db + 16 * e;
      if (d < hd) ob[(long long)(q0 + r) * ot.r + d] = __fmul_rn(acc[i][e], inv);
    }
  }
}

template <int HDP, typename T>
cudaError_t launch_seq(const void* q, const void* k, const void* v,
                       const float* bias, const float* rel, float* out, int B,
                       int nh, int S, int hd, Strides in, Strides ot,
                       float scale, cudaStream_t stream) {
  const size_t smem = sq_smem_bytes(HDP, S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_seq_kernel<HDP, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + SQ_QT - 1) / SQ_QT, nh, B);
  attention_seq_kernel<HDP, T><<<grid, SQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, rel, out, S, hd, in, ot, scale);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// launch<HDP> of the padded head dim of hd: one instance per power of two
// (each costs seconds of nvcc, and head dims between them are rare)
template <typename F>
cudaError_t by_head_dim(int hd, F&& launch_hdp) {
  if (hd <= 16) return launch_hdp(std::integral_constant<int, 16>());
  if (hd <= 32) return launch_hdp(std::integral_constant<int, 32>());
  if (hd <= 64) return launch_hdp(std::integral_constant<int, 64>());
  return launch_hdp(std::integral_constant<int, 128>());
}

}  // namespace

extern "C" {

// Masked attention of every (sequence, head): q, k and v share the
// element strides (in_b, in_h, in_r) and have unit stride along the head
// dim; out has (out_b, out_h, out_r). Three kernels, chosen by the flags
// alone:
//   fixed_order = 0, in_f32 = 0: bf16 q, k, v and out, the bf16 mma.sync
//     kernel (K1, K5, K6 at bf16);
//   fixed_order = 0, in_f32 = 1: f32 q, k, v and out, the 3xTF32 mma.sync
//     kernel (K1, K5, K6 at f32);
//   fixed_order = 1: bf16 (in_f32 = 0) or f32 q, k, v and an f32 out, the
//     fixed-order kernel (K4 at either dtype).
// out_f32 states the output's dtype and must be what the kernel writes.
// bias is the (B, S) f32 additive key bias; rel, nullable, the contiguous
// (nh, S, S) f32 score bias shared by every sequence (K1's and K4's
// rel_bias; K5 and K6 pass none). Needs 1 <= hd <= 128, S % 16 == 0,
// S <= 512. Returns a cudaError_t.
int dawn_attention(const void* q, const void* k, const void* v,
                   const void* bias, const void* rel, void* out, int B, int nh,
                   int S, int hd, long long in_b, long long in_h,
                   long long in_r, long long out_b, long long out_h,
                   long long out_r, float scale, int out_f32, int in_f32,
                   int fixed_order, void* stream) {
  const bool f32_out_wanted = fixed_order || in_f32;
  if (B <= 0 || nh <= 0 || S <= 0 || S % 16 != 0 || S > MAX_S || hd <= 0 ||
      hd > 128 || B > 65535 || nh > 65535 || (out_f32 != 0) != f32_out_wanted)
    return (int)cudaErrorInvalidValue;
  const Strides in{in_b, in_h, in_r}, ot{out_b, out_h, out_r};
  const float* bp = static_cast<const float*>(bias);
  const float* rp = static_cast<const float*>(rel);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_order) {
    float* of = static_cast<float*>(out);
    return (int)by_head_dim(hd, [&](auto hdp) {
      constexpr int HDP = decltype(hdp)::value;
      return in_f32 ? launch_seq<HDP, float>(q, k, v, bp, rp, of, B, nh, S,
                                             hd, in, ot, scale, s)
                    : launch_seq<HDP, bf16>(q, k, v, bp, rp, of, B, nh, S, hd,
                                            in, ot, scale, s);
    });
  }
  // 16-byte rows for cp.async: hd, the strides and the bases in whole
  // 16-byte units; the output in pairs of elements
  const int per16 = in_f32 ? 4 : 8, esize = in_f32 ? 4 : 2;
  const bool vec_in = hd % per16 == 0 && in_b % per16 == 0 &&
                      in_h % per16 == 0 && in_r % per16 == 0 &&
                      aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  if (in_f32) {
    const bool vec_out = hd % 2 == 0 && out_b % 2 == 0 && out_h % 2 == 0 &&
                         out_r % 2 == 0 && aligned(out, 2 * esize);
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    float* op = static_cast<float*>(out);
    return (int)by_head_dim(hd, [&](auto hdp) {
      constexpr int HDP = decltype(hdp)::value;
      return launch_tf32<HDP>(qp, kp, vp, bp, rp, op, B, nh, S, hd, in, ot,
                              scale, vec_in, vec_out, s);
    });
  }
  const bool vec_out = hd % 8 == 0 && out_b % 8 == 0 && out_h % 8 == 0 &&
                       out_r % 8 == 0 && aligned(out, 16);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  return (int)by_head_dim(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    return launch<HDP>(qp, kp, vp, bp, rp, op, B, nh, S, hd, in, ot, scale,
                       vec_in, vec_out, s);
  });
}

}  // extern "C"
