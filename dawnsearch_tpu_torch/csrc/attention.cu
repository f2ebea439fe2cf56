// K5 + K6: masked multi-head attention on Hopper (sm_90a), bf16 in / out.
//
// One kernel replaces two TPU kernels of dawnsearch_tpu/ops/attention.py:
//   K5 fused_attention_packed (body _packed_kernel, pallas_call at :198):
//      q, k, v (B, S, H), the heads packed on the feature axis;
//   K6 fused_attention (body _attn_kernel, pallas_call at :105):
//      q, k, v (B, nh, S, hd), any head dim.
// It takes base pointers with (batch, head, row) element strides, so K5
// reads q, k and v as column slices of the projection's (B·S, 3H) output
// (row stride 3H, head offset h·hd) with no split copy, and K6 reads
// head-major tensors (row stride hd). The contract keeps the reference's
// rounding points (ops/attention.py:63-77 and :157-174):
//
//   s = f32(q·kᵀ)·(1/√hd) + bias      softmax in f32, bias (B, S) additive
//   p = exp(s − rowmax),  l = Σ p       l over the unrounded f32 p
//   o = out_dtype( f32(bf16(p)·v) · (1/l) )
//
// Design. The TPU kernels hold every (S, S) score tile of a batch row in
// VMEM. A Hopper SM has 227 KB of shared memory, and K and V of one
// (sequence, head) at S = 512, hd = 128 alone take 278 KB, so the keys are
// walked in tiles of 64, twice: pass 1 finds each row's max, pass 2
// recomputes the scores, forms p against that final max, sums l and
// accumulates bf16(p)·V. An online-softmax rescale would move the point
// where p is rounded; computing QKᵀ twice costs about a quarter more
// attention FLOPs (QKᵀ and PV are half each) for the exact contract. One
// CTA owns 64 query rows of one (sequence, head), 16 per warp; each warp's
// Q fragments stay in registers for both passes and its O accumulators
// across all key tiles. QKᵀ and PV run on bf16 WMMA (16x16x16, f32
// accumulate); the head dim is zero-padded in shared memory to the next of
// 16, 32, 64 or 128 (hd = 26 runs as 32). Softmax runs on the CUDA cores,
// two lanes per row. Scale and bias are applied with __fmul_rn /
// __fadd_rn so nvcc cannot contract them into an FMA the reference does
// not do.
//
// What bounds it. Attention is ~1% of a MiniLM layer's FLOPs: at B = 64,
// S = 128, H = 384 it does 1.6 GFLOP and must move 25 MB (q, k, v, out),
// so the byte bound (7.5 µs at 3.35 TB/s) is the larger one. This first
// version stages tiles synchronously (no cp.async / TMA ring) and re-reads
// K and V once per 64-query tile and per pass from L2; it is bound by load
// latency and WMMA dispatch, not by HBM. Rows of a head dim that is not a
// multiple of 8 (hd = 26: 52 bytes) are staged element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 64;          // query rows per CTA: 16 per warp
constexpr int KT = 64;          // keys per staged tile
constexpr int THREADS = 128;
constexpr int S_LD = KT + 4;    // f32 score rows (a warp's 16 x KT slice)
constexpr int P_LD = KT + 8;    // bf16 probability rows
constexpr int MAX_S = 512;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

struct Strides {
  long long b, h, r;            // elements between batches, heads, rows
};

// Shared memory of the HDP (padded head dim) instance, in bytes:
//   Q (QT rows), K and V (KT rows each) as bf16 rows of HDP + 8;
//   f32 scores (QT x S_LD); bf16 p (QT x P_LD); 1/l per row; bias (S).
// The f32 output tile (QT x HDP + 4) reuses the K and V region after the
// last key tile: 2·KT·(HDP + 8)·2 >= QT·(HDP + 4)·4 for QT == KT.
template <int HDP>
struct Smem {
  static constexpr int LD = HDP + 8;
  static constexpr int O_LD = HDP + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128((size_t)QT * LD * sizeof(bf16));
  static constexpr size_t v = k + align128((size_t)KT * LD * sizeof(bf16));
  static constexpr size_t s = v + align128((size_t)KT * LD * sizeof(bf16));
  static constexpr size_t p = s + align128((size_t)QT * S_LD * sizeof(float));
  static constexpr size_t inv = p + align128((size_t)QT * P_LD * sizeof(bf16));
  static constexpr size_t bias = inv + align128((size_t)QT * sizeof(float));
  static constexpr size_t bytes(int S) {
    return bias + align128((size_t)S * sizeof(float));
  }
  static_assert((size_t)QT * O_LD * sizeof(float) <= s - k,
                "output tile must fit the K and V region");
};

// rows x HDP tile of a strided source into shared memory (row pitch
// HDP + 8): rows >= valid and columns >= hd are zero. vec: hd, the row
// stride and the base are multiples of 8 elements (16-byte loads).
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rstride, int rows,
                                          int valid, int hd, bool vec) {
  constexpr int LD = HDP + 8;
  if (vec) {
    constexpr int CPR = HDP / 8;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < hd)
        val = *reinterpret_cast<const uint4*>(src + r * rstride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
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
// all valid or all past the end.
template <int HDP>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, int S, int hd, Strides in,
                 Strides ot, float scale, int vec_in, int vec_out) {
  using L = Smem<HDP>;
  constexpr int LD = L::LD, NF = HDP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Inv = reinterpret_cast<float*>(smem + L::inv);
  float* Bs = reinterpret_cast<float*>(smem + L::bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long in_off = (long long)b * in.b + (long long)h * in.h;
  const bf16* qb = q + in_off;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;
  const bool active = q0 + warp * 16 < S;   // warp-uniform
  float* Sw = Ss + warp * 16 * S_LD;
  bf16* Pw = Ps + warp * 16 * P_LD;
  const int row = lane >> 1, half = lane & 1;   // softmax: 2 lanes a row
  const int q_valid = min(QT, S - q0);

  load_tile<HDP>(Qs, qb + (long long)q0 * in.r, in.r, QT, q_valid, hd,
                 vec_in);
  for (int j = threadIdx.x; j < S; j += THREADS)
    Bs[j] = bias[(long long)b * S + j];
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[NF];
  if (active) {
#pragma unroll
    for (int i = 0; i < NF; ++i)
      wmma::load_matrix_sync(qf[i], Qs + warp * 16 * LD + i * 16, LD);
  }

  // Sw[0:16, 0:kn] = this warp's Q rows · K tileᵀ (raw f32 dots)
  auto scores = [&](int kn) {
    for (int fn = 0; fn < kn / 16; ++fn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + fn * 16 * LD + i * 16, LD);
        wmma::mma_sync(acc, qf[i], kf, acc);
      }
      wmma::store_matrix_sync(Sw + fn * 16, acc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: each row's max of s
  float m = -INFINITY;
  for (int k0 = 0; k0 < S; k0 += KT) {
    const int kn = min(KT, S - k0);
    __syncthreads();                      // the previous tile is consumed
    load_tile<HDP>(Ks, kb + (long long)k0 * in.r, in.r, kn, kn, hd, vec_in);
    __syncthreads();
    if (active) {
      scores(kn);
      for (int j = half; j < kn; j += 2)
        m = fmaxf(m, __fadd_rn(__fmul_rn(Sw[row * S_LD + j], scale),
                               Bs[k0 + j]));
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: p = exp(s - m), l = Σp, O += bf16(p)·V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wmma::fill_fragment(of[i], 0.0f);
  float l = 0.0f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    const int kn = min(KT, S - k0);
    __syncthreads();
    load_tile<HDP>(Ks, kb + (long long)k0 * in.r, in.r, kn, kn, hd, vec_in);
    load_tile<HDP>(Vs, vb + (long long)k0 * in.r, in.r, kn, kn, hd, vec_in);
    __syncthreads();
    if (active) {
      scores(kn);
      for (int j = half; j < kn; j += 2) {
        const float s = __fadd_rn(__fmul_rn(Sw[row * S_LD + j], scale),
                                  Bs[k0 + j]);
        const float p = expf(__fsub_rn(s, m));
        l += p;
        Pw[row * P_LD + j] = __float2bfloat16(p);
      }
      __syncwarp();
      for (int kk = 0; kk < kn; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, Pw + kk, P_LD);
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * LD + i * 16, LD);
          wmma::mma_sync(of[i], pf, vf, of[i]);
        }
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if (half == 0) Inv[warp * 16 + row] = 1.0f / l;
  __syncthreads();                        // every warp is done with K and V

  // o = out_dtype(O · (1/l)), staged in f32 over the K and V region
  if (active) {
    float* Ow = reinterpret_cast<float*>(smem + L::k) + warp * 16 * L::O_LD;
#pragma unroll
    for (int i = 0; i < NF; ++i)
      wmma::store_matrix_sync(Ow + i * 16, of[i], L::O_LD, wmma::mem_row_major);
    __syncwarp();
    const float* inv = Inv + warp * 16;
    bf16* ob = out + (long long)b * ot.b + (long long)h * ot.h +
               (long long)(q0 + warp * 16) * ot.r;
    if (vec_out) {
      const int cpr = hd / 8;
      for (int idx = lane; idx < 16 * cpr; idx += 32) {
        const int r = idx / cpr, c = (idx % cpr) * 8;
        __align__(16) bf16 o8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o8[e] = __float2bfloat16(__fmul_rn(Ow[r * L::O_LD + c + e], inv[r]));
        *reinterpret_cast<uint4*>(ob + r * ot.r + c) =
            *reinterpret_cast<const uint4*>(o8);
      }
    } else {
      for (int idx = lane; idx < 16 * hd; idx += 32) {
        const int r = idx / hd, c = idx % hd;
        ob[r * ot.r + c] = __float2bfloat16(__fmul_rn(Ow[r * L::O_LD + c],
                                                      inv[r]));
      }
    }
  }
}

template <int HDP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, bf16* out, int B, int nh, int S, int hd,
                   Strides in, Strides ot, float scale, bool vec_in,
                   bool vec_out, cudaStream_t stream) {
  const size_t smem = Smem<HDP>::bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + QT - 1) / QT, nh, B);
  attention_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, out, S, hd, in, ot, scale, vec_in, vec_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Masked attention of every (sequence, head): q, k and v share the
// element strides (in_b, in_h, in_r) and have unit stride along the head
// dim; out has (out_b, out_h, out_r). bias is the (B, S) f32 additive key
// bias. Needs 1 <= hd <= 128, S % 16 == 0, S <= 512. Returns a
// cudaError_t.
int dawn_attention(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int nh, int S, int hd,
                   long long in_b, long long in_h, long long in_r,
                   long long out_b, long long out_h, long long out_r,
                   float scale, void* stream) {
  if (B <= 0 || nh <= 0 || S <= 0 || S % 16 != 0 || S > MAX_S || hd <= 0 ||
      hd > 128 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides in{in_b, in_h, in_r}, ot{out_b, out_h, out_r};
  const bool vec_in = hd % 8 == 0 && in_b % 8 == 0 && in_h % 8 == 0 &&
                      in_r % 8 == 0 && aligned16(q) && aligned16(k) &&
                      aligned16(v);
  const bool vec_out = hd % 8 == 0 && out_b % 8 == 0 && out_h % 8 == 0 &&
                       out_r % 8 == 0 && aligned16(out);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one instance per power-of-two padded head dim: each instance costs
  // seconds of nvcc, and head dims between them are rare
  if (hd <= 16)
    return (int)launch<16>(qp, kp, vp, bp, op, B, nh, S, hd, in, ot, scale,
                           vec_in, vec_out, s);
  if (hd <= 32)
    return (int)launch<32>(qp, kp, vp, bp, op, B, nh, S, hd, in, ot, scale,
                           vec_in, vec_out, s);
  if (hd <= 64)
    return (int)launch<64>(qp, kp, vp, bp, op, B, nh, S, hd, in, ot, scale,
                           vec_in, vec_out, s);
  return (int)launch<128>(qp, kp, vp, bp, op, B, nh, S, hd, in, ot, scale,
                          vec_in, vec_out, s);
}

}  // extern "C"
