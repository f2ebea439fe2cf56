// ModernBERT's attention on Hopper (sm_90a), bf16, head dim 64, S up to
// 8,192: global (every key of the sequence) or windowed (keys within
// `window` positions of the query), in the long-context library.
//
//   s = (q·kᵀ)·scale, masked to keys j < len (and |i − j| <= window)
//   o = bf16( Σ_j bf16(p_j)·v_j / Σ_j p_j ),  p = exp(s − running max)
//
// q, k and v are column blocks of the QKV projection's (B·S, 3H) output
// (row stride 3H, head h at column h·64), RoPE already applied by its
// epilogue; len is each sequence's real length (int32). Query rows at or
// past len are written as zeros.
//
// Design. csrc/attention.cu walks S <= 512 twice (an exact row max, then
// p against it); at S = 8,192 the second QKᵀ would cost a quarter more
// FLOPs than needed, so this kernel runs one pass with an online softmax
// (FlashAttention-2's order): each 64-key tile's scores give a new row max
// m', the f32 context and l are rescaled by exp(m − m'), and p = exp(s −
// m') enters l in f32 and PV as bf16. One CTA owns 64 query rows of one
// (sequence, head), 16 a warp, on mma.sync m16n8k16 (bf16 in, f32
// accumulate) with fragments read by ldmatrix (.trans for V) from rows
// padded to 72 elements (144 bytes, an odd number of 16 bytes: no bank
// conflicts); Q's fragments stay in registers, the scores and p never
// leave them. K and V tiles stream through a ring of two buffers by
// 16-byte cp.async, tile t + 1 in flight while t computes.
//
// What it visits. A CTA whose first query row is at or past len writes
// zeros and leaves. Otherwise it walks only the key tiles that can hold a
// key it attends to: [0, ceil(len / 64)) in a global layer; in a local
// one (the BAND instance) the tiles meeting [q0 − window, min(q0 + 63 + window, len − 1)]:
// three tiles at window 64, so its cost follows the window, not S. The
// masks (j >= len, |i − j| > window) are applied only in the tiles that a
// warp's 16 rows do not see whole. Exponentials are ex2.approx of scores
// pre-multiplied by log2(e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../common.cuh"
#include "../sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;
constexpr int QT = 64;          // query rows a CTA, 16 a warp
constexpr int KT = 64;          // keys a tile
constexpr int THREADS = 128;
constexpr int LD = HD + 8;      // shared row pitch, elements
constexpr int TILE = KT * LD;   // elements of a K or V tile
constexpr int MAX_S = 8192;
constexpr size_t SMEM = (size_t)(QT * LD + 4 * TILE) * sizeof(bf16);

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + 64) of a head's q, k or v (row stride ld) into shared
// memory, rows at or past `valid` zero-filled; 16-byte cp.async
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long ld,
                                      int r0, int valid) {
#pragma unroll
  for (int i = 0; i < (KT * HD / 8) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const bool ok = r0 + r < valid;
    sm90::cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * ld + c : src,
                     ok ? 16 : 0);
  }
}

// grid (ceil(S / QT), nh, B); BAND: the windowed instance (window >= 0),
// else the global one
template <bool BAND>
__global__ void __launch_bounds__(THREADS)
long_attention_kernel(const bf16* __restrict__ qkv,
                      const int* __restrict__ lens, bf16* __restrict__ out,
                      int S, int nh, int window, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + QT * LD;         // two tiles
  bf16* Vs = Ks + 2 * TILE;        // two tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * HD;
  const long long ld = 3LL * H;
  const int len = min(max(lens[b], 0), S);
  const bf16* qb = qkv + (long long)b * S * ld + h * HD;
  const bf16* kb = qb + H;
  const bf16* vb = qb + 2 * H;
  bf16* ob = out + (long long)b * S * H + h * HD;

  if (q0 >= len) {  // padding rows only: zeros
    for (int idx = threadIdx.x; idx < QT * HD / 8; idx += THREADS) {
      const int r = q0 + idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      if (r < S)
        *reinterpret_cast<uint4*>(ob + (long long)r * H + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  int kt0 = 0, kt1 = (len + KT - 1) / KT;
  if (BAND) {
    kt0 = max(0, q0 - window) / KT;
    kt1 = (min(q0 + QT - 1 + window, len - 1)) / KT + 1;
  }

  stage(Qs, qb, ld, q0, min(S, len));
  stage(Ks, kb, ld, kt0 * KT, len);
  stage(Vs, vb, ld, kt0 * KT, len);
  sm90::cp_async_commit();

  const int i0 = q0 + warp * 16;           // the warp's first row
  const bool active = i0 < len;            // warp-uniform
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = kt0; t < kt1; ++t) {
    const int buf = (t - kt0) & 1;
    if (t + 1 < kt1) {
      stage(Ks + (buf ^ 1) * TILE, kb, ld, (t + 1) * KT, len);
      stage(Vs + (buf ^ 1) * TILE, vb, ld, (t + 1) * KT, len);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;
    const int k0 = t * KT;
    // warp-uniform: does every (row, key) of this tile pass the masks?
    const bool whole = k0 + KT <= len &&
                       (!BAND || (k0 >= i0 + 15 - window &&
                                  k0 + KT - 1 <= i0 + window));
    const bool skip = BAND && (k0 > i0 + 15 + window ||
                               k0 + KT - 1 < i0 - window);
    if (active && t == kt0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        sm90::ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 8 +
                                        ((lane / 8) % 2) * 8) * LD +
                                           kc * 16 + (lane / 16) * 8);
    }
    if (active && !skip) {
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int np = 0; np < KT / 16; ++np)
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
          uint32_t kf[4];
          sm90::ldmatrix_x4(kf, Kt + ((2 * np + lane / 16) * 8 + lane % 8) *
                                         LD + kc * 16 + ((lane / 8) % 2) * 8);
          sm90::mma_bf16_16816(s[2 * np], qf[kc], kf[0], kf[1]);
          sm90::mma_bf16_16816(s[2 * np + 1], qf[kc], kf[2], kf[3]);
        }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[n][e] * scale_log2;
          if (!whole) {
            const int j = k0 + n * 8 + 2 * t4 + (e & 1);
            const int i = i0 + g + 8 * (e >> 1);
            if (j >= len || (BAND && abs(i - j) > window))
              v = -INFINITY;
          }
          s[n][e] = v;
          mx[e / 2] = fmaxf(mx[e / 2], v);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no key yet keeps m = -inf: nothing to rescale
        corr[r] = mx[r] == -INFINITY ? 1.0f : ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m[e / 2];
          const float p = mr == -INFINITY ? 0.0f : ex2(s[n][e] - mr);
          l[e / 2] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) {
        const uint32_t pa[4] = {
            sm90::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            sm90::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            sm90::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            sm90::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int op = 0; op < HD / 16; ++op) {
          uint32_t vf[4];
          sm90::ldmatrix_x4_trans(
              vf, Vt + (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                      (2 * op + lane / 16) * 8);
          sm90::mma_bf16_16816(o[2 * op], pa, vf[0], vf[1]);
          sm90::mma_bf16_16816(o[2 * op + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled next
  }

  // o / l; rows at or past len are zeros
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= S) continue;
    const float f = i < len ? inv[r] : 0.0f;
    bf16* row = ob + (long long)i * H;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * r] * f, o[n][2 * r + 1] * f);
  }
}

}  // namespace

extern "C" {

// ctx (B·S, nh·64) bf16 from qkv (B·S, 3·nh·64) bf16 and lens (B,) int32:
// global attention for window < 0, else keys within `window` positions;
// scale multiplies q·kᵀ. Needs hd = 64, S % 16 == 0, S <= 8192, 16-byte
// aligned qkv and out. Returns a cudaError_t.
int dawn_long_attention(const void* qkv, const void* lens, void* out, int B,
                        int S, int nh, int hd, int window, float scale,
                        void* stream) {
  if (B <= 0 || B > 65535 || nh <= 0 || nh > 65535 || hd != HD || S <= 0 ||
      S % 16 != 0 || S > MAX_S ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = window >= 0 ? long_attention_kernel<true>
                            : long_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QT - 1) / QT, nh, B);
  kernel<<<grid, THREADS, SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(lens),
      static_cast<bf16*>(out), S, nh, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // extern "C"
