// K2 and K3: score + strided-window select on Hopper (sm_90a).
//
// Replaces the TPU kernels of dawnsearch_tpu/ops/scan_select.py:
//   K2  _candidates    (pallas_call :281; _select_kernel + _mask_select_store)
//   K3  _candidates_i4 (pallas_call :221; _select_kernel_i4 + the same tail)
// in every variant the reference has, one template instance each:
//
//   FMT_I8,   qi8    i8 codes (N, D) + scales   s8·s8 -> s32       K2 i8
//   FMT_I8,   bf16 q i8 codes widened to bf16  bf16·bf16 -> f32   K2 i8 qi8=False
//   FMT_BF16, bf16 q bf16 codes (N, D)          bf16·bf16 -> f32   K2 bf16
//   FMT_I4,   qi8    packed i4 (N/2, D) + scales s8·s8 -> s32      K3 qi8
//   FMT_I4,   bf16 q packed i4 widened to bf16 bf16·bf16 -> f32   K3 qi8=False
//
// Same contract as the reference, for N logical rows:
//
//   qi8:          db = 2 - (f32(dot) · qs[b]) · scales[n]
//   bf16 queries: db = 2 - dot · scales[n]   (i8, i4; no query scale)
//                 db = 2 - dot               (bf16 codes)
//   db = +inf where n >= count
//   key       = (bits(db) & ~0x7F) | w
//   for tile t (rows [t·16384, (t+1)·16384)) and window r < 128:
//     best    = min over w < 128 of key(row t·16384 + w·128 + r)
//   vals[b, t·128 + r] = bits(best & ~0x7F) - 1
//   ids [b, t·128 + r] = t·16384 + (best & 0x7F)·128 + r, or -1 where the
//                        value is not finite
//
// The epilogue is written with __fmul_rn / __fsub_rn so nvcc cannot
// contract it into an FMA: a different rounding of db moves the truncated
// key and can flip ids on ties with the reference. The qi8 variants are
// bit-equal to the plain twin (exact integer dots); the bf16 variants sum
// f32 products of bf16 operands in WMMA's order, so they agree with any
// other order only within a few f32 ulps of the dot (tests state the
// tolerance). The min runs over the whole packed key, which is unique per
// window, so the order in which blocks fold cannot change the result.
//
// i4 layout (ops/quant.py): within a tile, packed row p holds logical row
// p in its low nibble and row p + 8192 in its high nibble, biased +8. So
// the 128 packed rows t·8192 + pw·128 + r hold window blocks w = pw (low)
// and w = pw + 64 (high). The qi8 variant loads each packed block once
// (48 KB at D = 384), unpacks both nibbles with byte-SIMD ops into two s8
// panels and scores both: half the code bytes of i8 per row. The bf16
// variant (an override, not on a serving path) has no shared memory for
// two bf16 panels, so it walks w = 0..127 and takes the low or the high
// nibble of packed block w % 64, reading each packed byte twice.
//
// Design. One CTA per (64-query tile, 16384-row tile); blockIdx.x walks the
// query tiles of one row tile, so CTAs that share codes run together and
// the row tile is read from HBM about once. The CTA loops over row blocks
// of 128 rows, stages each in shared memory "k-major" (chunk kk of 16 dims
// is a contiguous (rows x 16) panel, so every WMMA fragment pointer is
// 256-byte aligned), scores it against the resident query tile with WMMA
// (16x16x16, int8 with s32 or bf16 with f32 accumulate), and folds the
// scores into a running packed-key minimum that each thread keeps in
// registers for its 32 (query, window) pairs. Row and byte offsets are
// 64-bit: at 67,108,864 logical rows the packed i4 codes are 12.9 GB.
//
// What bounds it (H100 SXM peaks: 1,979 TOP/s int8, 989 TFLOP/s bf16,
// 3.35 TB/s) at 1,048,576 rows x 1024 queries, D = 384: 0.825 T ops, so
// the qi8 variants are bound by int8 compute (0.42 ms; K2 reads 0.40 GB of
// codes, K3 0.20 GB) and the bf16 ones by bf16 compute (0.83 ms; bf16
// codes are 0.81 GB). At B = 1 every variant is bound by the code bytes.
// This first version stages blocks with synchronous loads and no double
// buffering, so loads and MMAs do not overlap; cp.async/TMA and wgmma are
// later work. Shared memory per CTA at D = 384: i8 qi8 105.3 KB; i4 qi8
// 185.3 KB (two s8 panels, a 64 x 260 s32 score tile); the three bf16
// variants 177.3 KB (bf16 query tile and panel), so one CTA per SM for all
// but the i8 qi8 one (two). Registers per thread (-Xptxas -v, sm_90a,
// CUDA 12.8; chip_smoke.py phase build prints them): i8 qi8 98, i8 bf16 q
// 125, i4 qi8 97, i4 bf16 q 124, bf16 128; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int W = 128;          // windows per row tile = rows per block
constexpr int TN = W * W;       // 16384 rows per tile
constexpr int QB = 64;          // queries per CTA
constexpr int THREADS = 256;    // 8 warps: 4 (query frags) x 2 (row halves)
constexpr int PER_THREAD = QB * W / THREADS;  // 32 (query, window) pairs

enum Fmt { FMT_I8 = 0, FMT_I4 = 1, FMT_BF16 = 2 };

template <int FMT, bool QI8>
struct Variant {
  // MMA operand and accumulator types
  using A = typename std::conditional<QI8, signed char, __nv_bfloat16>::type;
  using C = typename std::conditional<QI8, int, float>::type;
  // row blocks staged per iteration: i4 qi8 unpacks both nibbles at once
  static constexpr int NB = (FMT == FMT_I4 && QI8) ? 2 : 1;
  static constexpr int LDC = NB * W + 4;  // padded score rows
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

template <int FMT, bool QI8>
size_t select_smem_bytes(int D) {
  using V = Variant<FMT, QI8>;
  const size_t ks = D / 16, a = sizeof(typename V::A);
  return align128(ks * QB * 16 * a) + align128(V::NB * ks * W * 16 * a) +
         align128((size_t)QB * V::LDC * sizeof(typename V::C)) +
         align128(QB * sizeof(float));
}

// 16 bytes through the read-only data path
__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ int sbyte(unsigned w, int j) {
  return (int)(signed char)((w >> (8 * j)) & 0xFFu);
}

__device__ __forceinline__ unsigned bf16x2(int a, int b) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<unsigned*>(&h);
}

// 16 signed bytes -> 16 bf16 (exact: |v| <= 127) at dst (32 bytes)
__device__ __forceinline__ void widen16(uint4 v, __nv_bfloat16* dst) {
  uint4 lo, hi;
  lo.x = bf16x2(sbyte(v.x, 0), sbyte(v.x, 1));
  lo.y = bf16x2(sbyte(v.x, 2), sbyte(v.x, 3));
  lo.z = bf16x2(sbyte(v.y, 0), sbyte(v.y, 1));
  lo.w = bf16x2(sbyte(v.y, 2), sbyte(v.y, 3));
  hi.x = bf16x2(sbyte(v.z, 0), sbyte(v.z, 1));
  hi.y = bf16x2(sbyte(v.z, 2), sbyte(v.z, 3));
  hi.z = bf16x2(sbyte(v.w, 0), sbyte(v.w, 1));
  hi.w = bf16x2(sbyte(v.w, 2), sbyte(v.w, 3));
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// packed nibbles -> s8 codes in [-8, 7], four bytes at a time
__device__ __forceinline__ uint4 lo_nibbles(uint4 p) {
  const unsigned m = 0x0F0F0F0Fu, b = 0x08080808u;
  return make_uint4(__vsub4(p.x & m, b), __vsub4(p.y & m, b),
                    __vsub4(p.z & m, b), __vsub4(p.w & m, b));
}

__device__ __forceinline__ uint4 hi_nibbles(uint4 p) {
  const unsigned m = 0x0F0F0F0Fu, b = 0x08080808u;
  return make_uint4(__vsub4((p.x >> 4) & m, b), __vsub4((p.y >> 4) & m, b),
                    __vsub4((p.z >> 4) & m, b), __vsub4((p.w >> 4) & m, b));
}

// 16 s8 values into a panel slot of the MMA operand type
template <bool QI8, typename A>
__device__ __forceinline__ void put16(A* dst, uint4 v) {
  if constexpr (QI8)
    *reinterpret_cast<uint4*>(dst) = v;
  else
    widen16(v, dst);
}

// Stage the row blocks of iteration `it` of tile `tile` into Xs: block h
// (h < NB) is window block w = it + 64·h, as (ks panels x 128 rows x 16).
template <int FMT, bool QI8>
__device__ __forceinline__ void stage_codes(
    const void* __restrict__ codes, typename Variant<FMT, QI8>::A* Xs,
    long long tile, int it, int D, int ks, int tid) {
  using A = typename Variant<FMT, QI8>::A;
  constexpr int ES = FMT == FMT_BF16 ? 2 : 1;  // bytes per stored code
  // the first of the 128 stored rows of this step; for i4, packed rows
  // t·8192 + pw·128 + n hold blocks pw (low nibbles) and pw + 64 (high)
  const long long first =
      FMT == FMT_I4 ? tile * (TN / 2) + (long long)(QI8 ? it : it % (W / 2)) * W
                    : tile * TN + (long long)it * W;
  const uint8_t* blk = static_cast<const uint8_t*>(codes) + (size_t)first * D * ES;
  for (int idx = tid; idx < W * ks; idx += THREADS) {
    const int n = idx / ks, kk = idx % ks;
    A* dst = Xs + ((size_t)kk * W + n) * 16;
    const uint8_t* src = blk + ((size_t)n * D + kk * 16) * ES;
    if constexpr (FMT == FMT_I4) {
      const uint4 p = ld16(src);
      if constexpr (QI8) {
        put16<QI8>(dst, lo_nibbles(p));
        put16<QI8>(dst + (size_t)ks * W * 16, hi_nibbles(p));
      } else {
        put16<QI8>(dst, it < W / 2 ? lo_nibbles(p) : hi_nibbles(p));
      }
    } else if constexpr (FMT == FMT_BF16) {
      reinterpret_cast<uint4*>(dst)[0] = ld16(src);
      reinterpret_cast<uint4*>(dst)[1] = ld16(src + 16);
    } else {
      put16<QI8>(dst, ld16(src));
    }
  }
}

template <int FMT, bool QI8>
__global__ void __launch_bounds__(THREADS)
select_kernel(const void* __restrict__ q, const float* __restrict__ qs,
              const void* __restrict__ codes, const float* __restrict__ scales,
              long long count, float* __restrict__ vals, int* __restrict__ ids,
              int B, long long N, int D) {
  using V = Variant<FMT, QI8>;
  using A = typename V::A;
  using C = typename V::C;
  constexpr int NB = V::NB, LDC = V::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = D / 16;
  size_t off = 0;
  A* Qs = reinterpret_cast<A*>(smem + off);
  off += align128((size_t)ks * QB * 16 * sizeof(A));
  A* Xs = reinterpret_cast<A*>(smem + off);
  off += align128((size_t)NB * ks * W * 16 * sizeof(A));
  C* Cs = reinterpret_cast<C*>(smem + off);
  off += align128((size_t)QB * LDC * sizeof(C));
  float* qss = reinterpret_cast<float*>(smem + off);

  const int tid = threadIdx.x, warp = tid / 32;
  const int b0 = blockIdx.x * QB;
  const long long tile = blockIdx.y;
  const long long base = tile * TN;

  // the query tile, k-major; rows past B are zero
  constexpr int QV = 16 * sizeof(A) / 16;  // uint4 per 16-dim chunk
  for (int idx = tid; idx < QB * ks; idx += THREADS) {
    const int r = idx / ks, kk = idx % ks;
    uint4* dst = reinterpret_cast<uint4*>(Qs + ((size_t)kk * QB + r) * 16);
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const A*>(q) + (size_t)(b0 + r) * D + kk * 16);
#pragma unroll
    for (int v = 0; v < QV; ++v)
      dst[v] = (b0 + r < B) ? src[v] : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (QI8)
    for (int r = tid; r < QB; r += THREADS) qss[r] = (b0 + r < B) ? qs[b0 + r] : 0.0f;

  const int r = tid % W;        // this thread's window
  const int qoff = tid / W;     // its queries: qoff, qoff + 2, ...
  int best[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) best[j] = INT_MAX;
  const int fm = warp / 2;          // query fragment of this warp
  const int fn0 = (warp % 2) * 4;   // first of its four row fragments

  for (int it = 0; it < W / NB; ++it) {
    __syncthreads();  // the previous iteration's Xs / Cs are consumed
    stage_codes<FMT, QI8>(codes, Xs, tile, it, D, ks, tid);
    __syncthreads();

#pragma unroll
    for (int h = 0; h < NB; ++h) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, C> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], (C)0);
      for (int kk = 0; kk < ks; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, A, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + ((size_t)kk * QB + fm * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, A, wmma::col_major> xb;
          wmma::load_matrix_sync(
              xb, Xs + (((size_t)h * ks + kk) * W + (fn0 + j) * 16) * 16, 16);
          wmma::mma_sync(acc[j], a, xb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + fm * 16 * LDC + h * W + (fn0 + j) * 16,
                                acc[j], LDC, wmma::mem_row_major);
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const int w = it + h * (W / 2);
      const long long row = base + (long long)w * W + r;
      const bool live = row < count;
      float sc = 1.0f;
      if constexpr (FMT != FMT_BF16) sc = scales[row];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int qi = qoff + 2 * j;
        const C c = Cs[qi * LDC + h * W + r];
        float db;
        if constexpr (QI8)
          db = __fsub_rn(2.0f, __fmul_rn(__fmul_rn((float)c, qss[qi]), sc));
        else if constexpr (FMT == FMT_BF16)
          db = __fsub_rn(2.0f, c);
        else
          db = __fsub_rn(2.0f, __fmul_rn(c, sc));
        if (!live) db = INFINITY;
        best[j] = min(best[j], (__float_as_int(db) & ~0x7F) | w);
      }
    }
  }

  const long long ncols = N / W;
  const long long col = tile * W + r;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int qi = qoff + 2 * j;
    if (b0 + qi >= B) continue;
    const float v = __int_as_float(best[j] & ~0x7F) - 1.0f;
    const size_t o = (size_t)(b0 + qi) * ncols + col;
    vals[o] = v;
    ids[o] = isfinite(v) ? (int)(base + (long long)(best[j] & 0x7F) * W + r) : -1;
  }
}

template <int FMT, bool QI8>
int launch(const void* q, const void* qs, const void* codes,
           const void* scales, long long count, void* vals, void* ids, int B,
           long long N, int D, cudaStream_t stream) {
  const size_t smem = select_smem_bytes<FMT, QI8>(D);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<FMT, QI8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, (unsigned)(N / TN));
  select_kernel<FMT, QI8><<<grid, THREADS, smem, stream>>>(
      q, static_cast<const float*>(qs), codes,
      static_cast<const float*>(scales), count, static_cast<float*>(vals),
      static_cast<int*>(ids), B, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, D) s8 + qs (B,) f32 (qi8) or q (B, D) bf16 (qs unused), against
// codes of format fmt (0: i8 (N, D); 1: row-block packed i4 (N/2, D) uint8;
// 2: bf16 (N, D)) with scales (N,) f32 (unused for bf16), N logical rows ->
// vals / ids (B, N/128). Needs N % 16384 == 0, D % 16 == 0, 16-byte aligned
// pointers. Returns a cudaError_t.
int dawn_select(int fmt, int qi8, const void* q, const void* qs,
                const void* codes, const void* scales, long long count,
                void* vals, void* ids, int B, long long N, int D,
                void* stream) {
  if (B <= 0 || N <= 0 || N % TN != 0 || N / TN > 65535 || D <= 0 ||
      D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == FMT_I8 && qi8)
    return launch<FMT_I8, true>(q, qs, codes, scales, count, vals, ids, B, N, D, s);
  if (fmt == FMT_I8)
    return launch<FMT_I8, false>(q, qs, codes, scales, count, vals, ids, B, N, D, s);
  if (fmt == FMT_I4 && qi8)
    return launch<FMT_I4, true>(q, qs, codes, scales, count, vals, ids, B, N, D, s);
  if (fmt == FMT_I4)
    return launch<FMT_I4, false>(q, qs, codes, scales, count, vals, ids, B, N, D, s);
  if (fmt == FMT_BF16 && !qi8)
    return launch<FMT_BF16, false>(q, qs, codes, scales, count, vals, ids, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
