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
// f32 products of bf16 operands in the tensor cores' order, so they agree
// with any other order only within a few f32 ulps of the dot (tests state
// the tolerance). The min runs over the whole packed key, which is unique
// per window, so neither the order in which blocks fold nor the CTA that
// folds them can change the result.
//
// i4 layout (ops/quant.py): within a tile, packed row p holds logical row
// p in its low nibble and row p + 8192 in its high nibble, biased +8. So
// the 128 packed rows t·8192 + pw·128 + r hold window blocks w = pw (low)
// and w = pw + 64 (high): each packed block is read once and scores both.
//
// Design. The grid is (query tiles, row tiles x s). A CTA holds one query
// tile of QB = 8 queries at B <= 8 (a searcher's small batch: at B = 1
// the products and the fold run over 8 queries, not 64), else 64, and
// walks 128 / s of one 16,384-row tile's window blocks (i4: 64 / s
// packed blocks). The host plans s (ops/scan_select.py::plan_select): the
// smallest power of two up to 16 that gives the card two CTAs an SM over
// the tiles that hold live rows; at B = 1 over the node's 524,288-row
// index (17 live tiles of 32) that is 16, at B = 1024 it is 1. The s CTAs
// of a tile form a thread-block cluster, and their window minima combine
// through distributed shared memory: each CTA leaves its (query, window)
// keys in shared memory, and after a cluster barrier CTA q takes the min
// over the s CTAs of windows [q·128/s, (q+1)·128/s) and stores them. A
// cluster, not atomics: no key buffer to initialise and no second pass
// for the store tail, so it stays one launch. Tiles wholly past count
// read no codes: their clusters store (+inf, -1), the plain twin's
// columns there; blocks wholly past count in the last live tile are
// skipped too, their keys (+inf | w) folded in as the first skipped w.
// Row and byte offsets are 64-bit: at 67,108,864 logical rows the packed
// i4 codes are 12.9 GB.
//
// Loads overlap the products. One producer warp keeps a ring of four
// 16 KB stages filled by TMA: each stage is one (128 rows x 128 bytes) box
// of a block's codes under the 128-byte swizzle (a block of D = 384 i8
// codes is three boxes, of bf16 codes six), completing on an mbarrier.
// Eight consumer warps each take 16 of the block's 128 rows: mma.sync
// m16n8k32 s8 (qi8) or m16n8k16 bf16 with the codes as the M operand,
// read straight from the swizzled stage (the 16-byte chunk c of box row r
// lies at chunk c ^ (r % 8): conflict-free), and the queries, held in
// padded shared memory, as N = 8 columns a step. i4 codes are unpacked in
// registers with byte-SIMD ops; i8 and i4 codes against bf16 queries are
// widened to bf16 in registers, the products taking k in the order the
// bytes lie (the queries' fragments follow the same order). The s32 / f32
// sums stay in registers; after the block's last box each thread folds
// its (row, query) scores into its running packed-key minima.
//
// What bounds it (H100 SXM peaks: 1,979 TOP/s int8, 989 TFLOP/s bf16,
// 3.35 TB/s). At B <= 8 every variant is bound by the live rows' code
// bytes: at the node's 270,000 live rows of D = 384, 104 MB, 0.031 ms. At
// 1,048,576 rows x 1024 queries, 0.825 T ops: the qi8 variants are bound
// by int8 compute (0.42 ms), the bf16 ones by bf16 compute (0.83 ms);
// there the fold (about eight CUDA-core operations a (row, query) pair)
// and the queries' fragments, read from shared memory at every k step,
// take more issue slots than the products. Shared memory per CTA at
// D = 384: 64 KB of ring plus the query tile, QB·(D + 16) bytes for i8
// queries and QB·(2D + 16) for bf16 (68-116 KB). Registers per thread
// (-Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py phase build prints them):
// 40-53 at 8 queries a CTA, 127-168 at 64 (one CTA an SM there);
// no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int W = 128;          // windows per row tile = rows per block
constexpr int TN = W * W;       // 16384 rows per tile
constexpr int BOX = 128;        // bytes of a stored row in one TMA box
constexpr int STAGE = W * BOX;  // 16 KB: one box of a block
constexpr int STAGES = 4;
constexpr int CONSUMERS = 8;    // warps, 16 rows of a block each
constexpr int THREADS = CONSUMERS * 32 + 32;  // + the producer warp
constexpr int MAX_SPLIT = 16;   // CTAs of a tile's cluster (non-portable)
constexpr int INF_KEY = 0x7F800000;  // bits(+inf): the key of a dead row

enum Fmt { FMT_I8 = 0, FMT_I4 = 1, FMT_BF16 = 2 };

template <int FMT, bool QI8, int QN>
struct Variant {
  static constexpr int QB = 8 * QN;                 // queries per CTA
  static constexpr int CODE_BYTES = FMT == FMT_BF16 ? 2 : 1;
  static constexpr int Q_BYTES = QI8 ? 1 : 2;       // bytes per query dim
  // window blocks a staged block scores: i4 unpacks both nibbles
  static constexpr int NB = FMT == FMT_I4 ? 2 : 1;
  static constexpr int BLOCKS = W / NB;             // staged blocks a tile
  using Acc = typename std::conditional<QI8, int, float>::type;
  __host__ __device__ static size_t q_stride(int D) {
    return (size_t)D * Q_BYTES + 16;
  }
  __host__ __device__ static size_t bytes(int D) {
    return (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) +
           QB * q_stride(D) + QB * sizeof(float) + 1024;
  }
};

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(signed char)((w >> (8 * j)) & 0xFFu);
}

// bytes 2h, 2h + 1 of four signed bytes -> two bf16 (exact: |v| <= 127)
__device__ __forceinline__ uint32_t widen2(uint32_t x, int h) {
  return sm90::pack_bf16((float)sbyte(x, 2 * h), (float)sbyte(x, 2 * h + 1));
}

// packed nibbles -> s8 codes in [-8, 7], four bytes at a time
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t p) {
  return __vsub4(p & 0x0F0F0F0Fu, 0x08080808u);
}
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t p) {
  return __vsub4((p >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

// the 4 bytes at byte c (c % 4 == 0) of row r of a swizzled box
__device__ __forceinline__ uint32_t lds_box(const unsigned char* box, int r,
                                            int c) {
  return *reinterpret_cast<const uint32_t*>(
      box + r * BOX + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15));
}

// The products of one 32-byte chunk of the codes (rows of this thread's
// 16-row fragment: a as mma_s8_16832's A bytes) with the QB queries, into
// acc[nb][n]. cb is the chunk's first byte in a stored code row.
template <int FMT, bool QI8, int QN>
__device__ __forceinline__ void chunk_products(
    typename Variant<FMT, QI8, QN>::Acc (&acc)[Variant<FMT, QI8, QN>::NB][QN]
                                              [4],
    const uint32_t (&a)[4], const unsigned char* qsm, size_t qstride, int cb,
    int g, int t) {
  using V = Variant<FMT, QI8, QN>;
  uint32_t frag[V::NB][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (FMT == FMT_I4) {
      frag[0][i] = lo_nibbles(a[i]);
      frag[V::NB - 1][i] = hi_nibbles(a[i]);
    } else {
      frag[0][i] = a[i];
    }
  }
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const unsigned char* q = qsm + (size_t)(n * 8 + g) * qstride;
    if constexpr (QI8) {
      // B = the query's bytes at the A bytes' k: cb + 4t and cb + 16 + 4t
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q + cb + 4 * t);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(q + cb + 16 + 4 * t);
#pragma unroll
      for (int nb = 0; nb < V::NB; ++nb)
        sm90::mma_s8_16832(acc[nb][n], frag[nb], b0, b1);
    } else if constexpr (FMT == FMT_BF16) {
      // bf16 codes: the chunk is 16 dims, A's standard k16 layout
      const unsigned char* qd = q + (size_t)cb;  // cb / 2 dims, 2 bytes each
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qd + 4 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qd + 16 + 4 * t);
      sm90::mma_bf16_16816(acc[0][n], frag[0], b0, b1);
    } else {
      // s8 codes against bf16 queries: each 4-byte A register is widened
      // to two bf16 pairs; k16 step h takes the bytes at 16h + 4t, the
      // pairs (4t, 4t + 1) as slots (2t, 2t + 1) and (4t + 2, 4t + 3) as
      // slots (8 + 2t, 9 + 2t), and B the query's dims in the same order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            q + 2 * (size_t)(cb + 16 * h + 4 * t));
#pragma unroll
        for (int nb = 0; nb < V::NB; ++nb) {
          const uint32_t w[4] = {widen2(frag[nb][2 * h], 0),
                                 widen2(frag[nb][2 * h + 1], 0),
                                 widen2(frag[nb][2 * h], 1),
                                 widen2(frag[nb][2 * h + 1], 1)};
          sm90::mma_bf16_16816(acc[nb][n], w, b.x, b.y);
        }
      }
    }
  }
}

// grid (query tiles, row tiles · s), clusters of (1, s, 1): the s CTAs of
// one row tile; blockIdx.y / s is the tile, the cluster rank its share of
// the tile's staged blocks. qsm holds the query tile, qs its scales.
template <int FMT, bool QI8, int QN>
__global__ void __launch_bounds__(THREADS)
select_kernel(const __grid_constant__ CUtensorMap map,
              const void* __restrict__ q, const float* __restrict__ qs,
              const float* __restrict__ scales, long long count,
              float* __restrict__ vals, int* __restrict__ ids, int B,
              long long N, int D, int s) {
  using V = Variant<FMT, QI8, QN>;
  using Acc = typename V::Acc;
  constexpr int QB = V::QB, NB = V::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  unsigned char* qsm = reinterpret_cast<unsigned char*>(empty + STAGES);
  const size_t qstride = V::q_stride(D);
  float* qss = reinterpret_cast<float*>(qsm + QB * qstride);
  int* keys = reinterpret_cast<int*>(smem);  // [QB][W], over the ring at the end

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * QB;
  const long long tile = blockIdx.y / s;
  const int rank = (int)(blockIdx.y % s);
  const long long base = tile * TN;
  const long long ncols = N / W;

  // this CTA's staged blocks [blk0, blk1), the live ones [blk0, live1)
  const int per = V::BLOCKS / s;
  const int blk0 = rank * per, blk1 = blk0 + per;
  const long long left = count - base;
  const int live_blocks =
      left <= 0 ? 0 : (int)min((long long)V::BLOCKS, (left + W - 1) / W);
  const int live1 = min(blk1, max(blk0, live_blocks));

  if (live_blocks == 0) {
    // a tile wholly past count: every window's best is (+inf, w = 0)
    for (int i = threadIdx.x; i < QB * (W / s); i += THREADS) {
      const int qi = i / (W / s), r = rank * (W / s) + i % (W / s);
      if (b0 + qi >= B) continue;
      const size_t o = (size_t)(b0 + qi) * ncols + tile * W + r;
      vals[o] = INFINITY;
      ids[o] = -1;
    }
    return;
  }

  // the query tile, rows past B zero
  const int qrow = D * V::Q_BYTES;
  for (int i = threadIdx.x; i < QB * (qrow / 16); i += THREADS) {
    const int r = i / (qrow / 16), c = i % (qrow / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + r < B)
      v = *reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(q) +
                                          (size_t)(b0 + r) * qrow + c * 16);
    *reinterpret_cast<uint4*>(qsm + r * qstride + c * 16) = v;
  }
  if constexpr (QI8)
    for (int r = threadIdx.x; r < QB; r += THREADS)
      qss[r] = b0 + r < B ? qs[b0 + r] : 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], CONSUMERS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int nbox = D * V::CODE_BYTES / BOX;
  const int g = lane / 4, t = lane % 4;
  // skipped blocks (wholly past count) fold in as their first w's key
  int best[QN][4];
  const int skip_key = live1 < blk1 ? (INF_KEY | live1) : INT_MAX;
#pragma unroll
  for (int n = 0; n < QN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) best[n][i] = skip_key;

  if (warp == CONSUMERS) {
    if (lane == 0) {
      sm90::prefetch_tensormap(&map);
      const long long row0 = FMT == FMT_I4 ? tile * (TN / 2) : base;
      int it = 0;
      for (int b = blk0; b < live1; ++b)
        for (int x = 0; x < nbox; ++x, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)
            sm90::mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
          sm90::mbar_expect_tx(&full[st], STAGE);
          sm90::tma_load_2d(smem + st * STAGE, &map, &full[st], x * BOX,
                            (int)(row0 + (long long)b * W));
        }
    }
    __syncwarp();
  } else {
    float qsr[QN][2];
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      qsr[n][0] = QI8 ? qss[n * 8 + 2 * t] : 0.0f;
      qsr[n][1] = QI8 ? qss[n * 8 + 2 * t + 1] : 0.0f;
    }
    const int ra = warp * 16 + g;  // this thread's rows ra, ra + 8
    int it = 0;
    for (int b = blk0; b < live1; ++b) {
      // the rows' scales, fetched before the block's codes arrive
      float sc[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = base + (long long)(b + 64 * nb) * W + ra + 8 * h;
          sc[nb][h] = FMT == FMT_BF16 ? 1.0f : __ldg(scales + row);
        }
      Acc acc[NB][QN][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n = 0; n < QN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nb][n][i] = 0;
      for (int x = 0; x < nbox; ++x, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(&full[st], (it / STAGES) & 1);
        const unsigned char* box = smem + st * STAGE;
#pragma unroll
        for (int kk = 0; kk < BOX / 32; ++kk) {
          const int c = kk * 32 + 4 * t;
          const uint32_t a[4] = {lds_box(box, ra, c), lds_box(box, ra + 8, c),
                                 lds_box(box, ra, c + 16),
                                 lds_box(box, ra + 8, c + 16)};
          chunk_products<FMT, QI8, QN>(acc, a, qsm, qstride,
                                       x * BOX + kk * 32, g, t);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[st]);
      }
      // fold: acc[nb][n][i] is row ra + 8(i / 2), query n·8 + 2t + i % 2
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int w = b + 64 * nb;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long row = base + (long long)w * W + ra + 8 * (i / 2);
          const bool live = row < count;
          const float scl = sc[nb][i / 2];
#pragma unroll
          for (int n = 0; n < QN; ++n) {
            const Acc c = acc[nb][n][i];
            float db;
            if constexpr (QI8)
              db = __fsub_rn(2.0f, __fmul_rn(__fmul_rn(__int2float_rn(c),
                                                       qsr[n][i % 2]),
                                             scl));
            else if constexpr (FMT == FMT_BF16)
              db = __fsub_rn(2.0f, c);
            else
              db = __fsub_rn(2.0f, __fmul_rn(c, scl));
            if (!live) db = INFINITY;
            best[n][i] = min(best[n][i], (__float_as_int(db) & ~0x7F) | w);
          }
        }
      }
    }
  }

  // every CTA's keys, then each CTA stores its share of the windows
  __syncthreads();  // the ring is drained: its memory holds the keys now
  if (warp < CONSUMERS) {
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        keys[(n * 8 + 2 * t + i % 2) * W + warp * 16 + g + 8 * (i / 2)] =
            best[n][i];
  }
  if (s > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  const int share = W / s;
  for (int i = threadIdx.x; i < QB * share; i += THREADS) {
    const int qi = i / share, r = rank * share + i % share;
    if (b0 + qi >= B) continue;
    int k = keys[qi * W + r];
    for (int p = 0; p < s; ++p)
      if (p != rank) k = min(k, sm90::ld_dsmem(keys + qi * W + r, p));
    const float v = __int_as_float(k & ~0x7F) - 1.0f;
    const size_t o = (size_t)(b0 + qi) * ncols + tile * W + r;
    vals[o] = v;
    ids[o] = isfinite(v) ? (int)(base + (long long)(k & 0x7F) * W + r) : -1;
  }
  if (s > 1) sm90::cluster_sync();  // no CTA leaves while a peer reads it
}

template <int FMT, bool QI8, int QN>
int launch(const void* q, const void* qs, const void* codes,
           const void* scales, long long count, void* vals, void* ids, int B,
           long long N, int D, int s, cudaStream_t stream) {
  using V = Variant<FMT, QI8, QN>;
  const size_t smem = V::bytes(D);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const long long rows = FMT == FMT_I4 ? N / 2 : N;
  cudaError_t err = sm90::tensor_map_2d(&map, codes, 1, rows,
                                        (long long)D * V::CODE_BYTES, W, BOX);
  if (err != cudaSuccess) return (int)err;
  auto kernel = select_kernel<FMT, QI8, QN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && s > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + V::QB - 1) / V::QB, (unsigned)(N / TN * s));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (s > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = s;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = sm90::cluster_fits(reinterpret_cast<const void*>(kernel), cfg);
    if (err != cudaSuccess) return (int)err;
  }
  const float* qs_p = static_cast<const float*>(qs);
  const float* sc_p = static_cast<const float*>(scales);
  float* vals_p = static_cast<float*>(vals);
  int* ids_p = static_cast<int*>(ids);
  void* args[] = {&map, &q, &qs_p, &sc_p, &count, &vals_p, &ids_p, &B, &N,
                  &D, &s};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int FMT, bool QI8>
int launch_qb(int qb, const void* q, const void* qs, const void* codes,
              const void* scales, long long count, void* vals, void* ids,
              int B, long long N, int D, int s, cudaStream_t stream) {
  switch (qb) {
    case 8:
      return launch<FMT, QI8, 1>(q, qs, codes, scales, count, vals, ids, B, N,
                                 D, s, stream);
    case 64:
      return launch<FMT, QI8, 8>(q, qs, codes, scales, count, vals, ids, B, N,
                                 D, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, D) s8 + qs (B,) f32 (qi8) or q (B, D) bf16 (qs unused), against
// codes of format fmt (0: i8 (N, D); 1: row-block packed i4 (N/2, D) uint8;
// 2: bf16 (N, D)) with scales (N,) f32 (unused for bf16), N logical rows ->
// vals / ids (B, N/128). qb (8 or 64) queries a CTA and s (1, 2, 4, 8
// or 16) CTAs a row tile, as ops/scan_select.py::plan_select plans them.
// Needs N % 16384 == 0, D % 128 == 0, 16-byte aligned pointers. Returns a
// cudaError_t: a cluster of s CTAs the card refuses is an error, never a
// smaller split.
int dawn_select(int fmt, int qi8, const void* q, const void* qs,
                const void* codes, const void* scales, long long count,
                void* vals, void* ids, int B, long long N, int D, int qb,
                int s, void* stream) {
  if (B <= 0 || N <= 0 || N % TN != 0 || D <= 0 || D % 128 != 0 || s < 1 ||
      s > MAX_SPLIT || (s & (s - 1)) != 0 || N / TN * s > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == FMT_I8 && qi8)
    return launch_qb<FMT_I8, true>(qb, q, qs, codes, scales, count, vals, ids,
                                   B, N, D, s, st);
  if (fmt == FMT_I8)
    return launch_qb<FMT_I8, false>(qb, q, qs, codes, scales, count, vals,
                                    ids, B, N, D, s, st);
  if (fmt == FMT_I4 && qi8)
    return launch_qb<FMT_I4, true>(qb, q, qs, codes, scales, count, vals, ids,
                                   B, N, D, s, st);
  if (fmt == FMT_I4)
    return launch_qb<FMT_I4, false>(qb, q, qs, codes, scales, count, vals,
                                    ids, B, N, D, s, st);
  if (fmt == FMT_BF16 && !qi8)
    return launch_qb<FMT_BF16, false>(qb, q, qs, codes, scales, count, vals,
                                      ids, B, N, D, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
