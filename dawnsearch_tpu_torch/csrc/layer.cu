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
// split into five launches per layer, four of them this file's GEMM:
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
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 128;                // GEMM output columns per CTA

constexpr int EPI_BIAS = 0;
constexpr int EPI_GELU = 1;
constexpr int EPI_LN = 2;

// ---------------------------------------------------------------------------
// The GEMM: out = epilogue(A (M,K) · W + bias), TMA + wgmma, in bf16 or f32.
constexpr int ROW_BYTES = 128;         // a swizzled row: 64 bf16 or 32 f32 of k
constexpr int MAX_CLUSTER = 16;        // non-portable cluster limit

// Shared memory of a BM-row CTA with elements T: the stage ring, its full /
// empty mbarriers, and the LayerNorm epilogue's per-row partial sums (two
// passes). A stage holds BM rows of A (BK of k each) and two W boxes: for
// bf16 the (in, out) matrix's two 64-column halves of BK rows (MN-major,
// 8 KB each); for f32 W_hi and W_lo, 128 rows of BK each (K-major, 16 KB
// each). 1 KB of slack aligns the ring to the swizzle's 1024-byte atom.
template <int BM, typename T>
struct Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NC = BM / 64;               // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;    // + the producer warp
  static constexpr int BK = ROW_BYTES / sizeof(T);  // k per stage: 64 or 32
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int W_BOX = (F32 ? BN : 64) * ROW_BYTES;
  static constexpr int STAGE = A_BYTES + 2 * W_BOX;
  // bf16: 96 KB at BM = 128, so two CTAs share an SM; f32: four stages
  // (192 KB at BM = 128, 160 KB at 64): its registers (the accumulator,
  // a stage's partial sums and the A fragments) allow one CTA an SM
  static constexpr int STAGES = F32 ? 4 : (BM == 128 ? 3 : 4);
  static constexpr size_t bars = (size_t)STAGES * STAGE;
  static constexpr size_t red = bars + 2 * STAGES * sizeof(uint64_t);
  static constexpr size_t bytes = red + 2 * BM * sizeof(float) + 1024;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two adjacent elements as f32, and two f32 stored as T
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Σ over the n CTAs of the cluster, in rank order, of the f32 at p's
// offset and at p + 8 (a thread's two rows); the loads go four ranks at a
// time
__device__ __forceinline__ float2 cluster_rows(const float* p, int n) {
  float2 tot = make_float2(0.0f, 0.0f);
  for (int q0 = 0; q0 < n; q0 += 4) {
    float v[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < n) {
        v[0][q] = sm90::ld_dsmem(p, q0 + q);
        v[1][q] = sm90::ld_dsmem(p + 8, q0 + q);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < n) {
        tot.x += v[0][q];
        tot.y += v[1][q];
      }
  }
  return tot;
}

// bf16 mainloop: both operands from shared memory, wgmma.m64n128k16 with
// W's transpose bit set; a stage is freed once the group after it has
// been issued and its own has retired
template <int BM>
__device__ __forceinline__ void mainloop_bf16(float (&acc)[64],
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int kt, int warp, int lane) {
  using L = Tile<BM, bf16>;
  const int wg = warp / 4;
  for (int t = 0; t < kt; ++t) {
    const int s = t % L::STAGES;
    sm90::mbar_wait(&full[s], (t / L::STAGES) & 1);
    const unsigned char* a = smem + s * L::STAGE + wg * 64 * ROW_BYTES;
    const unsigned char* w = smem + s * L::STAGE + L::A_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk)
      sm90::wgmma_m64n128k16_tb(acc, sm90::wgmma_desc_kmajor(a + kk * 32),
                                sm90::wgmma_desc(w + kk * 2048, L::W_BOX, 1024));
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    // the group of stage t - 1 has retired: its buffers are free
    sm90::wgmma_wait<1>();
    if (t > 0 && lane == 0) sm90::mbar_arrive(&empty[(t - 1) % L::STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// f32 mainloop, 3xTF32: each thread loads its A fragments from the
// swizzled stage (a 16-byte chunk c of row r lies at chunk c ^ (r % 8):
// conflict-free), splits them into hi and lo in registers, and issues
// wgmma.m64n128k8 with A from registers, three a k8 step (A_lo·W_hi,
// A_hi·W_lo, A_hi·W_hi). The tensor cores round their f32 accumulation
// toward zero, a bias that grows with the number of accumulations (over K
// = 1536 it reached 1.2e-5 of the output's scale on the card): so each
// stage's 32 k accumulate into a fresh `part`, which is added to acc on
// the CUDA cores (round to nearest). The fragments are read
// asynchronously, so each stage's group retires before the stage is freed
// and its registers are reused.
template <int BM>
__device__ __forceinline__ void mainloop_tf32(float (&acc)[64],
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int kt, int warp, int lane) {
  using L = Tile<BM, float>;
  constexpr int KS = L::BK / 8;                       // k8 steps a stage
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int t4 = lane % 4;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  for (int t = 0; t < kt; ++t) {
    const int s = t % L::STAGES;
    sm90::mbar_wait(&full[s], (t / L::STAGES) & 1);
    const unsigned char* st = smem + s * L::STAGE;
    const float* a = reinterpret_cast<const float*>(st);
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // fragment register i: row r0 (+8 for odd i), k t4 (+4 for i >= 2)
        const int r = r0 + 8 * (i & 1), c = kk * 8 + t4 + 4 * (i >> 1);
        const float x = a[r * L::BK + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)];
        sm90::split_tf32(x, ah[kk][i], al[kk][i]);
      }
    const unsigned char* wh = st + L::A_BYTES;
    const unsigned char* wl = wh + L::W_BOX;
    sm90::fence_regs(part);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      sm90::wgmma_m64n128k8_tf32(part, al[kk],
                                 sm90::wgmma_desc_kmajor(wh + kk * 32),
                                 kk > 0);
      sm90::wgmma_m64n128k8_tf32(part, ah[kk],
                                 sm90::wgmma_desc_kmajor(wl + kk * 32), 1);
      sm90::wgmma_m64n128k8_tf32(part, ah[kk],
                                 sm90::wgmma_desc_kmajor(wh + kk * 32), 1);
    }
    sm90::wgmma_commit();
    sm90::fence_regs(part);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      sm90::fence_regs(ah[kk]);
      sm90::fence_regs(al[kk]);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// grid (N / 128, ceil(M / BM)); EPI_LN: clusters of (N / 128, 1, 1), so
// a cluster is one row block and blockIdx.x its rank (cx CTAs). T = bf16:
// map_w covers the (K, N) matrix; T = float: map_w and map_wl its (N, K)
// hi and lo halves. A consumer thread holds acc[4j + 2h + e] = C[row0 +
// 8h, n0 + 8j + 2(lane % 4) + e], row0 = m0 + 64·wg + 16·(warp % 4) +
// lane / 4 (wgmma's accumulator layout, the same for both types).
template <int BM, int EPI, typename T>
__global__ void __launch_bounds__(Tile<BM, T>::THREADS)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_wl,
            const float* __restrict__ bias, const T* __restrict__ resid,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            T* __restrict__ out, int M, int N, int K, float eps, int cx) {
  using L = Tile<BM, T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::STAGES;
  float* red = reinterpret_cast<float*>(smem + L::red);   // [2][BM]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < L::NC * 4;                 // warp-uniform
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], L::NC * 4);  // lane 0 of each consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (!consumer) {
    if (lane == 0) {
      sm90::prefetch_tensormap(&map_a);
      sm90::prefetch_tensormap(&map_w);
      if (L::F32) sm90::prefetch_tensormap(&map_wl);
      for (int t = 0; t < kt; ++t) {
        const int s = t % L::STAGES;
        if (t >= L::STAGES)
          sm90::mbar_wait(&empty[s], ((t / L::STAGES) - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        unsigned char* w = st + L::A_BYTES;
        const int k0 = t * L::BK;
        sm90::mbar_expect_tx(&full[s], L::STAGE);
        sm90::tma_load_2d(st, &map_a, &full[s], k0, m0);
        if (L::F32) {
          sm90::tma_load_2d(w, &map_w, &full[s], k0, n0);
          sm90::tma_load_2d(w + L::W_BOX, &map_wl, &full[s], k0, n0);
        } else {
          sm90::tma_load_2d(w, &map_w, &full[s], n0, k0);
          sm90::tma_load_2d(w + L::W_BOX, &map_w, &full[s], n0 + 64, k0);
        }
      }
    }
    __syncwarp();
  } else if constexpr (L::F32) {
    mainloop_tf32<BM>(acc, smem, full, empty, kt, warp, lane);
  } else {
    mainloop_bf16<BM>(acc, smem, full, empty, kt, warp, lane);
  }

  const int rl = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // local row
  const int c0 = n0 + (lane % 4) * 2;
  if (EPI != EPI_LN) {
    if (!consumer) return;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        float v0 = acc[4 * j + 2 * h] + b0;
        float v1 = acc[4 * j + 2 * h + 1] + b1;
        if (EPI == EPI_GELU) {
          v0 = gelu_as(v0);
          v1 = gelu_as(v1);
        }
        if (r < M) store2(out + (size_t)r * N + c, v0, v1);
      }
    }
    return;
  }

  // LayerNorm across the cluster: pass 1 the mean, pass 2 the variance of
  // the deviations; every thread (the producer warp too) meets the three
  // cluster barriers
  float part[2] = {0.0f, 0.0f};
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        const float2 x = r < M ? load2(resid + (size_t)r * N + c)
                               : make_float2(0.0f, 0.0f);
        float& v0 = acc[4 * j + 2 * h];
        float& v1 = acc[4 * j + 2 * h + 1];
        v0 = (v0 + b0) + x.x;
        v1 = (v1 + b1) + x.y;
        part[h] += v0;
        part[h] += v1;
      }
    }
  }
  part[0] = quad_sum(part[0]);
  part[1] = quad_sum(part[1]);
  if (consumer && lane % 4 == 0) {
    red[rl] = part[0];
    red[rl + 8] = part[1];
  }
  __syncwarp();
  sm90::cluster_sync();
  float mean[2] = {0.0f, 0.0f};
  part[0] = part[1] = 0.0f;
  if (consumer) {
    const float2 tot = cluster_rows(red + rl, cx);
    mean[0] = tot.x / N;
    mean[1] = tot.y / N;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = acc[4 * j + e] - mean[e / 2];
        part[e / 2] += d * d;
      }
  }
  part[0] = quad_sum(part[0]);
  part[1] = quad_sum(part[1]);
  if (consumer && lane % 4 == 0) {
    red[BM + rl] = part[0];
    red[BM + rl + 8] = part[1];
  }
  __syncwarp();
  sm90::cluster_sync();
  float rstd[2] = {0.0f, 0.0f};
  if (consumer) {
    const float2 tot = cluster_rows(red + BM + rl, cx);
    rstd[0] = rsqrtf(tot.x / N + eps);
    rstd[1] = rsqrtf(tot.y / N + eps);
  }
  // this CTA has read its peers' partials: it arrives now and waits only
  // before it leaves, so no CTA frees shared memory a peer still reads
  __syncwarp();
  sm90::cluster_arrive();
  if (consumer) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j * 8;
      const float s0 = ln_s[c], s1 = ln_s[c + 1];
      const float b0 = ln_b[c], b1 = ln_b[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rl + 8 * h;
        const float y0 = (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * s0 + b0;
        const float y1 = (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * s1 + b1;
        if (r < M) store2(out + (size_t)r * N + c, y0, y1);
      }
    }
  }
  __syncwarp();
  sm90::cluster_wait();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (CUDA 12.5 added the versioned lookup and deprecated the other).
cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major (rows, cols) matrix of T as a 2-D tensor map of (box_rows,
// box_cols) boxes under the 128-byte swizzle; out-of-bounds reads are 0.
// Needs a 16-byte aligned base and rows of a multiple of 16 bytes.
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows, int box_cols) {
  EncodeTiledFn encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether clusters of cx CTAs of gemm_kernel<BM, EPI, T> fit the card
// (cached: the answer depends only on the kernel and cx). A refusal is an
// error, never a smaller cluster.
template <int BM, int EPI, typename T>
cudaError_t cluster_fits(const cudaLaunchConfig_t& cfg, int cx) {
  static signed char fits[MAX_CLUSTER + 1] = {};
  signed char& f = fits[cx];
  if (f == 0) {
    int n = 0;
    auto kernel = gemm_kernel<BM, EPI, T>;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    f = n > 0 ? 1 : -1;
  }
  return f > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// w: bf16, the (K, N) matrix; f32, W_hi (N, K) with w_lo its W_lo
template <int BM, int EPI, typename T>
cudaError_t launch_gemm(const void* a, const void* w, const void* w_lo,
                        const void* bias, const void* resid, const void* ln_s,
                        const void* ln_b, void* out, int M, int N, int K,
                        float eps, cudaStream_t stream) {
  using L = Tile<BM, T>;
  CUtensorMap map_a, map_w, map_wl;
  cudaError_t err = tensor_map<T>(&map_a, a, M, K, BM, L::BK);
  if (err == cudaSuccess)
    err = L::F32 ? tensor_map<T>(&map_w, w, N, K, BN, L::BK)
                 : tensor_map<T>(&map_w, w, K, N, L::BK, 64);
  if (err != cudaSuccess) return err;
  if (L::F32) {
    err = tensor_map<T>(&map_wl, w_lo, N, K, BN, L::BK);
    if (err != cudaSuccess) return err;
  } else {
    map_wl = map_w;  // unread: bf16 reads both halves of W through map_w
  }
  auto kernel = gemm_kernel<BM, EPI, T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err == cudaSuccess && EPI == EPI_LN)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // LN: one row block a cluster
  int cx = EPI == EPI_LN ? N / BN : 1;
  if (cx > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cx > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cx;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cluster_fits<BM, EPI, T>(cfg, cx);
    if (err != cudaSuccess) return err;
  }
  const float* bias_p = static_cast<const float*>(bias);
  const T* resid_p = static_cast<const T*>(resid);
  const float* ln_s_p = static_cast<const float*>(ln_s);
  const float* ln_b_p = static_cast<const float*>(ln_b);
  T* out_p = static_cast<T*>(out);
  void* args[] = {&map_a, &map_w, &map_wl, &bias_p, &resid_p, &ln_s_p,
                  &ln_b_p, &out_p, &M, &N, &K, &eps, &cx};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BM = 128 where its tiles fill a wave of the card's 132 SMs, else 64
template <int EPI, typename T>
cudaError_t launch_gemm_bm(const void* a, const void* w, const void* w_lo,
                           const void* bias, const void* resid,
                           const void* ln_s, const void* ln_b, void* out,
                           int M, int N, int K, float eps, cudaStream_t s) {
  if ((long long)((M + 127) / 128) * (N / BN) >= 132)
    return launch_gemm<128, EPI, T>(a, w, w_lo, bias, resid, ln_s, ln_b, out,
                                    M, N, K, eps, s);
  return launch_gemm<64, EPI, T>(a, w, w_lo, bias, resid, ln_s, ln_b, out, M,
                                 N, K, eps, s);
}

template <typename T>
cudaError_t launch_epi(int epi, const void* a, const void* w, const void* w_lo,
                       const void* bias, const void* resid, const void* ln_s,
                       const void* ln_b, void* out, int M, int N, int K,
                       float eps, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS:
      return launch_gemm_bm<EPI_BIAS, T>(a, w, w_lo, bias, resid, ln_s, ln_b,
                                         out, M, N, K, eps, s);
    case EPI_GELU:
      return launch_gemm_bm<EPI_GELU, T>(a, w, w_lo, bias, resid, ln_s, ln_b,
                                         out, M, N, K, eps, s);
    case EPI_LN:
      return launch_gemm_bm<EPI_LN, T>(a, w, w_lo, bias, resid, ln_s, ln_b,
                                       out, M, N, K, eps, s);
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
// tf32_pair). Needs N % 128 == 0, N <= 2048 for the LayerNorm, K a
// multiple of 16 bytes of elements, 16-byte aligned a, w and w_lo;
// resid/ln_* are read only for epi 2. Returns a cudaError_t: a tensor
// map, shared-memory size or cluster shape the card refuses is an error,
// never a smaller launch.
int dawn_bert_gemm(const void* a, const void* w, const void* w_lo,
                   const void* bias, const void* resid, const void* ln_s,
                   const void* ln_b, void* out, int M, int N, int K, int epi,
                   float eps, int f32, void* stream) {
  if (M <= 0 || N % BN != 0 || K <= 0 || K % (f32 ? 4 : 8) != 0 ||
      (f32 && w_lo == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch_epi<float>(epi, a, w, w_lo, bias, resid, ln_s, ln_b,
                                  out, M, N, K, eps, s);
  return (int)launch_epi<bf16>(epi, a, w, w_lo, bias, resid, ln_s, ln_b, out,
                               M, N, K, eps, s);
}

const char* dawn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
