// ModernBERT's projections and its embedding LayerNorm on Hopper (sm_90a),
// bf16 in: the long-context library (ops/_cuda.py::long_lib), built only
// when a ModernBERT model is, so the BERT, MPNet and RoBERTa kernels of
// csrc/*.cu compile exactly as before. No TPU kernel is replaced: the JAX
// package has no ModernBERT.
//
// The GEMM out = epi(A (M, K) · W (K, N)), bf16 operands, f32 sums over k
// in order, W read in its (in, out) layout through wgmma's transpose bit.
// QKV + RoPE (L3) and GeGLU (L4) are bound by operations, the residual +
// LayerNorm (L5) by bytes. It has its own schedule, not gemm.cuh's (whose
// BERT instances keep their tuning), shaped by what an H100 showed at M =
// 524,288: wgmma alone runs at 87% of the peak, but a CTA's TMA stages
// arrive at about 65 GB/s an SM whatever the cluster multicasts, so a wide
// tile (fewer bytes a product) is what feeds it, one box of A a stage (A
// cut in four boxes ran 1.5x slower), and the epilogue must not stall the
// products.
//
// Persistent and warp-specialised: each CTA walks tiles with the grid's
// stride; a producer (one thread) keeps a ring of STAGES stages filled by
// TMA, running on into the next tile while the consumer warpgroups (64
// rows each) finish this one; the consumers issue wgmma (one group in
// flight while the next is issued), then the epilogue. The roles are
// taken from the warpgroup index, broadcast, and only the consumers hold
// an accumulator. Tiles, by the launch's shape (never by a setting):
//   128 x 256  RoPE and the LayerNorm, one CTA an SM: two consumer
//              warpgroups (m64n256k16, 128 f32 a thread) and a producer
//              warpgroup that hands its registers over (setmaxnreg 24 /
//              240); 4 stages of 48 KB (3 with the LayerNorm's staging)
//   128 x 128  GeGLU, two CTAs an SM (a producer warp, 3 stages of 32 KB):
//              its erf polynomial costs a third of its mainloop, and the
//              other CTA's products run under it; also every epilogue
//              where N is no multiple of 256
//   64 rows    where 128-row tiles would not fill the card (small M)
// The epilogues (no bias: ModernBERT has none); what they read comes in
// before the mainloop, and what they write leaves through a staging buffer
// by TMA stores that drain under the next tile (each warpgroup its own
// rows, so the two need not meet):
//   EPI_ROPE    qkv = bf16(RoPE(acc)): a 128-column block of q or k holds
//               two whole heads of 64; a thread's accumulator holds
//               columns 8j + 2(lane % 4) + e, so dims d and d + 32 of a
//               head are its j and j + 4, rotated in registers with the
//               (S, 32) f32 cos and sin of the row's position (row % S):
//               (x, y) -> (x·c − y·s, y·c + x·s), then rounded once. The
//               v tiles are stored as they are.
//   EPI_GEGLU   out = bf16(gelu(acc_a) · acc_g): W's columns interleaved
//               at load (ops/modernbert.py::interleave_gate), so a tile's
//               first 64 columns are 64 of the GELU half and its last 64
//               the same of the gate half, the thread's j and j + 8; the
//               tile writes 64 columns of the (M, N / 2) output. GELU
//               with common.cuh's erf polynomial, op by op.
//   EPI_LN      h = acc + resid (f32, the residual stream), written f32,
//   EPI_LN_F32  and y = LN(h)·s, bf16 (the next layer's norm, or the
//               MLP's; staged) or f32 (the final norm), scale only, two
//               passes (the mean, then Σ(v − mean)²). A cluster of N / BN
//               CTAs holds whole rows: each sums its row partials over its
//               columns in order, stores them into every CTA's slot of its
//               rank with st.async (completing on that CTA's mbarrier), and
//               sums the slots in rank order; no cluster barrier a tile.
// The embedding: one warp a row gathers E[id] (f32), forms LN·s in f32
// (two passes, warp sums) and writes it as f32 x and bf16 a (ModernBERT's
// first attn_norm is the identity).
//
// Qwen3's layers (ops/qwen3.py) add three epilogues on the same ring. Its
// RMSNorms are w ⊙ v · r with one scale r = 1 / sqrt(mean(v²) + eps) a
// row, so a norm is split between two launches and needs no cluster: the
// launch that forms v writes bf16(v ⊙ w) and Σv² over each of its column
// tiles (`ssq`, (M, parts) f32), and the launch that reads it multiplies
// its accumulator by r, summed from the parts in order (A·W is linear in
// A's rows).
//   EPI_RMS     h = acc + resid, written f32; y = bf16(h ⊙ s) (staged);
//               the tile's Σh² a row into ssq_out[row, tile]
//   EPI_QKN     qkv = bf16(RoPE(RMS_head(r·acc) ⊙ w_head)) on each
//               128-column q or k head (its Σ over the quad's 4 threads,
//               weights qn or kn by the head's column), dims d and d + 64
//               the thread's j and j + 8 with the (S, 64) tables; v heads
//               as r·acc
//   EPI_SWIGLU  out = bf16(silu(r·acc_g) · r·acc_u), GeGLU's interleaved
//               layout and tile

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "../gemm.cuh"

namespace {

constexpr int EPI_ROPE = 0;
constexpr int EPI_GEGLU = 1;
constexpr int EPI_LN_BF16 = 2;
constexpr int EPI_LN_F32 = 3;
constexpr int EPI_QKN = 4;
constexpr int EPI_SWIGLU = 5;
constexpr int EPI_RMS = 6;

struct LongArgs {
  void* out;           // ROPE, GEGLU: bf16; LN: f32 h
  void* out2;          // LN: y (bf16 or f32)
  const float* resid;  // LN: f32 (M, N)
  const float* ln_s;   // LN: (N,)
  const float* cos;    // ROPE: (>= S, hd / 2)
  const float* sin;
  int M, N, K, S, rope_cols;
  float eps;
  int cn;              // LN: CTAs of the cluster, one a column tile
  const float* ssq_in;   // QKN, SWIGLU: (M, rparts) Σv² parts of A's rows
  float* ssq_out;        // RMS: (M, N / BN) Σh² of each column tile
  const float* qn;       // QKN: q's and k's per-head norm weights, (hd,)
  const float* kn;
  int rparts, q_cols;    // QKN: q heads below q_cols, k below rope_cols
};

// d (64 x 256, f32) += A (64 x 16, K-major) · B (16 x 256, MN-major: W's
// (in, out) rows read through the transpose bit), both from shared memory
__device__ __forceinline__ void wgmma_m64n256k16_tb(float (&d)[128],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// -- the LayerNorm cluster's exchange of row partials -------------------------

__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(sm90::smem_u32(local)), "r"(rank));
  return r;
}

// v into a cluster CTA's shared memory, completing 4 bytes on its mbarrier
// (st.async: no fence; the completion releases the store at cluster scope)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// wait for a phase of a local mbarrier that other CTAs arrive on
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -- TMA stores -----------------------------------------------------------------

// one box of shared memory (the map's box, 128-byte swizzle) to the
// tensor at (c0 innermost, c1); rows past the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// -- the GEMM -------------------------------------------------------------------

// A CTA's shared memory: STAGES stages, each BM rows of A (one box of 64
// k, 128 bytes a row) and W's BN / 64 boxes of 64 columns by 64 k rows
// (8 KB each), under the 128-byte swizzle; the output staging, boxes of
// 64 bf16 columns by BM rows (the same swizzle); the stages' full and
// empty mbarriers and the LayerNorm's two exchange mbarriers; its row
// partials, [pass][rank][BM].
template <int BM, int BN, int EPI>
struct Ring {
  static constexpr bool LN = EPI == EPI_LN_BF16 || EPI == EPI_LN_F32;
  static constexpr bool GLU = EPI == EPI_GEGLU || EPI == EPI_SWIGLU;
  static constexpr bool RESID = LN || EPI == EPI_RMS;   // reads resid
  static constexpr int NC = BM / 64;                       // consumer warpgroups
  static constexpr bool WIDE = BN == 256;
  static constexpr int THREADS = NC * 128 + (WIDE ? 128 : 32);
  // GeGLU's epilogue (an erf polynomial an output) is as long as a third
  // of its mainloop: two CTAs an SM, so one's products run under the
  // other's epilogue
  static constexpr int CTAS = GLU ? 2 : 1;
  static constexpr int ACC = BN / 2;                       // f32 a thread
  static constexpr int JN = BN / 8;                        // column pairs a row
  static constexpr int BK = 64;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int W_BOX = 64 * ROW_BYTES;
  static constexpr int STAGE = A_BYTES + (BN / 64) * W_BOX;
  // staged output boxes of 64 bf16 columns: RoPE's two, GeGLU's tile, the
  // bf16 LayerNorm's tile (the f32 one is stored from registers)
  static constexpr int O_BOXES =
      EPI == EPI_LN_F32 ? 0
                        : (EPI == EPI_ROPE || EPI == EPI_QKN
                               ? 2
                               : BN / (RESID ? 64 : 128));
  static constexpr int STAGES =
      CTAS == 2 ? 3
                : (WIDE ? 4 : 6) - (EPI == EPI_LN_BF16 || EPI == EPI_RMS ? 1 : 0);
  static constexpr int MAX_CX = MAX_CLUSTER * 128 / BN;    // LN ranks
  static constexpr int O_BOX = BM * ROW_BYTES;
  static constexpr size_t out = (size_t)STAGES * STAGE;
  static constexpr size_t bars = out + O_BOXES * O_BOX;
  static constexpr size_t red = bars + (2 * STAGES + 2) * sizeof(uint64_t);
  static constexpr size_t bytes =
      red + (LN ? 2 * MAX_CX * BM * sizeof(float) : 0);
};

// Every launch is persistent: CTA b walks the linear tiles (row block ·
// nt + column tile) b, b + gridDim.x, ..., a row block's column tiles side
// by side. A LayerNorm cluster is nt CTAs, so its CTAs take one row
// block's nt tiles at a time, rank = column tile.

// The producer (one thread): each tile's kt stages into the ring, each
// behind the consumers' release of its slot, running ahead into the next
// tile while the consumers finish this one
template <int BM, int BN, int EPI>
__device__ __forceinline__ void long_produce(const CUtensorMap* map_a,
                                             const CUtensorMap* map_w,
                                             unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             int nt, int mt, int kt) {
  using R = Ring<BM, BN, EPI>;
  sm90::prefetch_tensormap(map_a);
  sm90::prefetch_tensormap(map_w);
  int it = 0;  // stages issued, over all the CTA's tiles
  for (int tile = blockIdx.x; tile < nt * mt; tile += gridDim.x) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
    for (int t = 0; t < kt; ++t, ++it) {
      const int s = it % R::STAGES;
      if (it >= R::STAGES)
        sm90::mbar_wait(&empty[s], ((it / R::STAGES) - 1) & 1);
      unsigned char* sp = smem + s * R::STAGE;
      const int k0 = t * R::BK;
      sm90::mbar_expect_tx(&full[s], R::STAGE);
      sm90::tma_load_2d(sp, map_a, &full[s], k0, m0);
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        sm90::tma_load_2d(sp + R::A_BYTES + b * R::W_BOX, map_w, &full[s],
                          n0 + 64 * b, k0);
    }
  }
}

// One tile's products: wgmma from the ring, one group a stage; a stage is
// freed once the group after it has been issued and its own has retired,
// so one group stays in flight while the next is issued; the tile's last
// stage after the last wait. `it` counts stages over the CTA's tiles, as
// the producer's does.
template <class R>
__device__ __forceinline__ void long_mainloop(float (&acc)[R::ACC],
                                              const unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int kt, int& it, int wg,
                                              int lane) {
  for (int t = 0; t < kt; ++t, ++it) {
    const int s = it % R::STAGES;
    sm90::mbar_wait(&full[s], (it / R::STAGES) & 1);
    const unsigned char* a = smem + s * R::STAGE + wg * 64 * ROW_BYTES;
    const unsigned char* w = smem + s * R::STAGE + R::A_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R::BK / 16; ++kk) {
      const uint64_t da = sm90::wgmma_desc_kmajor(a + kk * 32);
      const uint64_t db = sm90::wgmma_desc(w + kk * 2048, R::W_BOX, 1024);
      if constexpr (R::WIDE)
        wgmma_m64n256k16_tb(acc, da, db);
      else
        sm90::wgmma_m64n128k16_tb(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (t > 0 && lane == 0)
      sm90::mbar_arrive(&empty[(it - 1) % R::STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % R::STAGES]);
}

// A thread's accumulator holds rows r0 and r0 + 8 (h = 0, 1) at columns
// n0 + 8j + t2 + e (j < BN / 8, e < 2): acc[4j + 2h + e]. Each 128 columns
// (b) are the RoPE and GeGLU epilogues' unit: acc[64b ...]. What an
// epilogue reads from memory first is loaded into `pre` before the
// mainloop, so its latency passes under the products.

// RoPE's cos and sin at both rows' positions: pre[8h + j] = cos, pre[8h +
// 4 + j] = sin at dims 8j + t2 + (0, 1)
__device__ __forceinline__ void rope_rows(float2 (&pre)[16], const LongArgs& g,
                                          int r0, int n0, int t2) {
  if (n0 >= g.rope_cols) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = min(r0 + 8 * h, g.M - 1) % g.S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pre[8 * h + j] = load2(g.cos + (size_t)pos * 32 + 8 * j + t2);
      pre[8 * h + 4 + j] = load2(g.sin + (size_t)pos * 32 + 8 * j + t2);
    }
  }
}

// One block of the bf16 output, BOXES x 64 columns, through the staging
// buffer; each consumer warpgroup stages and stores its own 64 rows, so
// the two need not meet after the mainloop (the faster one runs on into
// the next tile's stages while the other finishes its epilogue). The
// thread's pair(h, j) goes to row rl + 8h, column 8j + t2 of the block
// (box j / 8, its 16-byte chunk j % 8 at chunk (j % 8) ^ (row % 8), and
// row % 8 is lane / 4: conflict-free); then the warpgroup's first thread
// stores its boxes to (c0, m0 + 64·wg) by TMA, which skips rows past M.
// The warpgroup's half is rewritten once its last stores have read it.
template <class R, int BOXES, class F>
__device__ __forceinline__ void store_block(unsigned char* stage,
                                            const CUtensorMap* map_o, int c0,
                                            int m0, int rl, int lane,
                                            F pair) {
  const int wg = rl / 64;
  const bool leader = threadIdx.x % 128 == 0;
  if (leader) bulk_wait_read();
  sm90::named_sync(1 + wg, 128);
  const int ph = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8 * BOXES; ++j) {
      const float2 v = pair(h, j);
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (j / 8) * R::O_BOX + (rl + 8 * h) * ROW_BYTES +
          (((j % 8) ^ ph) << 4) + 4 * t4) = __floats2bfloat162_rn(v.x, v.y);
    }
  sm90::fence_proxy_async_shared();
  sm90::named_sync(1 + wg, 128);
  if (leader) {
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma_store_2d(map_o, stage + b * R::O_BOX + wg * 64 * ROW_BYTES,
                   c0 + 64 * b, m0 + 64 * wg);
    bulk_commit();
  }
}

// qkv = bf16(RoPE(acc)): a 128-column block of q or k holds two whole
// heads, dims d and d + 32 of a head being the thread's j and j + 4
template <class R>
__device__ __forceinline__ void epi_rope(float (&acc)[R::ACC],
                                         const float2 (&pre)[16],
                                         const LongArgs& g,
                                         unsigned char* stage,
                                         const CUtensorMap* map_o, int m0,
                                         int n0, int rl, int lane) {
  if (n0 < g.rope_cols) {  // rope_cols = 2H, a multiple of 256
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int head = 0; head < R::ACC / 32; ++head)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lo = 4 * (8 * head + j) + 2 * h + e;
            const int hi = lo + 16;  // j + 4: dim d + 32
            const float2 cs = pre[8 * h + j], sn = pre[8 * h + 4 + j];
            const float c = e ? cs.y : cs.x;
            const float s = e ? sn.y : sn.x;
            const float x = acc[lo], y = acc[hi];
            acc[lo] = x * c - y * s;
            acc[hi] = y * c + x * s;
          }
  }
#pragma unroll
  for (int b = 0; b < R::ACC / 64; ++b)
    store_block<R, 2>(stage, map_o, n0 + 128 * b, m0, rl, lane,
                      [&](int h, int j) {
                        const int i = 64 * b + 4 * j + 2 * h;
                        return make_float2(acc[i], acc[i + 1]);
                      });
}

// out = bf16(gelu(acc_a) · acc_g): each 128-column block b holds 64 GELU
// columns (the thread's j < 8 of the block) and their gates (j + 8), and
// gives 64 columns of the (M, N / 2) output at n0 / 2 + 64b
template <class R>
__device__ __forceinline__ void epi_geglu(const float (&acc)[R::ACC],
                                          unsigned char* stage,
                                          const CUtensorMap* map_o, int m0,
                                          int n0, int rl, int lane) {
  store_block<R, R::ACC / 64>(
      stage, map_o, n0 / 2, m0, rl, lane, [&](int h, int j) {
        const int i = 64 * (j / 8) + 4 * (j % 8) + 2 * h;
        return make_float2(__fmul_rn(gelu_as(acc[i]), acc[i + 32]),
                           __fmul_rn(gelu_as(acc[i + 1]), acc[i + 33]));
      });
}

// The LayerNorm's cross-CTA sum of one pass over the cluster's cn CTAs:
// each quad leader stores its two rows' partials into slot [pass][rank] of
// each of them with st.async, which completes their bytes on that CTA's
// mbarrier of the pass; one thread a CTA arms its own for the pass's
// bytes; then every thread waits on it and sums the slots in rank order.
// Slots and mbarriers are reused from tile to tile without a cluster
// barrier: a CTA stores pass p of a tile only after it holds every CTA's
// data of the pass before (1 − p), which each CTA sends only after it has
// read its pass p slots of the tile before.
template <int BM, int MAX_CX>
__device__ __forceinline__ float2 cluster_sum(float* red, uint64_t* bar,
                                              float2 part, int pass, int rank,
                                              int cn, int rl, int lane,
                                              uint32_t parity) {
  if (threadIdx.x == 0)
    sm90::mbar_expect_tx(bar, cn * BM * sizeof(float));  // BM rows from each
  float* slot = red + (pass * MAX_CX + rank) * BM + rl;
  if (lane % 4 == 0)
    for (int q = 0; q < cn; ++q) {
      const uint32_t rbar = cluster_addr(bar, q);
      st_async(cluster_addr(slot, q), part.x, rbar);
      st_async(cluster_addr(slot + 8, q), part.y, rbar);
    }
  wait_cluster(bar, parity);
  float2 tot = make_float2(0.0f, 0.0f);
  const float* p = red + pass * MAX_CX * BM + rl;
  for (int q = 0; q < cn; ++q) {
    tot.x += p[q * BM];
    tot.y += p[q * BM + 8];
  }
  return tot;
}

// a row's residual at the thread's columns c0 + 8j (zeros past M)
template <int JN>
__device__ __forceinline__ void resid_row(float2 (&x)[JN], const LongArgs& g,
                                          int r, int c0) {
#pragma unroll
  for (int j = 0; j < JN; ++j)
    x[j] = r < g.M ? load2(g.resid + (size_t)r * g.N + c0 + j * 8)
                   : make_float2(0.0f, 0.0f);
}

// v = acc + resid (f32), written as h; then y = LN(v)·s over the cluster's
// whole rows, two passes (the mean, then Σ(v − mean)²), each CTA's row
// partial summed over its columns in order and the CTAs' partials in rank
// order. Row r0's residual came in `pre` before the mainloop; row r0 + 8's
// is loaded at once here, all in flight before the first add.
template <int BM, int BN, int EPI>
__device__ __forceinline__ void epi_ln(float (&acc)[BN / 2],
                                       float2 (&pre)[BN / 8],
                                       const LongArgs& g, float* red,
                                       uint64_t* lnbar, uint32_t parity,
                                       unsigned char* stage,
                                       const CUtensorMap* map_o, int m0,
                                       int r0, int n0, int t2, int lane) {
  using R = Ring<BM, BN, EPI>;
  constexpr int JN = BN / 8;
  float* hout = static_cast<float*>(g.out);
  const int M = g.M, N = g.N, cn = g.cn, rank = blockIdx.x % cn;
  const int c0 = n0 + t2, rl = r0 % BM;
  float2 part = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (h == 1) resid_row<JN>(pre, g, r, c0);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      v0 = v0 + pre[j].x;
      v1 = v1 + pre[j].y;
      if (r < M) store2(hout + (size_t)r * N + c0 + j * 8, v0, v1);
      sum += v0;
      sum += v1;
    }
    if (h == 0)
      part.x = sum;
    else
      part.y = sum;
  }
  part.x = quad_sum(part.x);
  part.y = quad_sum(part.y);
  float2 tot = cluster_sum<BM, R::MAX_CX>(red, &lnbar[0], part, 0, rank, cn,
                                          rl, lane, parity);
  const float mean[2] = {tot.x / N, tot.y / N};
  part = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = acc[4 * j + e] - mean[e / 2];
      if (e < 2)
        part.x += d * d;
      else
        part.y += d * d;
    }
  part.x = quad_sum(part.x);
  part.y = quad_sum(part.y);
  tot = cluster_sum<BM, R::MAX_CX>(red, &lnbar[1], part, 1, rank, cn, rl,
                                   lane, parity);
  const float rstd[2] = {rsqrtf(tot.x / N + g.eps), rsqrtf(tot.y / N + g.eps)};
  if constexpr (EPI == EPI_LN_BF16) {
    store_block<R, R::O_BOXES>(
        stage, map_o, n0, m0, rl, lane, [&](int h, int j) {
          const int i = 4 * j + 2 * h, c = c0 + j * 8;
          return make_float2((acc[i] - mean[h]) * rstd[h] * g.ln_s[c],
                             (acc[i + 1] - mean[h]) * rstd[h] * g.ln_s[c + 1]);
        });
  } else {
    float* y = static_cast<float*>(g.out2);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int c = c0 + j * 8;
      const float s0 = g.ln_s[c], s1 = g.ln_s[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < M)
          store2(y + (size_t)r * N + c,
                 (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * s0,
                 (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * s1);
      }
    }
  }
}

// -- Qwen3's epilogues -------------------------------------------------------------

// the row scale r = 1 / sqrt(Σ parts / n + eps) of rows r0 and r0 + 8: the
// quad's 4 threads load parts t4, t4 + 4, ... (before the mainloop, into
// `part`), sum them in order and across the quad
__device__ __forceinline__ void scale_parts(float (&part)[2][4],
                                            const LongArgs& g, int r0,
                                            int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(r0 + 8 * h, g.M - 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = t4 + 4 * k;
      part[h][k] = p < g.rparts ? g.ssq_in[(size_t)r * g.rparts + p] : 0.0f;
    }
  }
}

__device__ __forceinline__ void row_scale(float (&rs)[2],
                                          const float (&part)[2][4], int n,
                                          float eps) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) t += part[h][k];
    rs[h] = rsqrtf(quad_sum(t) / n + eps);
  }
}

// qkv = r·acc; each 128-column q or k head then RMS-normed over its 128
// dims (the quad's 4 threads hold a row's 128: 32 each) with its weight,
// and rotated: dims d and d + 64 are the thread's j and j + 8 of the head,
// with cos and sin of the row's position (row % S) at dim 8j + t2 + e
template <class R>
__device__ __forceinline__ void epi_qkn(float (&acc)[R::ACC],
                                        const float (&rs)[2],
                                        const LongArgs& g,
                                        unsigned char* stage,
                                        const CUtensorMap* map_o, int m0,
                                        int n0, int rl, int lane) {
  constexpr int HEADS = R::ACC / 64;  // 128-column heads a tile
  const int t2 = (lane % 4) * 2, r0 = m0 + rl;
#pragma unroll
  for (int i = 0; i < R::ACC; ++i) acc[i] *= rs[(i / 2) % 2];
#pragma unroll
  for (int head = 0; head < HEADS; ++head) {
    const int col = n0 + 128 * head;
    if (col >= g.rope_cols) continue;  // a v head
    const float* nw = col < g.q_cols ? g.qn : g.kn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * (16 * head + j) + 2 * h + e];
          ss += v * v;
        }
      const float rq = rsqrtf(quad_sum(ss) / 128.0f + g.eps);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 w = load2(nw + 8 * j + t2);
        float& v0 = acc[4 * (16 * head + j) + 2 * h];
        float& v1 = acc[4 * (16 * head + j) + 2 * h + 1];
        v0 = v0 * rq * w.x;
        v1 = v1 * rq * w.y;
      }
      const int pos = min(r0 + 8 * h, g.M - 1) % g.S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 cs = load2(g.cos + (size_t)pos * 64 + 8 * j + t2);
        const float2 sn = load2(g.sin + (size_t)pos * 64 + 8 * j + t2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lo = 4 * (16 * head + j) + 2 * h + e;
          const int hi = lo + 32;  // j + 8: dim d + 64
          const float c = e ? cs.y : cs.x;
          const float sv = e ? sn.y : sn.x;
          const float x = acc[lo], y = acc[hi];
          acc[lo] = x * c - y * sv;
          acc[hi] = y * c + x * sv;
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < R::ACC / 64; ++b)
    store_block<R, 2>(stage, map_o, n0 + 128 * b, m0, rl, lane,
                      [&](int h, int j) {
                        const int i = 64 * b + 4 * j + 2 * h;
                        return make_float2(acc[i], acc[i + 1]);
                      });
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, 1.0f + expf(-x));
}

// out = bf16(silu(r·acc_g) · r·acc_u): GeGLU's interleaved block b, its
// gate columns the thread's j < 8 and the up columns j + 8
template <class R>
__device__ __forceinline__ void epi_swiglu(const float (&acc)[R::ACC],
                                           const float (&rs)[2],
                                           unsigned char* stage,
                                           const CUtensorMap* map_o, int m0,
                                           int n0, int rl, int lane) {
  store_block<R, R::ACC / 64>(
      stage, map_o, n0 / 2, m0, rl, lane, [&](int h, int j) {
        const int i = 64 * (j / 8) + 4 * (j % 8) + 2 * h;
        const float r = rs[h];
        return make_float2(__fmul_rn(silu(acc[i] * r), acc[i + 32] * r),
                           __fmul_rn(silu(acc[i + 1] * r), acc[i + 33] * r));
      });
}

// h = acc + resid (f32) written as out; y = bf16(h ⊙ s) staged; each row's
// Σh² over the tile's columns (in order, then across the quad) into
// ssq_out[row, n0 / BN]. Row r0's residual came in `pre`.
template <int BM, int BN>
__device__ __forceinline__ void epi_rms(float (&acc)[BN / 2],
                                        float2 (&pre)[BN / 8],
                                        const LongArgs& g,
                                        unsigned char* stage,
                                        const CUtensorMap* map_o, int m0,
                                        int r0, int n0, int t2, int lane) {
  using R = Ring<BM, BN, EPI_RMS>;
  constexpr int JN = BN / 8;
  float* hout = static_cast<float*>(g.out);
  const int M = g.M, N = g.N, c0 = n0 + t2, rl = r0 % BM;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (h == 1) resid_row<JN>(pre, g, r, c0);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      v0 = v0 + pre[j].x;
      v1 = v1 + pre[j].y;
      if (r < M) store2(hout + (size_t)r * N + c0 + j * 8, v0, v1);
      sum += v0 * v0;
      sum += v1 * v1;
    }
    sum = quad_sum(sum);
    if (lane % 4 == 0 && r < M) g.ssq_out[(size_t)r * (N / BN) + n0 / BN] = sum;
  }
  store_block<R, R::O_BOXES>(stage, map_o, n0, m0, rl, lane,
                             [&](int h, int j) {
                               const int i = 4 * j + 2 * h, c = c0 + j * 8;
                               return make_float2(acc[i] * g.ln_s[c],
                                                  acc[i + 1] * g.ln_s[c + 1]);
                             });
}

// The consumers: per tile, the epilogue's first loads, a fresh
// accumulator, the mainloop, the epilogue. Only they hold an accumulator.
template <int BM, int BN, int EPI>
__device__ __forceinline__ void long_consume(const LongArgs& g,
                                             const CUtensorMap* map_o,
                                             unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             uint64_t* lnbar, float* red,
                                             int nt, int mt, int kt, int wg,
                                             int warp, int lane) {
  using R = Ring<BM, BN, EPI>;
  const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;  // row in the tile
  const int t2 = (lane % 4) * 2;
  int it = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < nt * mt; tile += gridDim.x, parity ^= 1) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
    float2 pre[R::RESID ? R::JN : (EPI == EPI_ROPE ? 16 : 1)];
    float part[2][4];  // QKN, SWIGLU: the rows' Σv² parts
    if constexpr (EPI == EPI_ROPE)
      rope_rows(pre, g, m0 + rl, n0, t2);
    else if constexpr (R::RESID)
      resid_row<R::JN>(pre, g, m0 + rl, n0 + t2);
    else if constexpr (EPI == EPI_QKN || EPI == EPI_SWIGLU)
      scale_parts(part, g, m0 + rl, lane % 4);
    float acc[R::ACC];
#pragma unroll
    for (int i = 0; i < R::ACC; ++i) acc[i] = 0.0f;
    long_mainloop<R>(acc, smem, full, empty, kt, it, wg, lane);
    if constexpr (EPI == EPI_ROPE) {
      epi_rope<R>(acc, pre, g, smem + R::out, map_o, m0, n0, rl, lane);
    } else if constexpr (EPI == EPI_GEGLU) {
      epi_geglu<R>(acc, smem + R::out, map_o, m0, n0, rl, lane);
    } else if constexpr (EPI == EPI_QKN || EPI == EPI_SWIGLU) {
      float rs[2];
      row_scale(rs, part, g.K, g.eps);
      if constexpr (EPI == EPI_QKN)
        epi_qkn<R>(acc, rs, g, smem + R::out, map_o, m0, n0, rl, lane);
      else
        epi_swiglu<R>(acc, rs, smem + R::out, map_o, m0, n0, rl, lane);
    } else if constexpr (EPI == EPI_RMS) {
      epi_rms<BM, BN>(acc, pre, g, smem + R::out, map_o, m0, m0 + rl, n0, t2,
                      lane);
    } else {
      epi_ln<BM, BN, EPI>(acc, pre, g, red, lnbar, parity, smem + R::out,
                          map_o, m0, m0 + rl, n0, t2, lane);
    }
  }
  if constexpr (R::O_BOXES > 0)
    if (threadIdx.x % 128 == 0) bulk_wait();  // the last stores have landed
}

// Persistent and warp-specialised: warpgroups 0 .. NC − 1 consume, the
// last one produces. The role is the warpgroup index broadcast from lane 0,
// so ptxas sees each branch that holds a wgmma taken by whole warps, and
// the accumulator lives only in the consumers' branch. A LayerNorm cluster
// meets at the start (its exchange mbarriers initialised) and at the end,
// each role in its own branch.
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(Ring<BM, BN, EPI>::THREADS,
                                  Ring<BM, BN, EPI>::CTAS)
long_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_o, const LongArgs g) {
  using R = Ring<BM, BN, EPI>;
  // the swizzled boxes need 1024-byte alignment, which the dynamic shared
  // memory's base has (the kernel has no static shared memory)
  extern __shared__ __align__(1024) unsigned char smem[];
  if (sm90::smem_u32(smem) & 1023) __trap();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::bars);
  uint64_t* empty = full + R::STAGES;
  uint64_t* lnbar = empty + R::STAGES;
  float* red = reinterpret_cast<float*>(smem + R::red);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = g.N / BN, mt = (g.M + BM - 1) / BM;
  const int kt = g.K / R::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], R::NC * 4);
    }
    if constexpr (R::LN) {  // armed by one thread, filled by st.async
      sm90::mbar_init(&lnbar[0], 1);
      sm90::mbar_init(&lnbar[1], 1);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if constexpr (R::LN) sm90::cluster_sync();

  if (wg == R::NC) {
    if constexpr (R::WIDE && R::NC == 2) sm90::setmaxnreg_dec<24>();
    if (warp == R::NC * 4 && lane == 0)
      long_produce<BM, BN, EPI>(&map_a, &map_w, smem, full, empty, nt, mt,
                                kt);
    __syncwarp();
    if constexpr (R::LN) sm90::cluster_sync();
  } else {
    if constexpr (R::WIDE && R::NC == 2) sm90::setmaxnreg_inc<240>();
    long_consume<BM, BN, EPI>(g, &map_o, smem, full, empty, lnbar, red, nt,
                              mt, kt, wg, warp, lane);
    if constexpr (R::LN) sm90::cluster_sync();
  }
}

// CTAs (LN: clusters) of a kernel resident at once on the card
inline cudaError_t resident(const void* kernel, const cudaLaunchConfig_t& cfg,
                            int* n) {
  if (cfg.numAttrs) return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, cfg.blockDim.x, cfg.dynamicSmemBytes);
  *n = sms * per_sm;
  return err;
}

template <int BM, int BN, int EPI>
cudaError_t launch_long(const void* a, const void* w, LongArgs g,
                        cudaStream_t stream) {
  using R = Ring<BM, BN, EPI>;
  const int nt = g.N / BN, mt = (g.M + BM - 1) / BM;
  g.cn = R::LN ? nt : 1;
  if (g.cn > R::MAX_CX) return cudaErrorInvalidValue;
  // map_o: the staged bf16 output, RoPE's (M, N), GeGLU's (M, N / 2) or
  // the LayerNorm's y (M, N) (unread by the f32 LayerNorm)
  CUtensorMap map_a, map_w, map_o;
  cudaError_t err = sm90::tensor_map_2d(&map_a, a, 2, g.M, g.K, BM, R::BK);
  if (err == cudaSuccess)
    err = sm90::tensor_map_2d(&map_w, w, 2, g.K, g.N, R::BK, 64);
  if (err == cudaSuccess)
    err = EPI == EPI_LN_F32
              ? sm90::tensor_map_2d(&map_o, a, 2, g.M, g.K, BM, R::BK)
              : sm90::tensor_map_2d(&map_o, R::RESID ? g.out2 : g.out, 2,
                                    g.M, R::GLU ? g.N / 2 : g.N, 64, 64);
  if (err != cudaSuccess) return err;
  auto kernel = long_gemm_kernel<BM, BN, EPI>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)R::bytes);
  if (err == cudaSuccess && R::LN)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.cn);
  cfg.blockDim = dim3(R::THREADS);
  cfg.dynamicSmemBytes = R::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (R::LN) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cn;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  static int fit[MAX_CLUSTER + 1] = {};  // asked once a cluster size
  if (fit[g.cn] == 0) {
    int n = 0;
    err = resident(reinterpret_cast<const void*>(kernel), cfg, &n);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    fit[g.cn] = n;
  }
  // LN: a cluster a row block at a time; else a CTA a tile
  cfg.gridDim = dim3(std::min(R::LN ? mt : nt * mt, fit[g.cn]) * g.cn);
  void* args[] = {&map_a, &map_w, &map_o, &g};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile by shape: BM = 128 where 128-row tiles give the card a full
// wave, else 64; BN = 256 where N is a multiple of it, else 128, and 128
// for GeGLU and SwiGLU, which run two CTAs an SM
template <int EPI>
cudaError_t launch_bm(const void* a, const void* w, const LongArgs& g,
                      cudaStream_t s) {
  constexpr int BN_WIDE = Ring<128, 128, EPI>::GLU ? 128 : 256;
  const bool wide = g.N % BN_WIDE == 0;
  if ((long long)((g.M + 127) / 128) * (g.N / BN) >= 132)
    return wide ? launch_long<128, BN_WIDE, EPI>(a, w, g, s)
                : launch_long<128, 128, EPI>(a, w, g, s);
  return wide ? launch_long<64, BN_WIDE, EPI>(a, w, g, s)
              : launch_long<64, 128, EPI>(a, w, g, s);
}

// one warp a row: x = LN(E[id])·s in f32 -> x (f32) and a (bf16)
template <int CH>
__global__ void __launch_bounds__(256)
embed_ln_kernel(const long long* __restrict__ ids,
                const float* __restrict__ table, const float* __restrict__ s,
                float* __restrict__ x, bf16* __restrict__ a, int M, int H,
                int V, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  long long id = ids[row];
  if (id < 0 || id >= V) id = 0;  // the wrapper's ids come from a vocab
  const float4* src = reinterpret_cast<const float4*>(table + id * H);
  float4 v[CH];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    v[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if ((c * 32 + lane) * 4 < H) v[c] = src[c * 32 + lane];
    sum += (v[c].x + v[c].y) + (v[c].z + v[c].w);
  }
  const float mean = warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if ((c * 32 + lane) * 4 < H) {
      const float d0 = v[c].x - mean, d1 = v[c].y - mean;
      const float d2 = v[c].z - mean, d3 = v[c].w - mean;
      sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  const float rstd = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * 32 + lane) * 4;
    if (col >= H) continue;
    const float4 sc = *reinterpret_cast<const float4*>(s + col);
    const float4 y = make_float4((v[c].x - mean) * rstd * sc.x,
                                 (v[c].y - mean) * rstd * sc.y,
                                 (v[c].z - mean) * rstd * sc.z,
                                 (v[c].w - mean) * rstd * sc.w);
    *reinterpret_cast<float4*>(x + (size_t)row * H + col) = y;
    store2(a + (size_t)row * H + col, y.x, y.y);
    store2(a + (size_t)row * H + col + 2, y.z, y.w);
  }
}

}  // namespace

extern "C" {

// One projection of a ModernBERT layer (no bias): out = epi(a (M, K) bf16
// · w (K, N) bf16). epi 0 (RoPE): out bf16 (M, N), the column tiles below
// rope_cols rotated with cos / sin (rows of hd / 2 = 32 f32) at position
// row % S; hd must be 64. epi 1 (GeGLU): out bf16 (M, N / 2), w
// interleaved. epi 2 / 3 (residual + LN): out f32 (M, N) h = a·w + resid
// (f32), out2 = LN(h)·ln_s, bf16 (2) or f32 (3); N <= 2048. Needs K % 64
// == 0, N % 128 == 0, 16-byte aligned a and w. Returns a cudaError_t.
int dawn_long_gemm(const void* a, const void* w, int epi, void* out,
                   void* out2, const void* resid, const void* ln_s,
                   const void* cos, const void* sin, int M, int N, int K,
                   int S, int hd, float eps, void* stream) {
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % 64 != 0)
    return (int)cudaErrorInvalidValue;
  LongArgs g = {};
  g.out = out;
  g.out2 = out2;
  g.resid = static_cast<const float*>(resid);
  g.ln_s = static_cast<const float*>(ln_s);
  g.cos = static_cast<const float*>(cos);
  g.sin = static_cast<const float*>(sin);
  g.M = M;
  g.N = N;
  g.K = K;
  g.S = S;
  g.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_ROPE:
      if (hd != 64 || N % 3 != 0 || S <= 0 || M % S != 0 || !cos || !sin)
        return (int)cudaErrorInvalidValue;
      g.rope_cols = 2 * N / 3;
      return (int)launch_bm<EPI_ROPE>(a, w, g, s);
    case EPI_GEGLU:
      return (int)launch_bm<EPI_GEGLU>(a, w, g, s);
    case EPI_LN_BF16:
    case EPI_LN_F32:
      if (!resid || !ln_s || !out2 || N > MAX_CLUSTER * BN)
        return (int)cudaErrorInvalidValue;
      return (int)(epi == EPI_LN_BF16 ? launch_bm<EPI_LN_BF16>(a, w, g, s)
                                      : launch_bm<EPI_LN_F32>(a, w, g, s));
  }
  return (int)cudaErrorInvalidValue;
}

// One projection of a Qwen3 layer (no bias), bf16 a (M, K) · w (K, N):
// epi 4 (QKV + norms + RoPE): out bf16 (M, N) = the q, k and v heads of 128
// (q below q_cols, k below rope_cols), A's rows scaled by r from ssq_in
// (M, rparts), q and k normed with qn / kn and rotated with cos / sin
// ((>= S, 64) f32) at position row % S. epi 5 (SwiGLU): out bf16 (M, N /
// 2), w interleaved, A's rows scaled as for 4. epi 6 (residual + RMS
// parts): out f32 (M, N) h = a·w + resid, out2 bf16 (M, N) = h ⊙ s,
// ssq_out (M, N / BN) the Σh² of each column tile (BN = 256 where N % 256
// == 0, else 128). Needs K % 64 == 0, N % 128 == 0, rparts <= 16,
// 16-byte aligned a and w. Returns a cudaError_t.
int dawn_qwen3_gemm(const void* a, const void* w, int epi, void* out,
                    void* out2, const void* resid, const void* s,
                    const void* cos, const void* sin, const void* ssq_in,
                    void* ssq_out, const void* qn, const void* kn, int rparts,
                    int M, int N, int K, int S, int q_cols, int rope_cols,
                    float eps, void* stream) {
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % 64 != 0)
    return (int)cudaErrorInvalidValue;
  LongArgs g = {};
  g.out = out;
  g.out2 = out2;
  g.resid = static_cast<const float*>(resid);
  g.ln_s = static_cast<const float*>(s);
  g.cos = static_cast<const float*>(cos);
  g.sin = static_cast<const float*>(sin);
  g.ssq_in = static_cast<const float*>(ssq_in);
  g.ssq_out = static_cast<float*>(ssq_out);
  g.qn = static_cast<const float*>(qn);
  g.kn = static_cast<const float*>(kn);
  g.rparts = rparts;
  g.M = M;
  g.N = N;
  g.K = K;
  g.S = S;
  g.q_cols = q_cols;
  g.rope_cols = rope_cols;
  g.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool parts = ssq_in && rparts >= 1 && rparts <= 16;
  switch (epi) {
    case EPI_QKN:
      if (!parts || !cos || !sin || !qn || !kn || S <= 0 || M % S != 0 ||
          q_cols % 128 != 0 || rope_cols % 128 != 0 || q_cols > rope_cols ||
          rope_cols > N)
        return (int)cudaErrorInvalidValue;
      return (int)launch_bm<EPI_QKN>(a, w, g, st);
    case EPI_SWIGLU:
      if (!parts) return (int)cudaErrorInvalidValue;
      return (int)launch_bm<EPI_SWIGLU>(a, w, g, st);
    case EPI_RMS:
      if (!resid || !s || !out2 || !ssq_out) return (int)cudaErrorInvalidValue;
      return (int)launch_bm<EPI_RMS>(a, w, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// x (M, H) f32 = LN(table[ids])·s, a = bf16(x); H % 128 == 0, H <= 2048.
int dawn_long_embed_ln(const void* ids, const void* table, const void* s,
                       void* x, void* a, int M, int H, int V, float eps,
                       void* stream) {
  if (M <= 0 || H <= 0 || H % 128 != 0 || H > 2048 || V <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  embed_ln_kernel<16><<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const long long*>(ids), static_cast<const float*>(table),
      static_cast<const float*>(s), static_cast<float*>(x),
      static_cast<bf16*>(a), M, H, V, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
