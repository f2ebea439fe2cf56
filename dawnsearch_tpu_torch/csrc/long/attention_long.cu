// ModernBERT's attention on Hopper (sm_90a), bf16, head dim 64, S up to
// 8,192: global (every key of the sequence) or windowed (keys within
// `window` positions of the query), in the long-context library. Two
// kernels, one for each kind, chosen by `window` alone.
//
//   s = (q·kᵀ)·scale, masked to keys j < len (and |i − j| <= window)
//   o = bf16( Σ_j bf16(p_j)·v_j / Σ_j p_j ),  p = exp(s − running max)
//
// q, k and v are column blocks of the QKV projection's (B·S, 3H) output
// (row stride 3H, head h at column h·64), RoPE already applied by its
// epilogue; len is each sequence's real length (int32). Query rows at or
// past len are written as zeros.
//
// Both run one pass with an online softmax (FlashAttention-2's order;
// csrc/attention.cu walks S <= 512 twice, which at S = 8,192 would cost a
// quarter more FLOPs): each key tile's scores give a new row max m', the
// f32 context and l are rescaled by exp(m − m'), and p = exp(s − m')
// enters l in f32 and PV as bf16. Exponentials are ex2.approx of scores
// scaled by scale·log2(e). A CTA whose first query row is at or past len
// writes zeros and leaves; the masks (j >= len, |i − j| > window) are
// applied only in the tiles that need them.
//
// Global (long_attention_global_kernel): FLOP bound (4·64 FLOPs a query
// and key, at S = 8,192 some 2,000 a byte read), so it is built around
// wgmma, the only way to the tensor cores' full rate. A CTA owns 128
// query rows of one (sequence, head): two consumer warpgroups of 64 rows
// and a producer warpgroup, which gives its registers to the consumers
// (setmaxnreg) and of which one thread issues the loads: Q once, then
// 128-key K and V tiles by TMA from one 2-D tensor map over qkv (boxes of
// 128 rows by one head's 64 columns, 128-byte swizzle) into a ring of two
// stages, each tile completing on a full mbarrier and freed by the
// consumers on an empty one; each K / V tile serves 128 query rows. A
// consumer computes S = Q·Kᵀ (wgmma m64n128k16, both operands K-major in
// shared memory) and O += P·V (m64n64k16 with P as the register A
// operand: the f32 score fragments packed to bf16 in place, which is
// mma.sync's A layout; V through the transpose bit). Tile t's QKᵀ and
// tile t − 1's PV are issued as two groups; the softmax of tile t reads
// its scores once the first retires. At head dim 64 an exponential costs
// as much as the 256 FLOPs of its query and key on the tensor cores, so
// the softmax is as long as the products; the two warpgroups overlap one
// another's (ptxas places the wait for PV ahead of a warpgroup's own
// softmax, and neither a loop that defers that wait nor ping-pong turns
// between the warpgroups ran faster on an H100). The CTA walks key tiles
// [0, ceil(len / 128)); the tile holding key len − 1 masks keys at or past
// len (select, so a NaN there never reaches the row max) and its V rows at
// or past len are zeroed in shared memory before PV (TMA does not
// zero-fill them, and 0·NaN is NaN), so whatever those rows hold —
// padding, the next sequence, TMA's zero fill past the tensor —
// contributes exactly zero. Rows and keys a 128-row box reads past S (S %
// 128 != 0, e.g. 96 or 1,536 in the 1.5× buckets) are the next
// sequence's: masked as keys, not stored as rows. No atomics: each output
// is written once.
//
// Windowed (long_attention_local_kernel): bytes bound (3 key tiles a query
// tile at window 64), so it keeps the light mma.sync design: one CTA owns
// 64 query rows, 16 a warp, on mma.sync m16n8k16 (bf16 in, f32
// accumulate) with fragments read by ldmatrix (.trans for V) from rows
// padded to 72 elements (144 bytes, an odd number of 16 bytes: no bank
// conflicts); Q's fragments stay in registers, the scores and p never
// leave them. K and V tiles of 64 keys stream through a ring of two
// buffers by 16-byte cp.async, tile t + 1 in flight while t computes,
// rows at or past len zero-filled. It walks the tiles meeting [q0 −
// window, min(q0 + 63 + window, len − 1)]: three at window 64, so its cost
// follows the window, not S.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../common.cuh"
#include "../sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;
constexpr int MAX_S = 8192;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [q0, min(q0 + rows, S)) of a head's output as zeros
__device__ __forceinline__ void zero_rows(bf16* ob, int H, int q0, int rows,
                                          int S, int threads) {
  for (int idx = threadIdx.x; idx < rows * HD / 8; idx += threads) {
    const int r = q0 + idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    if (r < S)
      *reinterpret_cast<uint4*>(ob + (long long)r * H + c) =
          make_uint4(0, 0, 0, 0);
  }
}

// -- global: TMA + wgmma, warp-specialised ------------------------------------

constexpr int G_QT = 128;                  // query rows a CTA, 64 a consumer
constexpr int G_KT = 128;                  // keys a tile
constexpr int G_STAGES = 2;
constexpr int G_THREADS = 3 * 128;        // two consumer warpgroups + producer
constexpr int G_TILE = 128 * HD * 2;       // bytes of a Q, K or V box
constexpr int G_BARS = 1 + 4 * G_STAGES;   // q_full, k/v full, k/v empty
constexpr size_t G_SMEM =
    (size_t)(1 + 2 * G_STAGES) * G_TILE + G_BARS * sizeof(uint64_t) + 1024;

// S = Q·Kᵀ for one warpgroup: 4 k16 steps over the head's 64 dims
__device__ __forceinline__ void issue_qk(float (&s)[64], const unsigned char* q,
                                         const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    sm90::wgmma_m64n128k16_kk(s, sm90::wgmma_desc_kmajor(q + kk * 32),
                              sm90::wgmma_desc_kmajor(k + kk * 32), kk);
}

// O += P·V: 8 k16 steps over the tile's 128 keys (16 rows of V, 2 KB, each)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         const unsigned char* v) {
#pragma unroll
  for (int kc = 0; kc < G_KT / 16; ++kc) {
    const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2],
                           p[4 * kc + 3]};
    sm90::wgmma_m64n64k16_rs_tb(o, a, sm90::wgmma_desc(v + kc * 2048, G_TILE,
                                                       1024));
  }
}

// The online softmax of one 128-key tile held as a wgmma m64n128
// accumulator (s[4n + 2r + e]: row g + 8r, key 8n + 2·t4 + e). Keys at or
// past `valid` (the tile's count of keys below len) become -inf when
// `mask`; s then holds p, `corr` the rescale of the row's old context and
// l, `sum` the row's Σp of this tile (this thread's keys).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&corr)[2],
                                             float (&sum)[2], bool mask,
                                             int valid, int t4,
                                             float scale_log2) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < G_KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + 2 * t4 + (e & 1) >= valid) s[4 * n + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < G_KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * n + e]);
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every live row holds key len − 1 in its last tile and key 0 in its
    // first, so its max is finite; exp(-inf − m') = 0 rescales tile 0
    nm[r] = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = ex2(m[r] - nm[r]);
    m[r] = nm[r];
    sum[r] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < G_KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * n + e], scale_log2, -nm[e / 2]));
      sum[e / 2] += p;
      s[4 * n + e] = p;
    }
}

// p (bf16 A fragments of the PV wgmma, 8 k16 steps) from the tile's p
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
}

// grid (ceil(S / 128), nh, B), G_THREADS threads: warps 0-7 the two
// consumer warpgroups, warps 8-11 the producer's, of which warp 8 issues
// the loads. The entry gets 168 registers a thread (65,536 / 384), and
// setmaxnreg moves them to 24 / 240 / 240 (the same 64,512)
__global__ void __launch_bounds__(G_THREADS, 1)
long_attention_global_kernel(const __grid_constant__ CUtensorMap map,
                             const int* __restrict__ lens,
                             bf16* __restrict__ out, int S, int nh,
                             float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + G_TILE;
  unsigned char* Vs = Ks + G_STAGES * G_TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + G_STAGES * G_TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + G_STAGES;
  uint64_t* k_empty = v_full + G_STAGES;
  uint64_t* v_empty = k_empty + G_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * G_QT, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * HD;
  const int len = min(max(lens[b], 0), S);
  bf16* ob = out + (long long)b * S * H + h * HD;

  if (q0 >= len) {  // padding rows only: zeros
    zero_rows(ob, H, q0, G_QT, S, G_THREADS);
    return;
  }
  const int nt = (len + G_KT - 1) / G_KT;
  const int row0 = b * S;  // B·S <= 65,535 · 8,192 < 2^31

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // -- producer: Q once, then K_t and V_t into stage t % G_STAGES ----------
    sm90::setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      sm90::prefetch_tensormap(&map);
      sm90::mbar_expect_tx(q_full, G_TILE);
      sm90::tma_load_2d(Qs, &map, q_full, h * HD, row0 + q0);
      for (int t = 0; t < nt; ++t) {
        const int s = t % G_STAGES;
        const uint32_t ph = ((t / G_STAGES) - 1) & 1;
        if (t >= G_STAGES) sm90::mbar_wait(&k_empty[s], ph);
        sm90::mbar_expect_tx(&k_full[s], G_TILE);
        sm90::tma_load_2d(Ks + s * G_TILE, &map, &k_full[s], H + h * HD,
                          row0 + t * G_KT);
        if (t >= G_STAGES) sm90::mbar_wait(&v_empty[s], ph);
        sm90::mbar_expect_tx(&v_full[s], G_TILE);
        sm90::tma_load_2d(Vs + s * G_TILE, &map, &v_full[s], 2 * H + h * HD,
                          row0 + t * G_KT);
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup ---------------------------------
    sm90::setmaxnreg_inc<240>();
    const int wg = warp / 4;
    const int g = lane / 4, t4 = lane % 4;
    const unsigned char* Qw = Qs + wg * 64 * 128;
    float s[64], o[32];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float corr[2], sum[2];
    const int last_valid = len - (nt - 1) * G_KT;  // keys of the last tile
    const bool ragged = last_valid < G_KT;

    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    sm90::wgmma_fence();
    issue_qk(s, Qw, Ks);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
    softmax_tile(s, m, corr, sum, nt == 1 && ragged, last_valid, t4,
                 scale_log2);
    l[0] = sum[0];
    l[1] = sum[1];
    pack_p(p, s);

    for (int t = 1; t < nt; ++t) {
      const int st = t % G_STAGES, sp = (t - 1) % G_STAGES;
      sm90::mbar_wait(&k_full[st], (t / G_STAGES) & 1);
      sm90::wgmma_fence();
      issue_qk(s, Qw, Ks + st * G_TILE);
      sm90::wgmma_commit();
      sm90::mbar_wait(&v_full[sp], ((t - 1) / G_STAGES) & 1);
      issue_pv(o, p, Vs + sp * G_TILE);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // QKᵀ of tile t retired; PV of t − 1 runs on
      sm90::fence_regs(s);
      if (lane == 0) sm90::mbar_arrive(&k_empty[st]);
      softmax_tile(s, m, corr, sum, t == nt - 1 && ragged, last_valid, t4,
                   scale_log2);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      if (lane == 0) sm90::mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i / 2) % 2];
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
      pack_p(p, s);
    }

    // the last tile's PV, its V rows at or past len zeroed first
    const int sl = (nt - 1) % G_STAGES;
    unsigned char* Vl = Vs + sl * G_TILE;
    sm90::mbar_wait(&v_full[sl], ((nt - 1) / G_STAGES) & 1);
    if (ragged) {
      const int tid = threadIdx.x % 128;
      for (int c = last_valid * 8 + tid; c < G_KT * 8; c += 128)
        *reinterpret_cast<uint4*>(Vl + c * 16) = make_uint4(0, 0, 0, 0);
      sm90::fence_proxy_async_shared();
      sm90::named_sync(1 + wg, 128);
    }
    sm90::wgmma_fence();
    issue_pv(o, p, Vl);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);

    // o / l; rows at or past len are zeros, rows at or past S are the next
    // sequence's and are not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.0f / l[r];
      const int i = q0 + wg * 64 + (warp % 4) * 16 + g + 8 * r;
      if (i >= S) continue;
      const bool live = i < len;
      bf16* row = ob + (long long)i * H;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(live ? o[4 * n + 2 * r] * inv : 0.0f,
                                  live ? o[4 * n + 2 * r + 1] * inv : 0.0f);
    }
  }
}

// -- windowed: cp.async + mma.sync --------------------------------------------

constexpr int QT = 64;          // query rows a CTA, 16 a warp
constexpr int KT = 64;          // keys a tile
constexpr int THREADS = 128;
constexpr int LD = HD + 8;      // shared row pitch, elements
constexpr int TILE = KT * LD;   // elements of a K or V tile
constexpr size_t SMEM = (size_t)(QT * LD + 4 * TILE) * sizeof(bf16);

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

// grid (ceil(S / QT), nh, B); window >= 0
__global__ void __launch_bounds__(THREADS)
long_attention_local_kernel(const bf16* __restrict__ qkv,
                            const int* __restrict__ lens,
                            bf16* __restrict__ out, int S, int nh, int window,
                            float scale_log2) {
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
    zero_rows(ob, H, q0, QT, S, THREADS);
    return;
  }
  const int kt0 = max(0, q0 - window) / KT;
  const int kt1 = (min(q0 + QT - 1 + window, len - 1)) / KT + 1;

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
    const bool whole = k0 + KT <= len && k0 >= i0 + 15 - window &&
                       k0 + KT - 1 <= i0 + window;
    const bool skip = k0 > i0 + 15 + window || k0 + KT - 1 < i0 - window;
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
            if (j >= len || abs(i - j) > window) v = -INFINITY;
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
// global attention for window < 0 (long_attention_global_kernel), else
// keys within `window` positions (long_attention_local_kernel); scale
// multiplies q·kᵀ. Needs hd = 64, S % 16 == 0, S <= 8192, 16-byte aligned
// qkv and out. Returns a cudaError_t.
int dawn_long_attention(const void* qkv, const void* lens, void* out, int B,
                        int S, int nh, int hd, int window, float scale,
                        void* stream) {
  if (B <= 0 || B > 65535 || nh <= 0 || nh > 65535 || hd != HD || S <= 0 ||
      S % 16 != 0 || S > MAX_S ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int H = nh * HD;
  cudaError_t err;
  if (window < 0) {
    CUtensorMap map;
    err = sm90::tensor_map_2d(&map, qkv, 2, (long long)B * S, 3LL * H, G_KT,
                              HD);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(long_attention_global_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)G_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((S + G_QT - 1) / G_QT, nh, B);
    long_attention_global_kernel<<<grid, G_THREADS, G_SMEM, s>>>(
        map, static_cast<const int*>(lens), static_cast<bf16*>(out), S, nh,
        scale_log2);
  } else {
    err = cudaFuncSetAttribute(long_attention_local_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((S + QT - 1) / QT, nh, B);
    long_attention_local_kernel<<<grid, THREADS, SMEM, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const int*>(lens),
        static_cast<bf16*>(out), S, nh, window, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
