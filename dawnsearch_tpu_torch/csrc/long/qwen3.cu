// Qwen3's attention, embedding and pool on Hopper (sm_90a), in the
// long-context library beside ModernBERT's kernels, which they leave as
// they are (ops/qwen3.py documents the layer; csrc/long/gemm_long.cu holds
// its projections).
//
// Causal grouped-query attention at head dim 128 (long_causal_gqa_kernel):
//
//   s = (q·kᵀ)·scale over keys j <= i (and j < len)
//   o = bf16( Σ_j bf16(p_j)·v_j / Σ_j p_j ),  p = exp(s − running max)
//
// q, k and v are column blocks of the QKV projection's (B·S, (nh + 2·nkv)
// ·128) output, already normed and rotated by its epilogue; query head h
// reads key/value head h / G, G = nh / nkv. A CTA owns 128 query rows that
// share one key/value head: the G heads of a group at QP = 128 / G
// positions each (row ρ: head ρ / QP, position q0 + ρ % QP), so each K / V
// tile it streams serves all G heads. The design is the global ModernBERT
// kernel's (attention_long.cu) at twice the head dim: a producer warp
// issues TMA loads (Q once as 2·G boxes of QP rows by 64 dims, then
// 128-key K and V tiles as two boxes of 64 dims each) into a two-stage
// ring; two consumer warpgroups of 64 rows compute S = Q·Kᵀ with wgmma
// m64n128k16 over 8 k16 steps across the two 64-dim halves (each its own
// 128-byte-swizzled box) and O += P·V with m64n128k16 (P from registers,
// V's two halves read through the transpose bit, 16 KB apart). The online
// softmax is FlashAttention-2's, in f32 with ex2.
//
// Causality: QP divides 128, so the rows' positions q0 .. q0 + QP − 1 lie
// in one 128-key tile; every key of an earlier tile is below q0 and needs
// no mask, and the CTA walks tiles [0, ceil(min(q0 + QP, len) / 128)).
// Only the last is masked, per row at keys j > min(i, len − 1), and its V
// rows at or past min(q0 + QP, len) are zeroed in shared memory before
// PV (0·NaN is NaN; TMA fills past the tensor with zeros and reads the
// next sequence's rows past S). The key tiles above the diagonal are
// never loaded. CTAs run the longest rows first (blockIdx.x reversed).
// Query rows at or past len are written as zeros; rows past S are the
// next sequence's and are not written.
//
// The embedding (qwen3_embed_kernel): one warp a row gathers E[id] (bf16)
// into the f32 residual stream x and writes a = bf16(x ⊙ w) for layer 0's
// input RMSNorm with Σx² (one part a row), whose row scale the QKV
// epilogue applies.
//
// The pool (qwen3_last_pool_kernel): one CTA a sequence reads the f32 row
// of its last real token, applies the final RMSNorm (w ⊙ x / sqrt(mean(x²)
// + eps)) and L2-normalises it, in f32 (Qwen3-Embedding's last-token
// pooling; the other rows are never normed).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../common.cuh"
#include "../sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;
constexpr int MAX_S = 8192;
constexpr int ROWS = 128;                  // query rows a CTA, 64 a consumer
constexpr int KT = 128;                    // keys a tile
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;           // two consumer warpgroups + producer
constexpr int HALF = 128 * 64 * 2;         // a 128-row box of 64 dims, bytes
constexpr int TILE = 2 * HALF;             // a Q, K or V tile: both halves
constexpr int BARS = 1 + 4 * STAGES;       // q_full, k/v full, k/v empty
constexpr size_t SMEM =
    (size_t)(1 + 2 * STAGES) * TILE + BARS * sizeof(uint64_t) + 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers: mma_bf16_16816's A
// fragment a warp) · B (16 x 128, MN-major in shared memory, through the
// transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q·Kᵀ for one warpgroup: 8 k16 steps, 4 in each 64-dim half
__device__ __forceinline__ void issue_qk(float (&s)[64], const unsigned char* q,
                                         const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * HALF + (kk % 4) * 32;
    sm90::wgmma_m64n128k16_kk(s, sm90::wgmma_desc_kmajor(q + off),
                              sm90::wgmma_desc_kmajor(k + off), kk);
  }
}

// O += P·V: 8 k16 steps over the tile's 128 keys (16 rows, 2 KB, of each
// half), the halves 16 KB apart (the descriptor's leading byte offset)
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32],
                                         const unsigned char* v) {
#pragma unroll
  for (int kc = 0; kc < KT / 16; ++kc) {
    const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2],
                           p[4 * kc + 3]};
    wgmma_m64n128k16_rs_tb(o, a, sm90::wgmma_desc(v + kc * 2048, HALF, 1024));
  }
}

// The online softmax of one 128-key tile held as a wgmma m64n128
// accumulator (s[4n + 2r + e]: row g + 8r, key 8n + 2·t4 + e). With
// `mask`, keys at or past valid[r] become -inf. s then holds p, corr the
// rescale of the row's old context and l, sum the row's Σp of this tile
// (this thread's keys).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&corr)[2], float (&sum)[2],
                                             bool mask, const int (&valid)[2],
                                             int t4, float scale_log2) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + 2 * t4 + (e & 1) >= valid[e / 2]) s[4 * n + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * n + e]);
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // key 0 is in every row's first tile and unmasked (the row's limit
    // min(i, len − 1) >= 0), so the max is finite from tile 0 on
    nm[r] = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = ex2(m[r] - nm[r]);
    m[r] = nm[r];
    sum[r] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * n + e], scale_log2, -nm[e / 2]));
      sum[e / 2] += p;
      s[4 * n + e] = p;
    }
}

__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
}

// grid (ceil(S / QP), nkv, B), THREADS threads: warps 0-7 consume, warp
// 8 issues the loads; setmaxnreg moves the registers to 24 / 240 / 240
__global__ void __launch_bounds__(THREADS, 1)
long_causal_gqa_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_kv,
                       const int* __restrict__ lens, bf16* __restrict__ out,
                       int S, int nh, int nkv, int qp, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + TILE;
  unsigned char* Vs = Ks + STAGES * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = nh / nkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * qp, kvh = blockIdx.y,
            b = blockIdx.z;
  const int H = nh * HD;
  const int len = min(max(lens[b], 0), S);
  bf16* ob = out + (long long)b * S * H;

  if (q0 >= len) {  // padding rows only: zeros
    for (int idx = threadIdx.x; idx < ROWS * HD / 8; idx += THREADS) {
      const int rho = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int i = q0 + rho % qp, head = kvh * group + rho / qp;
      if (i < S)
        *reinterpret_cast<uint4*>(ob + (long long)i * H + head * HD + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int kend = min(q0 + qp, len);  // keys any live row reaches, + 1
  const int nt = (kend + KT - 1) / KT;
  const int row0 = b * S;  // B·S <= 65,535 · 8,192 < 2^31
  const int kcol = H + kvh * HD, vcol = H + nkv * HD + kvh * HD;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // -- producer: Q once (each head of the group, both halves), then K_t
    // and V_t into stage t % STAGES ------------------------------------------
    sm90::setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      sm90::prefetch_tensormap(&map_q);
      sm90::prefetch_tensormap(&map_kv);
      sm90::mbar_expect_tx(q_full, TILE);
      for (int j = 0; j < group; ++j)
        for (int half = 0; half < 2; ++half)
          sm90::tma_load_2d(Qs + half * HALF + j * qp * 128, &map_q, q_full,
                            (kvh * group + j) * HD + half * 64, row0 + q0);
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = ((t / STAGES) - 1) & 1;
        if (t >= STAGES) sm90::mbar_wait(&k_empty[s], ph);
        sm90::mbar_expect_tx(&k_full[s], TILE);
        for (int half = 0; half < 2; ++half)
          sm90::tma_load_2d(Ks + s * TILE + half * HALF, &map_kv, &k_full[s],
                            kcol + half * 64, row0 + t * KT);
        if (t >= STAGES) sm90::mbar_wait(&v_empty[s], ph);
        sm90::mbar_expect_tx(&v_full[s], TILE);
        for (int half = 0; half < 2; ++half)
          sm90::tma_load_2d(Vs + s * TILE + half * HALF, &map_kv, &v_full[s],
                            vcol + half * 64, row0 + t * KT);
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup ---------------------------------
    sm90::setmaxnreg_inc<240>();
    const int wg = warp / 4;
    const int g = lane / 4, t4 = lane % 4;
    const unsigned char* Qw = Qs + wg * 64 * 128;
    float s[64], o[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float corr[2], sum[2];
    // the last tile's keys each row may attend to: j <= min(i, len − 1)
    const int t_last = (nt - 1) * KT;
    int valid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rho = wg * 64 + (warp % 4) * 16 + g + 8 * r;
      valid[r] = min(q0 + rho % qp, len - 1) - t_last + 1;
    }

    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    sm90::wgmma_fence();
    issue_qk(s, Qw, Ks);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
    softmax_tile(s, m, corr, sum, nt == 1, valid, t4, scale_log2);
    l[0] = sum[0];
    l[1] = sum[1];
    pack_p(p, s);

    for (int t = 1; t < nt; ++t) {
      const int st = t % STAGES, sp = (t - 1) % STAGES;
      sm90::mbar_wait(&k_full[st], (t / STAGES) & 1);
      sm90::wgmma_fence();
      issue_qk(s, Qw, Ks + st * TILE);
      sm90::wgmma_commit();
      sm90::mbar_wait(&v_full[sp], ((t - 1) / STAGES) & 1);
      issue_pv(o, p, Vs + sp * TILE);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // QKᵀ of tile t retired; PV of t − 1 runs on
      sm90::fence_regs(s);
      if (lane == 0) sm90::mbar_arrive(&k_empty[st]);
      softmax_tile(s, m, corr, sum, t == nt - 1, valid, t4, scale_log2);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      if (lane == 0) sm90::mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i / 2) % 2];
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
      pack_p(p, s);
    }

    // the last tile's PV, its V rows at or past kend zeroed first
    const int sl = (nt - 1) % STAGES;
    unsigned char* Vl = Vs + sl * TILE;
    sm90::mbar_wait(&v_full[sl], ((nt - 1) / STAGES) & 1);
    const int last_valid = kend - t_last;
    if (last_valid < KT) {
      const int tid = threadIdx.x % 128;
      for (int c = last_valid * 8 + tid; c < KT * 8; c += 128) {
        *reinterpret_cast<uint4*>(Vl + c * 16) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(Vl + HALF + c * 16) = make_uint4(0, 0, 0, 0);
      }
      sm90::fence_proxy_async_shared();
      sm90::named_sync(1 + wg, 128);
    }
    sm90::wgmma_fence();
    issue_pv(o, p, Vl);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);

    // o / l; rows at or past len are zeros, rows at or past S not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.0f / l[r];
      const int rho = wg * 64 + (warp % 4) * 16 + g + 8 * r;
      const int i = q0 + rho % qp, head = kvh * group + rho / qp;
      if (i >= S) continue;
      const bool live = i < len;
      bf16* row = ob + (long long)i * H + head * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(live ? o[4 * n + 2 * r] * inv : 0.0f,
                                  live ? o[4 * n + 2 * r + 1] * inv : 0.0f);
    }
  }
}

// -- embedding and pool -----------------------------------------------------------

// one warp a row: x = E[id] (f32), a = bf16(x ⊙ w), ssq = Σx²; 8 columns a
// lane a step (H % 256 == 0)
__global__ void __launch_bounds__(256)
qwen3_embed_kernel(const long long* __restrict__ ids,
                   const bf16* __restrict__ table, const float* __restrict__ w,
                   float* __restrict__ x, bf16* __restrict__ a,
                   float* __restrict__ ssq, int M, int H, int V) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  long long id = ids[row];
  if (id < 0 || id >= V) id = 0;  // the wrapper's ids come from a vocab
  const bf16* src = table + id * H;
  float sq = 0.0f;
  for (int c = lane * 8; c < H; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float v[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(e[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
    float* xr = x + (size_t)row * H + c;
    *reinterpret_cast<float4*>(xr) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(xr + 4) = make_float4(v[4], v[5], v[6], v[7]);
    const float4 w0 = *reinterpret_cast<const float4*>(w + c);
    const float4 w1 = *reinterpret_cast<const float4*>(w + c + 4);
    uint4 o;
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&o);
    ob[0] = __floats2bfloat162_rn(v[0] * w0.x, v[1] * w0.y);
    ob[1] = __floats2bfloat162_rn(v[2] * w0.z, v[3] * w0.w);
    ob[2] = __floats2bfloat162_rn(v[4] * w1.x, v[5] * w1.y);
    ob[3] = __floats2bfloat162_rn(v[6] * w1.z, v[7] * w1.w);
    *reinterpret_cast<uint4*>(a + (size_t)row * H + c) = o;
#pragma unroll
    for (int k = 0; k < 8; ++k) sq += v[k] * v[k];
  }
  sq = warp_sum(sq);
  if (lane == 0) ssq[row] = sq;
}

// Σ of v over the CTA's 256 threads (every thread gets it)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) t += red[k];
  __syncthreads();
  return t;
}

// one CTA a sequence: out[b] = normalize(RMS(x[b·S + len − 1]) ⊙ w), f32
__global__ void __launch_bounds__(256)
qwen3_last_pool_kernel(const float* __restrict__ x, const int* __restrict__ lens,
                       const float* __restrict__ w, float* __restrict__ out,
                       int S, int H, float eps) {
  __shared__ float red[8];
  const int b = blockIdx.x;
  const int last = min(max(lens[b], 1), S) - 1;
  const float* row = x + ((size_t)b * S + last) * H;
  float sq = 0.0f;
  for (int c = threadIdx.x; c < H; c += 256) sq += row[c] * row[c];
  const float r = rsqrtf(block_sum(sq, red) / H + eps);
  float ny = 0.0f;
  for (int c = threadIdx.x; c < H; c += 256) {
    const float y = row[c] * r * w[c];
    ny += y * y;
  }
  const float inv = 1.0f / fmaxf(sqrtf(block_sum(ny, red)), 1e-12f);
  for (int c = threadIdx.x; c < H; c += 256)
    out[(size_t)b * H + c] = row[c] * r * w[c] * inv;
}

}  // namespace

extern "C" {

// ctx (B·S, nh·128) bf16 from qkv (B·S, (nh + 2·nkv)·128) bf16 and lens (B,)
// int32: causal attention, query head h on key/value head h / (nh / nkv).
// Needs nh / nkv in {1, 2, 4, 8}, S % 16 == 0, S <= 8192, 16-byte aligned
// qkv and out. Returns a cudaError_t.
int dawn_qwen3_attention(const void* qkv, const void* lens, void* out, int B,
                         int S, int nh, int nkv, float scale, void* stream) {
  if (B <= 0 || B > 65535 || nkv <= 0 || nkv > 65535 || nh % nkv != 0 ||
      S <= 0 || S % 16 != 0 || S > MAX_S ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int group = nh / nkv;
  if (group != 1 && group != 2 && group != 4 && group != 8)
    return (int)cudaErrorInvalidValue;
  const int qp = ROWS / group;
  const long long rows = (long long)B * S, cols = (long long)(nh + 2 * nkv) * HD;
  CUtensorMap map_q, map_kv;
  cudaError_t err = sm90::tensor_map_2d(&map_q, qkv, 2, rows, cols, qp, 64);
  if (err == cudaSuccess)
    err = sm90::tensor_map_2d(&map_kv, qkv, 2, rows, cols, KT, 64);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(long_causal_gqa_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + qp - 1) / qp, nkv, B);
  long_causal_gqa_kernel<<<grid, THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      map_q, map_kv, static_cast<const int*>(lens), static_cast<bf16*>(out), S,
      nh, nkv, qp, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// x (M, H) f32 = table[ids] (bf16 table), a = bf16(x ⊙ w), ssq (M,) = Σx²;
// H % 256 == 0.
int dawn_qwen3_embed(const void* ids, const void* table, const void* w,
                     void* x, void* a, void* ssq, int M, int H, int V,
                     void* stream) {
  if (M <= 0 || H <= 0 || H % 256 != 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  qwen3_embed_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ids), static_cast<const bf16*>(table),
      static_cast<const float*>(w), static_cast<float*>(x),
      static_cast<bf16*>(a), static_cast<float*>(ssq), M, H, V);
  return (int)cudaGetLastError();
}

// out (B, H) f32: each sequence's row len − 1 of x (B·S, H) f32, RMS-normed
// with w and L2-normalised.
int dawn_qwen3_last_pool(const void* x, const void* lens, const void* w,
                         void* out, int B, int S, int H, float eps,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  qwen3_last_pool_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lens),
      static_cast<const float*>(w), static_cast<float*>(out), S, H, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
