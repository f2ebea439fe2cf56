// ModernBERT's projections and its embedding LayerNorm on Hopper (sm_90a),
// bf16 in: the long-context library (ops/_cuda.py::long_lib), built only
// when a ModernBERT model is, so the BERT, MPNet and RoBERTa kernels of
// csrc/*.cu compile exactly as before.
//
// The GEMM is csrc/gemm.cuh's: its TMA + wgmma ring and bf16 mainloop,
// a BM x 128 output tile, W read in its (in, out) layout through the
// transpose bit. Only the epilogues are new, one instance each (no bias:
// ModernBERT has none):
//   EPI_ROPE    qkv = bf16(RoPE(acc)): a tile of q's or k's columns holds
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
//               with common.cuh's erf polynomial.
//   EPI_LN      h = acc + resid (f32, the residual stream), written f32,
//   EPI_LN_F32  and y = LN(h)·s, written bf16 (the next layer's norm, or
//               the MLP's) or f32 (the final norm): gemm.cuh's cluster
//               LayerNorm (N / 128 CTAs meet over DSMEM in rank order,
//               two passes), scale only.
// The embedding: one warp a row gathers E[id] (f32), forms LN·s in f32
// (two passes, warp sums) and writes it as f32 x and bf16 a (ModernBERT's
// first attn_norm is the identity).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../gemm.cuh"

namespace {

constexpr int EPI_ROPE = 0;
constexpr int EPI_GEGLU = 1;
constexpr int EPI_LN_BF16 = 2;
constexpr int EPI_LN_F32 = 3;

struct LongArgs {
  void* out;           // ROPE, GEGLU: bf16; LN: f32 h
  void* out2;          // LN: y (bf16 or f32)
  const float* resid;  // LN: f32 (M, N)
  const float* ln_s;   // LN: (N,)
  const float* cos;    // ROPE: (>= S, hd / 2)
  const float* sin;
  int M, N, K, S, rope_cols;
  float eps;
  int cx;              // CTAs of the LayerNorm cluster
};

template <int BM, int EPI>
__global__ void __launch_bounds__(Tile<BM, bf16>::THREADS)
long_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const LongArgs g) {
  using L = Tile<BM, bf16>;
  constexpr bool LN = EPI == EPI_LN_BF16 || EPI == EPI_LN_F32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::STAGES;
  float* red = reinterpret_cast<float*>(smem + L::red);   // [2][BM]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < L::NC * 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = g.M, N = g.N, K = g.K;
  const int kt = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], L::NC * 4);
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
      for (int t = 0; t < kt; ++t) {
        const int s = t % L::STAGES;
        if (t >= L::STAGES)
          sm90::mbar_wait(&empty[s], ((t / L::STAGES) - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        unsigned char* w = st + L::A_BYTES;
        const int k0 = t * L::BK;
        sm90::mbar_expect_tx(&full[s], L::STAGE);
        sm90::tma_load_2d(st, &map_a, &full[s], k0, m0);
        sm90::tma_load_2d(w, &map_w, &full[s], n0, k0);
        sm90::tma_load_2d(w + L::W_BOX, &map_w, &full[s], n0 + 64, k0);
      }
    }
    __syncwarp();
  } else {
    mainloop_bf16<BM>(acc, smem, full, empty, kt, warp, lane);
  }

  const int rl = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // local row
  const int t2 = (lane % 4) * 2;
  const int c0 = n0 + t2;

  if constexpr (EPI == EPI_ROPE) {
    if (!consumer) return;
    bf16* out = static_cast<bf16*>(g.out);
    const bool rotate = n0 < g.rope_cols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + rl + 8 * h;
      if (r >= M) continue;
      if (rotate) {
        const int pos = r % g.S;
        const float* cs = g.cos + (size_t)pos * 32;
        const float* sn = g.sin + (size_t)pos * 32;
#pragma unroll
        for (int head = 0; head < 2; ++head)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * j + t2 + e;
              const int lo = 4 * (8 * head + j) + 2 * h + e;
              const int hi = lo + 16;  // j + 4
              const float c = cs[d], s = sn[d];
              const float x = acc[lo], y = acc[hi];
              acc[lo] = x * c - y * s;
              acc[hi] = y * c + x * s;
            }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(out + (size_t)r * N + c0 + j * 8, acc[4 * j + 2 * h],
               acc[4 * j + 2 * h + 1]);
    }
    return;
  }

  if constexpr (EPI == EPI_GEGLU) {
    if (!consumer) return;
    bf16* out = static_cast<bf16*>(g.out);
    const int half = N / 2, oc0 = blockIdx.x * 64 + t2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + rl + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        const float y0 = __fmul_rn(gelu_as(acc[i]), acc[i + 32]);
        const float y1 = __fmul_rn(gelu_as(acc[i + 1]), acc[i + 33]);
        store2(out + (size_t)r * half + oc0 + j * 8, y0, y1);
      }
    }
    return;
  }

  if constexpr (LN) {
    // v = acc + resid, written f32; then the cluster LayerNorm of v
    float* hout = static_cast<float*>(g.out);
    const int cx = g.cx;
    float part[2] = {0.0f, 0.0f};
    if (consumer) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + j * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + rl + 8 * h;
          float& v0 = acc[4 * j + 2 * h];
          float& v1 = acc[4 * j + 2 * h + 1];
          if (r < M) {
            const float2 x = load2(g.resid + (size_t)r * N + c);
            v0 = v0 + x.x;
            v1 = v1 + x.y;
            store2(hout + (size_t)r * N + c, v0, v1);
          }
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
      rstd[0] = rsqrtf(tot.x / N + g.eps);
      rstd[1] = rsqrtf(tot.y / N + g.eps);
    }
    __syncwarp();
    sm90::cluster_arrive();
    if (consumer) {
      using O = typename std::conditional<EPI == EPI_LN_F32, float,
                                          bf16>::type;
      O* y = static_cast<O*>(g.out2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + j * 8;
        const float s0 = g.ln_s[c], s1 = g.ln_s[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + rl + 8 * h;
          if (r < M)
            store2(y + (size_t)r * N + c,
                   (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * s0,
                   (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * s1);
        }
      }
    }
    __syncwarp();
    sm90::cluster_wait();
  }
}

template <int BM, int EPI>
cudaError_t launch_long(const void* a, const void* w, LongArgs g,
                        cudaStream_t stream) {
  using L = Tile<BM, bf16>;
  constexpr bool LN = EPI == EPI_LN_BF16 || EPI == EPI_LN_F32;
  CUtensorMap map_a, map_w;
  cudaError_t err = sm90::tensor_map_2d(&map_a, a, 2, g.M, g.K, BM, L::BK);
  if (err == cudaSuccess)
    err = sm90::tensor_map_2d(&map_w, w, 2, g.K, g.N, L::BK, 64);
  if (err != cudaSuccess) return err;
  auto kernel = long_gemm_kernel<BM, EPI>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err == cudaSuccess && LN)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int nt = g.N / BN;
  g.cx = LN ? nt : 1;
  if (g.cx > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, (g.M + BM - 1) / BM);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (g.cx > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cx;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = sm90::cluster_fits(reinterpret_cast<const void*>(kernel), cfg);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&map_a, &map_w, &g};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_bm(const void* a, const void* w, const LongArgs& g,
                      cudaStream_t s) {
  if ((long long)((g.M + 127) / 128) * (g.N / BN) >= 132)
    return launch_long<128, EPI>(a, w, g, s);
  return launch_long<64, EPI>(a, w, g, s);
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
