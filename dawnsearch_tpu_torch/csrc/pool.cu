// K8: masked mean-pool + L2 normalize on Hopper (sm_90a); bf16 or f32
// hidden states, a bool / int32 / int64 / f32 mask, f32 out.
//
// Replaces the TPU kernel dawnsearch_tpu/ops/attention.py::fused_mean_pool
// (body _pool_kernel, pallas_call at :241). Same contract
// (attention.py:219-230):
//
//   pooled = Σ_s h[s]·w[s] / max(Σ_s w[s], 1)     w = the (B, S) mask
//            (include_padding: Σ_s h[s] / S, the plain mean)
//   out    = pooled / max(sqrt(Σ pooled²), 1e-12)
//
// Like the reference, the kernel reads the hidden states in their own
// dtype and the mask in its own, and turns each value into f32 where it
// reads it (a bf16 -> f32 conversion is exact), so the encoder hands it
// its last hidden state without a cast launch and the mask without one.
//
// Design. Each sequence's (S, H) block is split over a thread-block
// cluster of cc·r CTAs: cc column chunks of `lanes`·8 columns times r row
// ranges, planned on the host by ops/attention.py::plan_pool (a small
// batch spreads over clusters of up to 8 CTAs of at least 32 rows: B = 8
// works on 32 SMs at S = 128 and on 64 at S = 512; from B = 34 on
// MiniLM's width a sequence takes one CTA; only H > 32,768 needs more
// chunks, up to a non-portable 16). Inside a
// CTA a thread owns 8 neighbouring columns (one 16-byte load a row in
// bf16, two in f32, where H % 8 == 0 and the rows are 16-byte aligned;
// scalar loads otherwise) and the rows p, p + P, ... of the CTA's range,
// summing each column and the rows' weights in f32 in row order, 8 rows'
// loads in flight. The P row partials meet in shared memory in order of
// p. After one cluster barrier every CTA reads, over distributed shared
// memory, the r range partials of every column in rank order, pools the
// whole row and sums its squares in one fixed tree (shuffle butterflies),
// so all divide by the same norm without a second exchange, and writes
// its share of its chunk's columns. A plan of one CTA a sequence runs an
// instance of its own with no cluster: every warp sums the rows' weights
// itself, and the thread that pools a column writes it, so it takes one
// block barrier after the loads and one for the norm. One launch, no scratch buffer, no
// atomics: the same inputs and plan give the same bits, and the order of
// every sum depends on the plan alone, never on the dtype or the load
// path, so K8(h_bf16) is bit-equal to K8(f32(h_bf16)).
//
// What bounds it. It reads the hidden states once and does two flops per
// value, so HBM bounds it: 6.3 MB of bf16 at B = 64, S = 128, H = 384 is
// 1.9 µs at 3.35 TB/s. At the encoder's batches latency sets the time
// instead: the launch, one round of loads, the cluster barrier and the
// DSMEM reads after it.
//
// Limits: lanes <= 512 (a CTA of at most 512 threads) and cc <= 16, so
// H <= 16 · 512 · 8 = 65,536; any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int VEC = 8;             // columns a thread owns
constexpr int MAX_THREADS = 512;   // lanes · P
constexpr int MAX_CLUSTER = 16;    // CTAs of a sequence (non-portable)
constexpr int UNROLL = 8;          // rows' loads in flight a thread

struct PoolArgs {
  const void* hidden;              // (B, S, H), T
  const void* mask;                // (B, S) with strides msb, mss; null: pad
  float* out;                      // (B, H)
  long long msb, mss;
  int S, H;
  int cc, r, lanes, P;             // the plan
  int vec;                         // 16-byte loads (H % 8 == 0, aligned)
};

// 8 columns [c, c + 8) of one row as loaded (columns past H read 0), and
// column k of them as f32: bf16 keeps its 16 bytes packed until the add
template <typename T>
struct Cols;

template <>
struct Cols<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int c, int H,
                                       bool vec) {
    if (vec) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = c + 2 * k < H ? __ldg(p + c + 2 * k) : 0u;
        const uint32_t hi = c + 2 * k + 1 < H ? __ldg(p + c + 2 * k + 1) : 0u;
        w[k] = lo | hi << 16;
      }
    }
  }
  __device__ __forceinline__ float get(int k) const {
    return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
  }
};

template <>
struct Cols<float> {
  float v[VEC];
  __device__ __forceinline__ void load(const float* row, int c, int H,
                                       bool vec) {
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + c + 4));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = c + k < H ? __ldg(row + c + k) : 0.0f;
    }
  }
  __device__ __forceinline__ float get(int k) const { return v[k]; }
};

template <typename M>
__device__ __forceinline__ float weight(const M* m, long long off) {
  return (float)__ldg(m + off);
}
template <>
__device__ __forceinline__ float weight<bool>(const bool* m, long long off) {
  return (float)__ldg(reinterpret_cast<const unsigned char*>(m) + off);
}

// Σ of v over the warp by an xor butterfly: a fixed tree, and every lane
// ends with the same bits (each step adds the same two values, in either
// order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid B · cc · r CTAs of lanes · P threads (rounded up to whole warps),
// clusters of cc · r: CTA rank q = c · r + j takes column chunk c and row
// range j of sequence blockIdx.x / (cc · r). SOLO: cc = r = 1, no cluster.
// Dynamic shared memory: (lanes · P + lanes) · 8 floats.
template <typename T, typename M, bool SOLO>
__global__ void __launch_bounds__(MAX_THREADS)
pool_kernel(const PoolArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = SOLO ? 1 : a.cc * a.r;
  const int q = SOLO ? 0 : blockIdx.x % n;
  const int b = SOLO ? blockIdx.x : blockIdx.x / n;
  const int c = SOLO ? 0 : q / a.r, j = SOLO ? 0 : q % a.r;
  const int W = a.lanes * VEC;               // a chunk's columns
  float* red = smem;                         // (P, W) row partials; pooled
  float* part = smem + a.P * W;              // (W) this CTA's partials
  __shared__ float cnt_p[MAX_THREADS], warp_sq[32], cnt_cta;
  const int tid = threadIdx.x, lane = tid % a.lanes, p = tid / a.lanes;
  const int nt = blockDim.x;
  const int c0 = c * W;                      // first column of the chunk
  const int col = c0 + lane * VEC;
  // ranges of per or per + 1 rows
  const int per = SOLO ? a.S : a.S / a.r, extra = SOLO ? 0 : a.S % a.r;
  const int s0 = j * per + min(j, extra), s1 = s0 + per + (j < extra);
  const T* hb = static_cast<const T*>(a.hidden) + (size_t)b * a.S * a.H;
  const M* mb = static_cast<const M*>(a.mask);
  const long long moff = (long long)b * a.msb;
  const bool vec = a.vec != 0;

  // 1. this thread's 8 columns over rows p, p + P, ... of [s0, s1), in
  // row order; UNROLL rows' loads are issued before any is added. Every
  // thread of row lane p also sums its rows' weights.
  float acc[VEC] = {}, cnt = 0.0f;
  if (p < a.P) {
    const bool live = col < a.H;
    for (int s = s0 + p; s < s1; s += UNROLL * a.P) {
      Cols<T> v[UNROLL];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int su = s + u * a.P;
        w[u] = su < s1 ? (mb ? weight<M>(mb, moff + su * a.mss) : 1.0f)
                       : 0.0f;
        if (live && su < s1) v[u].load(hb + (size_t)su * a.H, col, a.H, vec);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (s + u * a.P < s1) {
          cnt = __fadd_rn(cnt, w[u]);
          if (live)
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[k] = __fadd_rn(acc[k], __fmul_rn(v[u].get(k), w[u]));
        }
    }
    float4* to = reinterpret_cast<float4*>(red + p * W + lane * VEC);
    to[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    to[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (lane == 0) cnt_p[p] = cnt;
  }
  __syncthreads();
  const int lane32 = tid % 32;
  if constexpr (SOLO) {
    // 2'. the sequence's rows' weight, in every warp in the same order,
    // then each column over its P row lanes in order, pooled; the thread
    // that pools a column also writes it, so one barrier is enough
    float t = 0.0f;
    for (int pp = lane32; pp < a.P; pp += 32) t = __fadd_rn(t, cnt_p[pp]);
    const float count = mb ? fmaxf(warp_sum(t), 1.0f) : (float)a.S;
    float sq = 0.0f;
    for (int i = tid; i < a.H; i += nt) {
      float u = 0.0f;
#pragma unroll 8
      for (int pp = 0; pp < a.P; ++pp) u = __fadd_rn(u, red[pp * W + i]);
      const float pv = __fdiv_rn(u, count);
      sq = __fadd_rn(sq, __fmul_rn(pv, pv));
      part[i] = pv;
    }
    sq = warp_sum(sq);
    if (lane32 == 0) warp_sq[tid / 32] = sq;
    __syncthreads();
    const float total = warp_sum(lane32 < nt / 32 ? warp_sq[lane32] : 0.0f);
    const float denom = fmaxf(__fsqrt_rn(total), 1e-12f);
    float* ob = a.out + (size_t)b * a.H;
    for (int i = tid; i < a.H; i += nt) ob[i] = __fdiv_rn(part[i], denom);
    return;
  }
  // 2. the CTA's partial of each column and its rows' weight, each over
  // its P row lanes in order
  for (int i = tid; i < W; i += nt) {
    float t = 0.0f;
#pragma unroll 8
    for (int pp = 0; pp < a.P; ++pp) t = __fadd_rn(t, red[pp * W + i]);
    part[i] = t;
  }
  if (tid < 32) {
    float t = 0.0f;
    for (int pp = tid; pp < a.P; pp += 32) t = __fadd_rn(t, cnt_p[pp]);
    t = warp_sum(t);
    if (tid == 0) cnt_cta = t;
  }
  sm90::cluster_sync();

  // 3. every CTA pools every column of the sequence, the same way: the
  // count from chunk 0's r ranges, each column's r range partials in rank
  // order (their loads issued together), and the sum of squares over the
  // thread's columns, then its warp, then the warps. The CTA keeps its
  // own columns: li % r == j of chunk c.
  const float count =
      mb ? fmaxf(warp_sum(lane32 < a.r ? sm90::ld_dsmem(&cnt_cta, lane32)
                                       : 0.0f), 1.0f)
         : (float)a.S;
  float sq = 0.0f;
  for (int i = tid; i < a.H; i += nt) {
    const int ci = i / W, li = i - ci * W;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int jj = 0; jj < MAX_CLUSTER; ++jj)
      if (jj < a.r) v[jj] = sm90::ld_dsmem(part + li, ci * a.r + jj);
    float t = 0.0f;
#pragma unroll
    for (int jj = 0; jj < MAX_CLUSTER; ++jj)
      if (jj < a.r) t = __fadd_rn(t, v[jj]);
    const float pv = __fdiv_rn(t, count);
    sq = __fadd_rn(sq, __fmul_rn(pv, pv));
    if (ci == c && li % a.r == j) red[li] = pv;
  }
  sm90::cluster_arrive();                    // done reading the peers
  sq = warp_sum(sq);
  if (lane32 == 0) warp_sq[tid / 32] = sq;
  __syncthreads();
  const float total = warp_sum(lane32 < nt / 32 ? warp_sq[lane32] : 0.0f);
  const float denom = fmaxf(__fsqrt_rn(total), 1e-12f);

  // 4. this CTA's columns of the unit row
  float* ob = a.out + (size_t)b * a.H + c0;
  const int valid = min(W, a.H - c0);
  for (int li = j + a.r * tid; li < valid; li += a.r * nt)
    ob[li] = __fdiv_rn(red[li], denom);
  sm90::cluster_wait();                      // no CTA leaves while read
}

template <typename T, typename M>
int launch(PoolArgs a, int B, cudaStream_t stream) {
  const int n = a.cc * a.r;
  const void* kernel =
      n == 1 ? reinterpret_cast<const void*>(pool_kernel<T, M, true>)
             : reinterpret_cast<const void*>(pool_kernel<T, M, false>);
  cudaError_t err = cudaSuccess;
  if (n > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  // whole warps (the reductions shuffle over all 32 lanes); the threads
  // past lanes · P only join the reductions. A plan of one CTA a sequence
  // launches the SOLO instance, with no cluster.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * n));
  cfg.blockDim = dim3((a.lanes * a.P + 31) / 32 * 32);
  cfg.dynamicSmemBytes = (size_t)(a.lanes * a.P + a.lanes) * VEC * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (n > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = sm90::cluster_fits(kernel, cfg);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mask(int mask_type, const PoolArgs& a, int B, cudaStream_t s) {
  switch (mask_type) {
    case 0: return launch<T, bool>(a, B, s);
    case 1: return launch<T, int32_t>(a, B, s);
    case 2: return launch<T, long long>(a, B, s);
    case 3: return launch<T, float>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// hidden (B, S, H) contiguous, bf16 (hidden_f32 = 0) or f32; mask (B, S)
// with element strides (msb, mss), of mask_type 0 bool, 1 int32, 2 int64,
// 3 f32 (unused, may be null, when include_padding) -> out (B, H) f32 unit
// rows. The plan (cc column chunks of lanes · 8 columns, r row ranges, P
// row lanes a CTA) is ops/attention.py::plan_pool's: cc · lanes · 8 >= H,
// cc · r <= 16, r <= S, lanes · P <= 512. Returns a cudaError_t: a cluster
// the card refuses is an error, never a smaller one.
int dawn_mean_pool(const void* hidden, const void* mask, void* out, int B,
                   int S, int H, int hidden_f32, int mask_type,
                   long long msb, long long mss, int include_padding, int cc,
                   int r, int lanes, int P, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || cc < 1 || r < 1 || r > S ||
      cc * r > MAX_CLUSTER || lanes < 1 || P < 1 ||
      lanes * P > MAX_THREADS || (long long)cc * lanes * VEC < H ||
      (long long)(cc - 1) * lanes * VEC >= H ||
      (!include_padding && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  PoolArgs a;
  a.hidden = hidden;
  a.mask = include_padding ? nullptr : mask;
  a.out = static_cast<float*>(out);
  a.msb = msb;
  a.mss = mss;
  a.S = S;
  a.H = H;
  a.cc = cc;
  a.r = r;
  a.lanes = lanes;
  a.P = P;
  a.vec = H % VEC == 0 && reinterpret_cast<uintptr_t>(hidden) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hidden_f32 ? launch_mask<float>(mask_type, a, B, st)
                    : launch_mask<__nv_bfloat16>(mask_type, a, B, st);
}

}  // extern "C"
