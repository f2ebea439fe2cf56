// K8: masked mean-pool + L2 normalize on Hopper (sm_90a), f32 in / out.
//
// Replaces the TPU kernel dawnsearch_tpu/ops/attention.py::fused_mean_pool
// (body _pool_kernel, pallas_call at :241). Same contract
// (attention.py:219-230):
//
//   pooled = Σ_s h[s]·w[s] / max(Σ_s w[s], 1)     w = the (B, S) mask
//            (include_padding: Σ_s h[s] / S, the plain mean)
//   out    = pooled / max(sqrt(Σ pooled²), 1e-12)
//
// Design. One CTA of 1024 threads per sequence: 128 column lanes times 8
// row partitions. Each thread sums its columns over the rows s = p, p + 8,
// ... of its partition in f32 (a warp reads 32 neighbouring columns of a
// row: one 128-byte load), the partitions' partial sums meet in shared
// memory, and one block reduction gives the norm. Nothing but the (B, H)
// result is written. Splitting S eight ways keeps each thread's chain of
// dependent adds at S/8 (64 at S = 512) with 1024 threads in flight per
// sequence, which is what lets a batch of 8 move its bytes.
//
// What bounds it. It reads the (B, S, H) f32 hidden states once and does
// two flops per 4-byte value read, so HBM bounds it: 12.6 MB at B = 64,
// S = 128, H = 384 is 3.8 µs at 3.35 TB/s. With one CTA per sequence a
// batch of 8 fills 8 of 132 SMs, so at small B it is bound by the latency
// of those SMs' loads, not by HBM; it is one launch per encode either way.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int COLS = 128;                 // column lanes
constexpr int PARTS = THREADS / COLS;     // row partitions
constexpr int MAX_H = 1024;               // 32 KB of partial sums

__global__ void __launch_bounds__(THREADS)
pool_kernel(const float* __restrict__ hidden, const float* __restrict__ mask,
            float* __restrict__ out, int S, int H, int include_padding) {
  __shared__ float part[PARTS * MAX_H];   // partial sums; row 0 then pooled
  __shared__ float cnt[PARTS];
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int col = tid % COLS, p = tid / COLS;
  const float* hb = hidden + (size_t)b * S * H;
  const float* mb = include_padding ? nullptr : mask + (size_t)b * S;

  for (int c = col; c < H; c += COLS) {
    float acc = 0.0f;
    if (include_padding) {
#pragma unroll 4
      for (int s = p; s < S; s += PARTS) acc += hb[(size_t)s * H + c];
    } else {
#pragma unroll 4
      for (int s = p; s < S; s += PARTS)
        acc = __fadd_rn(acc, __fmul_rn(hb[(size_t)s * H + c], mb[s]));
    }
    part[p * H + c] = acc;
  }
  if (col == 0 && !include_padding) {
    float n = 0.0f;
    for (int s = p; s < S; s += PARTS) n += mb[s];
    cnt[p] = n;
  }
  __syncthreads();

  float count = (float)S;
  if (!include_padding) {
    count = 0.0f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) count += cnt[q];
    count = fmaxf(count, 1.0f);
  }
  float sq = 0.0f;
  for (int c = tid; c < H; c += THREADS) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) acc += part[q * H + c];
    const float pv = acc / count;
    part[c] = pv;                         // column c is this thread's alone
    sq += pv * pv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (tid % 32 == 0) red[tid / 32] = sq;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  const float denom = fmaxf(sqrtf(total), 1e-12f);
  for (int c = tid; c < H; c += THREADS)
    out[(size_t)b * H + c] = part[c] / denom;
}

}  // namespace

extern "C" {

// hidden (B, S, H) f32, mask (B, S) f32 (unused, may be null, when
// include_padding) -> out (B, H) f32 unit rows; H <= 1024. Returns a
// cudaError_t.
int dawn_mean_pool(const void* hidden, const void* mask, void* out, int B,
                   int S, int H, int include_padding, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > MAX_H ||
      (!include_padding && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  pool_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(mask),
      static_cast<float*>(out), S, H, include_padding);
  return (int)cudaGetLastError();
}

}  // extern "C"
