// K3: backward of the batched cascade scorer (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_score_batched_bwd` /
// `_batched_bwd_kernel` (src/repro/kernels/cascade_score/kernel.py:262-338).
// With lp[b, g, j] = sum_{k <= j} log sigmoid(logit[b, g, k]) and the
// cotangent g (B, G, T):
//
//   gc[k]      = sum_{j >= k} g[j]          (as total - cumsum + g)
//   g_logit[k] = gc[k] * sigmoid(-logit[k])
//   dx  (B, G, d) = g_logit . w_eff          per item
//   dw  (T, d)    = sum_{b, g} g_logit^T x   over the whole grid
//   dzq (B, T)    = sum_g g_logit            per group
//
// f32 in, f32 out, f32 accumulation; T <= 8, any d whose tile fits in
// shared memory.
//
// What bounds it on this card: bytes. Per item it reads d + T floats and
// writes d floats and does ~6*d*T flops (d = 24, T = 3: ~2.3 flops per
// byte), far below the ~20 flops/byte where f32 compute would take over.
//
// Design:
//   * one block per query group, walking the group in tiles of kRows items
//     (one thread per item): the x tile is read coalesced into shared
//     memory (row stride d + 1), the logits are recomputed from it (no
//     residual of the forward), and each item thread leaves its g_logit
//     row in shared memory;
//   * dw and dzq are sums, taken without atomics so the result is the same
//     bits on every run: one thread per (stage, feature) pair — and per
//     stage for dzq, as a column of ones — adds the tile's items in item
//     order into its own accumulator; the group's dzq is final when the
//     block ends, the group's dw is a partial that the block writes to
//     scratch, and `ordered_sum_kernel` (ordered_sum.cuh) adds the groups'
//     partials in group order;
//   * the dx row is formed in the x tile's slot and stored coalesced.
// Padded items carry a zero cotangent and add nothing.

#include <cuda_runtime.h>

#include "ordered_sum.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;  // items per tile, one thread each

__global__ void __launch_bounds__(kRows)
cascade_score_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ zq,
                         const float* __restrict__ gct,
                         float* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ dzq,
                         int n_groups, int g, int d, int t) {
  extern __shared__ float smem[];
  const int n_acc = t * (d + 1);      // dw (t, d) and dzq (t) as column d
  float* sw = smem;                   // (t, d) stage weights
  float* sx = sw + t * d;             // (kRows, d + 1) item tile, then dx
  float* sg = sx + kRows * (d + 1);   // (kRows, t) cotangent, then g_logit
  float* acc = sg + kRows * t;        // (t, d + 1) the group's sums

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  float zb[kMaxStages];
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) zb[j] = j < t ? zq[b * t + j] : 0.0f;

  const long long base = (long long)b * g;
  for (int r0 = 0; r0 < g; r0 += kRows) {
    const int rows = min(kRows, g - r0);
    const float* xb = x + (base + r0) * d;
    const float* gb = gct + (base + r0) * t;
    __syncthreads();                  // the previous tile is fully used
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d;
      sx[r * (d + 1) + (i - r * d)] = xb[i];
    }
    for (int i = threadIdx.x; i < rows * t; i += blockDim.x) sg[i] = gb[i];
    __syncthreads();

    const int r = threadIdx.x;
    if (r < rows) {
      const float* xr = sx + r * (d + 1);
      float z[kMaxStages];
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) z[j] = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float xv = xr[k];
#pragma unroll
        for (int j = 0; j < kMaxStages; ++j)
          if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
      }
      float total = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j)
        if (j < t) total += sg[r * t + j];
      float cum = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        if (j < t) {
          const float gj = sg[r * t + j];
          cum += gj;
          const float gc = total - cum + gj;
          sg[r * t + j] = gc / (1.0f + expf(z[j] + zb[j]));  // * sigma(-logit)
        }
      }
    }
    __syncthreads();

    // The tile's share of dw / dzq, in item order.
    for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
      const int s = j / (d + 1);
      const int k = j - s * (d + 1);
      float a = acc[j];
      if (k < d) {
        for (int i = 0; i < rows; ++i)
          a = fmaf(sg[i * t + s], sx[i * (d + 1) + k], a);
      } else {
        for (int i = 0; i < rows; ++i) a += sg[i * t + s];
      }
      acc[j] = a;
    }
    __syncthreads();                  // sx is read; overwrite it with dx

    if (r < rows) {
      float* row = sx + r * (d + 1);
      for (int k = 0; k < d; ++k) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxStages; ++j)
          if (j < t) v = fmaf(sg[r * t + j], sw[j * d + k], v);
        row[k] = v;
      }
    }
    __syncthreads();
    float* ob = dx + (base + r0) * d;
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int rr = i / d;
      ob[i] = sx[rr * (d + 1) + (i - rr * d)];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
    const int s = j / (d + 1);
    const int k = j - s * (d + 1);
    if (k < d)
      dw_part[(long long)(s * d + k) * n_groups + b] = acc[j];
    else
      dzq[b * t + s] = acc[j];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t cascade_score_bwd_smem(int d, int t) {
  return sizeof(float) * ((size_t)t * d + (size_t)kRows * (d + 1) +
                          (size_t)kRows * t + (size_t)t * (d + 1));
}

// dw_part is scratch of t * d * b floats. Returns cudaGetLastError() after
// both launches (0 = launched).
int cascade_score_batched_bwd(const float* x, const float* w,
                              const float* zq, const float* gct, float* dx,
                              float* dw, float* dzq, float* dw_part, int b,
                              int g, int d, int t, void* stream) {
  const size_t smem = cascade_score_bwd_smem(d, t);
  cudaError_t e = allow_smem(cascade_score_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  cascade_score_bwd_kernel<<<b, kRows, smem, s>>>(x, w, zq, gct, dx,
                                                  dw_part, dzq, b, g, d, t);
  launch_ordered_sum(dw_part, dw, t * d, b, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
