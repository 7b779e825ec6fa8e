// K4 and K5: the fused L3 training-step reductions and their backward, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `cascade_loss` / `_loss_kernel` and
// `cascade_loss_bwd` / `_loss_bwd_kernel`
// (src/repro/kernels/cascade_loss/kernel.py:138-315).
//
// Input: the packed items xc (B, G, d + 4) = [x | y | mask | wgt | cost_w],
// w_eff (T, d), zq (B, T). With lp the cumulative log pass-probabilities of
// the items (K1's function) and lpc = min(lp[T-1], -1e-7):
//
// K4  ll[b]        = sum_g wgt*mask * (y*lpc + (1-y)*log1p(-exp(lpc)))
//     cost_pp[t]   = sum_{b,g} cost_w * exp(lp[t])      (over the whole grid)
//     cnt_pp[b, t] = sum_g mask * exp(lp[t])
//
// K5  from the cotangents g_ll (B,), g_cost (T,), g_cnt (B, T), two
//     logit-gradient streams per item, each reverse-cumulated over stages
//     and multiplied by sigmoid(-logit):
//       main = NLL (stage T-1 only, gated by lp[T-1] <= -1e-7, ties
//              included) + cost  -> dw_eff (whole grid) and dzq (per group)
//       pen  = counts            -> dzq_pen (per group) only
//     dxc = (main + pen) . w_eff on the feature lanes, exactly 0 on the four
//     data lanes (the batch data is not differentiated).
//
// f32 in, f32 out, f32 accumulation; T <= 8, any d whose tile fits in
// shared memory.
//
// What bounds them on this card: bytes. K4 reads d + 4 floats per item for
// ~2*d*T flops plus a few transcendentals per stage; K5 also writes d + 4
// floats per item for ~6*d*T flops: 1-3 flops per byte at d = 24, T = 3.
//
// Design (as K3, csrc/cascade_score_bwd.cu): one block per query group,
// walking the group in tiles of kRows items with one thread per item; the
// packed tile is read coalesced into shared memory (row stride d + 5) and
// the logits are recomputed from it. Every sum is taken without atomics, so
// the result is the same bits on every run: each item leaves its terms in
// shared memory, one thread per output adds the tile's items in item order
// into its own accumulator, the per-group sums (ll, cnt_pp, dzq, dzq_pen)
// are final when the block ends, and the grid-wide ones (cost_pp, dw) are
// per-group partials that `ordered_sum_kernel` (ordered_sum.cuh) adds in
// group order. Padded items carry mask = wgt = cost_w = 0 and add nothing.

#include <cuda_runtime.h>

#include "ordered_sum.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;             // items per tile, one thread each
constexpr int kDataCols = 4;           // y, mask, wgt, cost_w
constexpr float kLogPClamp = -1e-7f;   // the NLL's clamp on log p

// Load one tile of packed rows into shared memory (row stride dc + 1).
__device__ __forceinline__ void load_tile(float* sx, const float* src,
                                          int rows, int dc) {
  for (int i = threadIdx.x; i < rows * dc; i += blockDim.x) {
    const int r = i / dc;
    sx[r * (dc + 1) + (i - r * dc)] = src[i];
  }
}

// The item's logits (zq included) and cumulative log pass-probabilities.
__device__ __forceinline__ void item_scores(const float* xr, const float* sw,
                                            const float* zb, int d, int t,
                                            float* z, float* lp) {
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) z[j] = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float xv = xr[k];
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j)
      if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    if (j < t) {
      z[j] += zb[j];
      acc += log_sigmoid(z[j]);
    }
    lp[j] = acc;      // so lp[kMaxStages - 1] is the last stage's, lp[t - 1]
  }
}

// ---------------------------------------------------------------------------
// K4: forward partials.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRows)
cascade_loss_kernel(const float* __restrict__ xc, const float* __restrict__ w,
                    const float* __restrict__ zq, float* __restrict__ ll,
                    float* __restrict__ cnt, float* __restrict__ cost_part,
                    int n_groups, int g, int d, int t) {
  extern __shared__ float smem[];
  const int dc = d + kDataCols;
  const int nv = 1 + 2 * t;            // per item: ll, cost (t), count (t)
  float* sw = smem;                    // (t, d)
  float* sx = sw + t * d;              // (kRows, dc + 1)
  float* sv = sx + kRows * (dc + 1);   // (kRows, nv)
  float* acc = sv + kRows * nv;        // (nv)

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < nv; i += blockDim.x) acc[i] = 0.0f;
  float zb[kMaxStages];
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) zb[j] = j < t ? zq[b * t + j] : 0.0f;

  const long long base = (long long)b * g;
  for (int r0 = 0; r0 < g; r0 += kRows) {
    const int rows = min(kRows, g - r0);
    __syncthreads();
    load_tile(sx, xc + (base + r0) * dc, rows, dc);
    __syncthreads();

    const int r = threadIdx.x;
    if (r < rows) {
      const float* xr = sx + r * (dc + 1);
      float z[kMaxStages], lp[kMaxStages];
      item_scores(xr, sw, zb, d, t, z, lp);
      const float y = xr[d], mask = xr[d + 1], wgt = xr[d + 2],
                  cost_w = xr[d + 3];
      const float lpc = fminf(lp[kMaxStages - 1], kLogPClamp);
      float* v = sv + r * nv;
      v[0] = (wgt * mask) * (y * lpc + (1.0f - y) * log1pf(-expf(lpc)));
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        if (j < t) {
          const float pp = expf(lp[j]);
          v[1 + j] = pp * cost_w;
          v[1 + t + j] = pp * mask;
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float a = acc[j];
      for (int i = 0; i < rows; ++i) a += sv[i * nv + j];
      acc[j] = a;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    if (j == 0)
      ll[b] = acc[0];
    else if (j <= t)
      cost_part[(long long)(j - 1) * n_groups + b] = acc[j];
    else
      cnt[b * t + (j - 1 - t)] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// K5: backward, one recompute pass fusing the three cotangent streams.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRows)
cascade_loss_bwd_kernel(const float* __restrict__ xc,
                        const float* __restrict__ w,
                        const float* __restrict__ zq,
                        const float* __restrict__ g_ll,
                        const float* __restrict__ g_cost,
                        const float* __restrict__ g_cnt,
                        float* __restrict__ dxc, float* __restrict__ dw_part,
                        float* __restrict__ dzq, float* __restrict__ dzq_pen,
                        int n_groups, int g, int d, int t) {
  extern __shared__ float smem[];
  const int dc = d + kDataCols;
  const int n_main = t * (d + 1);      // dw (t, d) and dzq (t) as column d
  const int n_acc = n_main + t;        // ... and dzq_pen (t)
  float* sw = smem;                    // (t, d)
  float* sx = sw + t * d;              // (kRows, dc + 1) tile, then dxc
  float* sm = sx + kRows * (dc + 1);   // (kRows, t) main stream g_logit
  float* sp = sm + kRows * t;          // (kRows, t) penalty stream g_logit
  float* acc = sp + kRows * t;         // (n_acc)

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  float zb[kMaxStages], gcost[kMaxStages], gcnt[kMaxStages];
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    zb[j] = j < t ? zq[b * t + j] : 0.0f;
    gcost[j] = j < t ? g_cost[j] : 0.0f;
    gcnt[j] = j < t ? g_cnt[b * t + j] : 0.0f;
  }
  const float gll = g_ll[b];

  const long long base = (long long)b * g;
  for (int r0 = 0; r0 < g; r0 += kRows) {
    const int rows = min(kRows, g - r0);
    __syncthreads();
    load_tile(sx, xc + (base + r0) * dc, rows, dc);
    __syncthreads();

    const int r = threadIdx.x;
    if (r < rows) {
      const float* xr = sx + r * (dc + 1);
      float z[kMaxStages], lp[kMaxStages];
      item_scores(xr, sw, zb, d, t, z, lp);
      const float y = xr[d], mask = xr[d + 1], wgt = xr[d + 2],
                  cost_w = xr[d + 3];
      const float lpl = lp[kMaxStages - 1];
      const float ppc = expf(fminf(lpl, kLogPClamp));
      const float dll = (wgt * mask) * (y - (1.0f - y) * ppc / (1.0f - ppc));
      // the clamp passes the tangent where lp <= clamp, ties included
      const float g_nll = lpl <= kLogPClamp ? gll * dll : 0.0f;
      float gm[kMaxStages], gp[kMaxStages];
      float tot_m = 0.0f, tot_p = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        if (j < t) {
          const float pp = expf(lp[j]);
          gm[j] = (j == t - 1 ? g_nll : 0.0f) + gcost[j] * pp * cost_w;
          gp[j] = gcnt[j] * pp * mask;
          tot_m += gm[j];
          tot_p += gp[j];
        }
      }
      float cm = 0.0f, cp = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        if (j < t) {
          cm += gm[j];
          cp += gp[j];
          const float sig = 1.0f / (1.0f + expf(z[j]));   // sigma(-logit)
          sm[r * t + j] = (tot_m - cm + gm[j]) * sig;
          sp[r * t + j] = (tot_p - cp + gp[j]) * sig;
        }
      }
    }
    __syncthreads();

    for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
      float a = acc[j];
      if (j < n_main) {
        const int s = j / (d + 1);
        const int k = j - s * (d + 1);
        if (k < d) {
          for (int i = 0; i < rows; ++i)
            a = fmaf(sm[i * t + s], sx[i * (dc + 1) + k], a);
        } else {
          for (int i = 0; i < rows; ++i) a += sm[i * t + s];
        }
      } else {
        const int s = j - n_main;
        for (int i = 0; i < rows; ++i) a += sp[i * t + s];
      }
      acc[j] = a;
    }
    __syncthreads();                   // sx is read; overwrite it with dxc

    if (r < rows) {
      float* row = sx + r * (dc + 1);
      for (int k = 0; k < d; ++k) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxStages; ++j)
          if (j < t) v = fmaf(sm[r * t + j] + sp[r * t + j], sw[j * d + k], v);
        row[k] = v;
      }
      for (int k = d; k < dc; ++k) row[k] = 0.0f;
    }
    __syncthreads();
    float* ob = dxc + (base + r0) * dc;
    for (int i = threadIdx.x; i < rows * dc; i += blockDim.x) {
      const int rr = i / dc;
      ob[i] = sx[rr * (dc + 1) + (i - rr * dc)];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
    if (j < n_main) {
      const int s = j / (d + 1);
      const int k = j - s * (d + 1);
      if (k < d)
        dw_part[(long long)(s * d + k) * n_groups + b] = acc[j];
      else
        dzq[b * t + s] = acc[j];
    } else {
      dzq_pen[b * t + (j - n_main)] = acc[j];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch; the wrappers refuse shapes above the
// card's per-block limit before launching.
size_t cascade_loss_smem(int d, int t) {
  const size_t dc = (size_t)d + kDataCols;
  return sizeof(float) * ((size_t)t * d + kRows * (dc + 1) +
                          kRows * (1 + 2 * (size_t)t) + 1 + 2 * (size_t)t);
}

size_t cascade_loss_bwd_smem(int d, int t) {
  const size_t dc = (size_t)d + kDataCols;
  return sizeof(float) * ((size_t)t * d + kRows * (dc + 1) +
                          2 * kRows * (size_t)t + (size_t)t * (d + 2));
}

// cost_part is scratch of t * b floats. Returns cudaGetLastError() after
// both launches (0 = launched).
int cascade_loss(const float* xc, const float* w, const float* zq, float* ll,
                 float* cost_pp, float* cnt_pp, float* cost_part, int b,
                 int g, int d, int t, void* stream) {
  const size_t smem = cascade_loss_smem(d, t);
  cudaError_t e = allow_smem(cascade_loss_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  cascade_loss_kernel<<<b, kRows, smem, s>>>(xc, w, zq, ll, cnt_pp,
                                             cost_part, b, g, d, t);
  launch_ordered_sum(cost_part, cost_pp, t, b, s);
  return (int)cudaGetLastError();
}

// dw_part is scratch of t * d * b floats. Returns cudaGetLastError() after
// both launches (0 = launched).
int cascade_loss_bwd(const float* xc, const float* w, const float* zq,
                     const float* g_ll, const float* g_cost,
                     const float* g_cnt, float* dxc, float* dw, float* dzq,
                     float* dzq_pen, float* dw_part, int b, int g, int d,
                     int t, void* stream) {
  const size_t smem = cascade_loss_bwd_smem(d, t);
  cudaError_t e = allow_smem(cascade_loss_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  cascade_loss_bwd_kernel<<<b, kRows, smem, s>>>(
      xc, w, zq, g_ll, g_cost, g_cnt, dxc, dw_part, dzq, dzq_pen, b, g, d, t);
  launch_ordered_sum(dw_part, dw, t * d, b, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
