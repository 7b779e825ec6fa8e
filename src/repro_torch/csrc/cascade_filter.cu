// K2: fused cascade score + filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_filter` / `_kernel`
// (src/repro/kernels/cascade_filter/kernel.py:60-167). Per query group b:
//
//   lp[i, j]  = sum_{k <= j} log sigmoid(x[i] . w_eff[k] + zq[b, k])
//   counts[j] = (m_q / N_q) * sum_{i valid} exp(lp[i, j])             (Eq 10)
//   n_keep[j] = clip(ceil(counts[j] * N_q / max(m_q, 1)), 1, G)
//   surv_j    = surv_{j-1} * (rank_j < n_keep[j]), where over the current
//               survivors rank_j[i] = #{k : s_k > s_i} + #{k < i : s_k == s_i}
//
// x (B, G, d), w_eff (T, d), zq (B, T), mask (B, G), m_q (B,) ->
// lp, survivors (B, G, T) as f32 0/1, expected_counts, n_keep (B, T).
// T <= 8, G <= 512; f32 throughout.
//
// What bounds it on this card: bytes at the serving shapes. Each group
// reads G*d floats and writes 2*G*T; the all-pairs rank costs G compares
// per surviving item per stage (<= G^2 * T, 0.2 M per group at G = 256),
// which at B = 4096 groups is still below the time to stream x.
// The design:
//   * one block per group, one thread per item (blockDim = G rounded up to
//     a warp), so a whole group's scores live in registers and shared
//     memory and nothing between the score and the survivors touches
//     device memory;
//   * the per-stage sums for Eq 10 are a fixed-order tree in shared memory
//     (no atomics), so counts and n_keep are the same from run to run;
//   * one thread forms counts and n_keep in the reference's operation
//     order ((m_q / N_q) * sum, then ceil(counts * N_q / max(m_q, 1)));
//   * the stable top-n_keep is an all-pairs rank against a shared copy of
//     the stage's scores (a broadcast read per compare, no bank
//     conflicts): the sorted order is never needed, only each item's rank,
//     and the tie term keeps the lowest index first like a stable sort.
// Rows at or past G (the warp round-up) and rows with mask 0 score -inf and
// never survive.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxGroup = 512;

__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

// p: the reduction width, the power of two >= blockDim.
__global__ void __launch_bounds__(kMaxGroup)
cascade_filter_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ zq,
                      const float* __restrict__ mask,
                      const float* __restrict__ mq,
                      float* __restrict__ lp_out,
                      float* __restrict__ surv_out,
                      float* __restrict__ counts_out,
                      float* __restrict__ nkeep_out, int g, int d, int t,
                      int p) {
  extern __shared__ float smem[];
  float* sw = smem;               // (t, d) stage weights
  float* red = sw + t * d;        // (t + 1, p) reduction rows
  float* s = red + (t + 1) * p;   // (g,) the current stage's scores
  __shared__ float s_nkeep[kMaxStages];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool real = i < g;
  for (int k = i; k < t * d; k += blockDim.x) sw[k] = w[k];
  __syncthreads();

  const long long item = (long long)b * g + i;
  const float valid = real ? mask[item] : 0.0f;
  float lp[kMaxStages];
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) lp[j] = 0.0f;
  if (real) {
    const float* xr = x + item * d;
    for (int k = 0; k < d; ++k) {
      const float xv = xr[k];
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j)
        if (j < t) lp[j] = fmaf(xv, sw[j * d + k], lp[j]);
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j) {
      if (j < t) {
        acc += log_sigmoid(lp[j] + zq[b * t + j]);
        lp[j] = acc;
        lp_out[item * t + j] = acc;
      }
    }
  }

  // Eq 10 sums, fixed-order tree: row 0 sums the mask (N_q), row 1 + j
  // sums mask * exp(lp_j).
  for (int k = i; k < p; k += blockDim.x) {
    const bool mine = k == i;
    red[k] = mine ? valid : 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j)
      if (j < t) red[(1 + j) * p + k] = mine && real ? expf(lp[j]) * valid : 0.0f;
  }
  __syncthreads();
  for (int stride = p / 2; stride > 0; stride >>= 1) {
    if (i < stride) {
      for (int c = 0; c <= t; ++c) red[c * p + i] += red[c * p + i + stride];
    }
    __syncthreads();
  }
  if (i == 0) {
    const float n_valid = red[0];
    const float m = mq[b];
    const float n_q = fmaxf(n_valid, 1.0f);
    for (int j = 0; j < t; ++j) {
      const float c = (m / n_q) * red[(1 + j) * p];
      float nk = ceilf(c * n_valid / fmaxf(m, 1.0f));
      nk = fminf(fmaxf(nk, 1.0f), (float)g);
      counts_out[b * t + j] = c;
      nkeep_out[b * t + j] = nk;
      s_nkeep[j] = nk;
    }
  }

  // Chained stable rank-select. A non-survivor's surv stays 0 whatever its
  // rank, so only survivors count theirs.
  float surv = valid;
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    if (j >= t) break;
    if (real) s[i] = surv > 0.0f ? lp[j] : -INFINITY;
    __syncthreads();
    if (surv > 0.0f) {
      const float si = s[i];
      int rank = 0;
      for (int k = 0; k < g; ++k) {
        const float sk = s[k];
        rank += (sk > si) | ((sk == si) & (k < i));
      }
      surv = surv * ((float)rank < s_nkeep[j] ? 1.0f : 0.0f);
    }
    if (real) surv_out[item * t + j] = surv;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int cascade_filter_threads(int g) { return (g + 31) / 32 * 32; }

int cascade_filter_width(int g) {
  int p = 1;
  while (p < cascade_filter_threads(g)) p <<= 1;
  return p;
}

size_t cascade_filter_smem(int g, int d, int t) {
  return sizeof(float) *
         ((size_t)t * d + (size_t)(t + 1) * cascade_filter_width(g) + g);
}

// Returns cudaGetLastError() after the launch (0 = launched).
int cascade_filter(const float* x, const float* w, const float* zq,
                   const float* mask, const float* mq, float* lp,
                   float* surv, float* counts, float* nkeep, int b, int g,
                   int d, int t, void* stream) {
  const size_t smem = cascade_filter_smem(g, d, t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cascade_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cascade_filter_kernel<<<b, cascade_filter_threads(g), smem,
                          (cudaStream_t)stream>>>(
      x, w, zq, mask, mq, lp, surv, counts, nkeep, g, d, t,
      cascade_filter_width(g));
  return (int)cudaGetLastError();
}

}  // extern "C"
