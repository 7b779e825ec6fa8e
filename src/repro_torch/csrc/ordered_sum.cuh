// The fixed-order second pass that adds per-block partials of a grid-wide
// sum, shared by the training kernels (cascade_score_bwd.cu,
// cascade_loss.cu, cascade_score_single.cu).
//
// Determinism: no float sum in these kernels uses atomics. A sum over the
// whole grid (dw in K3 and K5, cost_pp in K4) is taken in two passes: each
// block writes its partial to a scratch tensor laid out (n_out, n_blocks),
// then `ordered_sum_kernel` adds each row in one fixed order (a strided
// per-thread loop, then a shared-memory tree). The same inputs give the same
// bits on every run, which bit-identical training resume depends on.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kSumThreads = 256;

// out[j] = sum_b part[j * n + b], for j < gridDim.x, in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
ordered_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int n) {
  __shared__ float s[kSumThreads];
  const float* p = part + (long long)blockIdx.x * n;
  float a = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) a += p[i];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// Launch the second pass over `n_out` rows of `n` partials each.
inline void launch_ordered_sum(const float* part, float* out, int n_out,
                               int n, cudaStream_t stream) {
  if (n_out > 0)
    ordered_sum_kernel<<<n_out, kSumThreads, 0, stream>>>(part, out, n);
}

}  // namespace
