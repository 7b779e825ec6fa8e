// K1: batched cascade scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_score_batched` / `_batched_kernel`
// (src/repro/kernels/cascade_score/kernel.py:224-259):
//
//   lp[b, g, j] = sum_{k <= j} log sigmoid(x[b, g, :] . w_eff[k, :] + zq[b, k])
//
// x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T); f32 in, f32 out,
// f32 accumulation; T <= 8, any d whose tile fits in shared memory.
//
// What bounds it on this card: bytes. Per item it reads d floats and writes
// T floats and does 2*d*T flops (d = 24, T = 3 for CLOES: 4 flops per byte),
// far below the ~20 flops/byte at which f32 compute would take over. So the
// design only has to stream x at full width:
//   * one block per kRows consecutive items (B*G rows flattened; the group
//     index b = row / G picks zq), one thread per item;
//   * the block's x tile is read with consecutive threads on consecutive
//     addresses into shared memory (row stride d + 1, so a thread walking
//     its own row hits a different bank from its neighbours), and the T
//     outputs are staged the same way for coalesced stores;
//   * w_eff (<= 8 x d) sits in shared memory, the T logits in registers.
// The TPU kernel's padding (LANE = 128 on d, MAX_STAGES on T, BLOCK_ITEMS)
// is a layout choice and is not carried over. All-zero padded rows stay
// inert: their lp is log sigmoid(zq), as in the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;  // items per block, one thread each

// log sigma(z) = min(z, 0) - log1p(exp(-|z|)): no overflow for any finite z.
__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

__global__ void __launch_bounds__(kRows)
cascade_score_batched_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ zq,
                             float* __restrict__ out, long long n_rows,
                             int g, int d, int t) {
  extern __shared__ float smem[];
  float* sw = smem;                   // (t, d) stage weights
  float* sx = sw + t * d;             // (kRows, d + 1) item tile
  float* so = sx + kRows * (d + 1);   // (kRows, t) output tile

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n_rows - row0);
  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  const float* xb = x + row0 * d;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    sx[r * (d + 1) + (i - r * d)] = xb[i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    const float* xr = sx + r * (d + 1);
    const float* zb = zq + ((row0 + r) / g) * t;
    float z[kMaxStages];
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
        acc += log_sigmoid(z[j] + zb[j]);
        so[r * t + j] = acc;
      }
    }
  }
  __syncthreads();
  float* ob = out + row0 * t;
  for (int i = threadIdx.x; i < rows * t; i += blockDim.x) ob[i] = so[i];
}

}  // namespace

extern "C" {

// The library's CUDA runtime error text, for the Python wrappers' errors.
const char* cascade_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// Dynamic shared memory one launch needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t cascade_score_batched_smem(int d, int t) {
  return sizeof(float) * ((size_t)t * d + (size_t)kRows * (d + 1) +
                          (size_t)kRows * t);
}

// Returns cudaGetLastError() after the launch (0 = launched).
int cascade_score_batched(const float* x, const float* w, const float* zq,
                          float* out, int b, int g, int d, int t,
                          void* stream) {
  const long long n_rows = (long long)b * g;
  const size_t smem = cascade_score_batched_smem(d, t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cascade_score_batched_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  cascade_score_batched_kernel<<<blocks, kRows, smem,
                                 (cudaStream_t)stream>>>(x, w, zq, out,
                                                         n_rows, g, d, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
