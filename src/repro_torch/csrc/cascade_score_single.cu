// K6 and K7: the single-group cascade scorer, its backward, and the
// feature-major scorer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels (src/repro/kernels/cascade_score/kernel.py)
//   K6 forward   `cascade_score` / `_kernel`          (kernel.py:73)
//   K6 backward  `cascade_score_bwd` / `_bwd_kernel`  (kernel.py:154)
//   K7           `cascade_score_fm` / `_kernel_fm`    (kernel.py:365)
//
// For one query group of N items with one bias row zq (T,):
//
//   out[i, j]  = sum_{k <= j} log sigmoid(x[i, :] . w_eff[k, :] + zq[k])
//   gc[i, k]   = sum_{j >= k} g[i, j]            (as total - cumsum + g)
//   g_logit    = gc * sigmoid(-logit)
//   dx (N, d)  = g_logit . w_eff    dw (T, d) = g_logit^T x    dzq (T,) = sum_i g_logit
//
// K7 computes the forward from xt (d, N), the features stored
// feature-major, and returns (N, T) like K6. x, w_eff, zq (and the
// cotangent g) are float32 or bfloat16, up-cast in registers; every output
// and every sum is float32. T <= 8.
//
// What bounds them on this card: bytes. Per item the forward reads d
// values and writes T floats for 2*d*T flops (d = 24, T = 3: 4 flops per
// f32 byte); the backward reads d + T and writes d for ~6*d*T; both far
// below the ~20 flops/byte where f32 compute would take over. So:
//   * K6 forward is K1 (cascade_score.cu) with one bias row: one block of
//     kRows threads per kRows items, the x tile read coalesced into shared
//     memory (row stride d + 1: a thread walking its row meets no bank of
//     its neighbours), w_eff and zq in shared memory, the T outputs staged
//     for coalesced stores. The per-item sums run in K1's order, so a K6
//     launch per group gives what K1 gives for the batch.
//   * K7 needs no transpose: thread i reads xt[k, i] for each feature k, so
//     a warp reads 32 consecutive addresses of each row of xt.
//   * K6 backward sums dw and dzq over all N items of the group, which can
//     be 10^6: one block per group (K3's layout) would put them on one SM.
//     It runs a grid of at most kMaxBwdBlocks blocks instead, each walking
//     a contiguous run of item tiles as K3 walks a group: it recomputes the
//     logits from its x tile (no residual of the forward), writes dx, and
//     adds its items' dw and dzq terms in item order into shared memory.
//     Each block writes its partials to scratch (T*d + T, n_blocks) and
//     `ordered_sum_kernel` (ordered_sum.cuh) adds them in block order. No
//     float atomics: the same inputs give the same bits on every run.
// All-zero rows stay inert: their output is cumsum log sigmoid(zq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ordered_sum.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;          // items per tile, one thread each
constexpr int kMaxBwdBlocks = 1024;  // ~8 resident blocks on each of 132 SMs
// Bits of `bf16`: which inputs are bfloat16 (the others are float32).
constexpr int kXBf16 = 1, kWBf16 = 2, kZqBf16 = 4, kGBf16 = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Element i of a float32 or bfloat16 array.
__device__ __forceinline__ float load(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// w_eff (t, d) and then zq (t) into shared memory as float32.
__device__ __forceinline__ void load_params(const void* w, const void* zq,
                                            int bf16, float* sw, int d,
                                            int t) {
  for (int i = threadIdx.x; i < t * d; i += blockDim.x)
    sw[i] = load(w, i, bf16 & kWBf16);
  for (int i = threadIdx.x; i < t; i += blockDim.x)
    sw[t * d + i] = load(zq, i, bf16 & kZqBf16);
}

// z[j] = sum_k x_at(k) * w[j, k] for the item, fmaf in feature order (K1's
// order); the bias is added where the value is used, as in K1.
template <typename XAt>
__device__ __forceinline__ void dot_stages(XAt x_at, const float* sw, int d,
                                           int t, float (&z)[kMaxStages]) {
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) z[j] = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float xv = x_at(k);
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j)
      if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
  }
}

// The item's output row: o[j] = sum_{k <= j} log sigmoid(z[k] + zq[k]).
__device__ __forceinline__ void cum_log_sigmoid(const float (&z)[kMaxStages],
                                                const float* sz, int t,
                                                float* o) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    if (j < t) {
      acc += log_sigmoid(z[j] + sz[j]);
      o[j] = acc;
    }
  }
}

// A tile of `rows` items from x into sx (row stride d + 1), up-cast.
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* xb, float* sx, int rows,
                                        int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    sx[r * (d + 1) + (i - r * d)] = to_f32(xb[i]);
  }
}

// Copy n staged values to device memory, consecutive threads on
// consecutive addresses.
__device__ __forceinline__ void store_tile(const float* s, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = s[i];
}

template <typename TX>
__global__ void __launch_bounds__(kRows)
score_kernel(const TX* __restrict__ x, const void* __restrict__ w,
             const void* __restrict__ zq, float* __restrict__ out, int n,
             int d, int t, int bf16) {
  extern __shared__ float smem[];
  float* sw = smem;                   // (t, d) stage weights, (t) biases
  float* sx = sw + t * d + t;         // (kRows, d + 1) item tile
  float* so = sx + kRows * (d + 1);   // (kRows, t) output tile

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n - row0);
  load_params(w, zq, bf16, sw, d, t);
  stage_x(x + row0 * d, sx, rows, d);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    const float* xr = sx + r * (d + 1);
    float z[kMaxStages];
    dot_stages([&](int k) { return xr[k]; }, sw, d, t, z);
    cum_log_sigmoid(z, sw + t * d, t, so + r * t);
  }
  __syncthreads();
  store_tile(so, out + row0 * t, rows * t);
}

template <typename TX>
__global__ void __launch_bounds__(kRows)
score_fm_kernel(const TX* __restrict__ xt, const void* __restrict__ w,
                const void* __restrict__ zq, float* __restrict__ out, int n,
                int d, int t, int bf16) {
  extern __shared__ float smem[];
  float* sw = smem;                   // (t, d) stage weights, (t) biases
  float* so = sw + t * d + t;         // (kRows, t) output tile

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n - row0);
  load_params(w, zq, bf16, sw, d, t);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    const TX* xi = xt + row0 + r;     // column row0 + r of xt (d, n)
    float z[kMaxStages];
    dot_stages([&](int k) { return to_f32(xi[(long long)k * n]); }, sw, d, t,
               z);
    cum_log_sigmoid(z, sw + t * d, t, so + r * t);
  }
  __syncthreads();
  store_tile(so, out + row0 * t, rows * t);
}

template <typename TX>
__global__ void __launch_bounds__(kRows)
score_bwd_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                 const void* __restrict__ zq, const void* __restrict__ gct,
                 float* __restrict__ dx, float* __restrict__ part, int n,
                 int d, int t, int tiles_per_block, int bf16) {
  extern __shared__ float smem[];
  const int n_acc = t * (d + 1);      // dw (t, d) and dzq (t) as column d
  float* sw = smem;                   // (t, d) stage weights, (t) biases
  float* sx = sw + t * d + t;         // (kRows, d + 1) item tile, then dx
  float* sg = sx + kRows * (d + 1);   // (kRows, t) cotangent, then g_logit
  float* acc = sg + kRows * t;        // (t, d + 1) the block's sums
  const float* sz = sw + t * d;

  load_params(w, zq, bf16, sw, d, t);
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;

  const long long first = (long long)blockIdx.x * tiles_per_block * kRows;
  const long long last =
      min((long long)n, first + (long long)tiles_per_block * kRows);
  for (long long r0 = first; r0 < last; r0 += kRows) {
    const int rows = (int)min((long long)kRows, last - r0);
    __syncthreads();                  // the previous tile is fully used
    stage_x(x + r0 * d, sx, rows, d);
    for (int i = threadIdx.x; i < rows * t; i += blockDim.x)
      sg[i] = load(gct, r0 * t + i, bf16 & kGBf16);
    __syncthreads();

    const int r = threadIdx.x;
    if (r < rows) {
      const float* xr = sx + r * (d + 1);
      float z[kMaxStages];
      dot_stages([&](int k) { return xr[k]; }, sw, d, t, z);
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
          sg[r * t + j] = gc / (1.0f + expf(z[j] + sz[j]));  // * sigma(-logit)
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
    float* ob = dx + r0 * d;
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int rr = i / d;
      ob[i] = sx[rr * (d + 1) + (i - rr * d)];
    }
  }
  __syncthreads();
  // Partials laid out (t * d + t, gridDim.x): dw's rows, then dzq's.
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
    const int s = j / (d + 1);
    const int k = j - s * (d + 1);
    const int row = k < d ? s * d + k : t * d + s;
    part[(long long)row * gridDim.x + blockIdx.x] = acc[j];
  }
}

int tiles_of(int n) { return (n + kRows - 1) / kRows; }

// Tiles per backward block: the fewest that keep the grid within
// kMaxBwdBlocks. Depends only on n, so the summation order does too.
int bwd_tiles_per_block(int n) {
  return (tiles_of(n) + kMaxBwdBlocks - 1) / kMaxBwdBlocks;
}

// One launch of a forward kernel (K6 or K7) for x's element type TX.
template <typename TX>
int launch_forward(void (*kernel)(const TX*, const void*, const void*, float*,
                                  int, int, int, int),
                   size_t smem, const void* x, const void* w, const void* zq,
                   float* out, int n, int d, int t, int bf16,
                   cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiles_of(n), kRows, smem, stream>>>(static_cast<const TX*>(x), w,
                                               zq, out, n, d, t, bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrappers refuse shapes above
// the card's per-block limit before launching.
size_t cascade_score_single_smem(int d, int t) {
  return sizeof(float) * ((size_t)t * d + t + (size_t)kRows * (d + 1) +
                          (size_t)kRows * t);
}

size_t cascade_score_single_bwd_smem(int d, int t) {
  return cascade_score_single_smem(d, t) + sizeof(float) * (size_t)t * (d + 1);
}

size_t cascade_score_fm_smem(int d, int t) {
  return sizeof(float) * ((size_t)t * d + t + (size_t)kRows * t);
}

// Blocks of the backward's grid for n items: the scratch holds
// (t * d + t) partials for each.
int cascade_score_single_bwd_blocks(int n) {
  const int per = bwd_tiles_per_block(n);
  return (tiles_of(n) + per - 1) / per;
}

// K6 forward: x (n, d), w (t, d), zq (t) -> out (n, t). Returns
// cudaGetLastError() after the launch (0 = launched).
int cascade_score_single(const void* x, const void* w, const void* zq,
                         float* out, int n, int d, int t, int bf16,
                         void* stream) {
  const size_t smem = cascade_score_single_smem(d, t);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 & kXBf16)
    return launch_forward(score_kernel<__nv_bfloat16>, smem, x, w, zq, out,
                          n, d, t, bf16, s);
  return launch_forward(score_kernel<float>, smem, x, w, zq, out, n, d, t,
                        bf16, s);
}

// K7: xt (d, n), w (t, d), zq (t) -> out (n, t).
int cascade_score_fm(const void* xt, const void* w, const void* zq,
                     float* out, int n, int d, int t, int bf16,
                     void* stream) {
  const size_t smem = cascade_score_fm_smem(d, t);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 & kXBf16)
    return launch_forward(score_fm_kernel<__nv_bfloat16>, smem, xt, w, zq,
                          out, n, d, t, bf16, s);
  return launch_forward(score_fm_kernel<float>, smem, xt, w, zq, out, n, d,
                        t, bf16, s);
}

// K6 backward: cotangent g (n, t) -> dx (n, d) and sums = [dw (t, d) |
// dzq (t)]; part is scratch of (t * d + t) * cascade_score_single_bwd_blocks(n)
// floats. Returns cudaGetLastError() after both launches.
int cascade_score_single_bwd(const void* x, const void* w, const void* zq,
                             const void* g, float* dx, float* sums,
                             float* part, int n, int d, int t, int bf16,
                             void* stream) {
  const size_t smem = cascade_score_single_bwd_smem(d, t);
  const int per = bwd_tiles_per_block(n);
  const int blocks = cascade_score_single_bwd_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (bf16 & kXBf16) {
    e = allow_smem(score_bwd_kernel<__nv_bfloat16>, smem);
    if (e != cudaSuccess) return (int)e;
    score_bwd_kernel<<<blocks, kRows, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, zq, g, dx, part, n, d, t,
        per, bf16);
  } else {
    e = allow_smem(score_bwd_kernel<float>, smem);
    if (e != cudaSuccess) return (int)e;
    score_bwd_kernel<<<blocks, kRows, smem, s>>>(
        static_cast<const float*>(x), w, zq, g, dx, part, n, d, t, per,
        bf16);
  }
  launch_ordered_sum(part, sums, t * d + t, blocks, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
