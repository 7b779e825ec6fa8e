// K1: batched cascade scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_score_batched` / `_batched_kernel`
// (src/repro/kernels/cascade_score/kernel.py:224-259):
//
//   lp[b, g, j] = sum_{k <= j} log sigmoid(x[b, g, :] . w_eff[k, :] + zq[b, k])
//
// x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T); f32 in, f32 out,
// f32 accumulation; T <= 8, any d whose ring of tiles fits in shared memory.
//
// What bounds it on this card: bytes. Per item it reads d floats and writes
// T floats and does 2*d*T flops (d = 24, T = 3 for CLOES: 4 flops per byte),
// far below the ~20 flops/byte at which f32 compute would take over. So the
// kernel only has to keep enough of x in flight on every SM and spend few
// instructions per byte: no block that loads, waits, computes and stores in
// turn, no integer divide per float or per item. The design:
//   * persistent blocks, one full wave of the card (the SMs times the
//     blocks that fit on one, asked of the runtime); block k owns the
//     contiguous rows [n k / grid, n (k + 1) / grid) of the B*G flattened
//     rows (cut at multiples of 4, so its lp stores stay 16-byte aligned)
//     and walks them in tiles of kRows rows, one item per thread;
//   * the tiles stream through a ring of 2-3 shared-memory stages filled
//     by cp.async: 16-byte copies, consecutive threads on consecutive
//     addresses, when d % 4 == 0 and x is 16-byte aligned, else 4-byte
//     copies of the same contiguous run (the scalar path, for any d). The
//     next tiles are in flight while the current one is scored, and one
//     barrier per tile keeps the ring's stages apart. Where two tiles do
//     not fit in shared memory (d > ~220) the ring is one tile, loaded and
//     scored in turn, so the kernel takes every d whose one tile fits;
//   * an item's row is read from its stage as float4 vectors (scalars on
//     the scalar path), w_eff sits in shared memory as float4 broadcasts,
//     and the T logits stay in registers;
//   * the group of a row (which zq row it adds) comes from a running
//     counter: one divide per thread at the start, then per tile
//     b += kRows / G, rem += kRows % G with one carry;
//   * each warp stages its 32 items' (32, T) lp rows in shared memory and
//     stores them as one contiguous run, float4 where aligned.
//   * two instances of each path: one for T = 3 (CLOES's cascade, the
//     main path), whose stage loops have three steps at compile time, and
//     one for any T <= 8, whose loops run to 8 behind a test of j < T (on
//     the H100 the T = 3 instance takes ~12% less time at 4096 x 256).
// Numerics: per item, fmaf over k = 0..d-1 in order, and K6's log_sigmoid
// and cumulative add (cascade_score_single.cu), so a launch gives the
// same bits as K6 on a group.
// The TPU kernel's padding (LANE = 128 on d, MAX_STAGES on T, BLOCK_ITEMS)
// is a layout choice and is not carried over. All-zero padded rows stay
// inert: their lp is log sigmoid(zq), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;            // items per tile, one thread each
constexpr int kMaxRing = 3;           // tiles in flight or in use per block

// Floats of shared memory: w_eff (rounded to whole float4s), the ring of
// `ring` (kRows, d) tiles, and the (kRows, t) lp staging.
__host__ __device__ __forceinline__ size_t smem_floats(int d, int t,
                                                       int ring) {
  return (size_t)round4(t * d) + (size_t)ring * kRows * d +
         (size_t)kRows * t;
}

// The deepest ring (<= kMaxRing) whose shared memory fits a block; 1 when
// not even two tiles fit (the wrapper refuses a d whose one tile does not).
int ring_depth(int d, int t) {
  for (int r = kMaxRing; r > 1; --r)
    if (sizeof(float) * smem_floats(d, t, r) <= kMaxSmemBytes) return r;
  return 1;
}

// Tile i of a block's rows [r_begin, r_end) into its stage i % ring of
// sx: 16-byte copies on the vector path, 4-byte ones on the scalar path.
// One commit group per call (empty past the last tile), so the waits
// count tiles.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* sx, const float* x,
                                           long long r_begin, long long r_end,
                                           int i, int ring, int d) {
  const long long r0 = r_begin + (long long)i * kRows;
  if (r0 < r_end) {
    const int n = (int)min((long long)kRows, r_end - r0) * d;
    const float* src = x + r0 * d;
    float* dst = sx + (i % ring) * (kRows * d);
    if (VEC) {
      for (int c = threadIdx.x; c < n / 4; c += kRows)
        cp_async16(dst + 4 * c, src + 4 * c);
    } else {
      for (int c = threadIdx.x; c < n; c += kRows) cp_async4(dst + c, src + c);
    }
  }
  cp_async_commit();
}

template <bool VEC, int TS>
__global__ void __launch_bounds__(kRows)
cascade_score_batched_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ zq,
                             float* __restrict__ out, long long n_rows,
                             int g, int d, int t, int ring) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                            // (t, d) stage weights
  float* sx = smem + round4(t * d);            // ring x (kRows, d) tiles
  float* so = sx + (size_t)ring * kRows * d;   // (kRows, t) lp staging
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_floats = kRows * d;

  // This block's rows, cut at multiples of 4 (the last block ends at n).
  const long long r_begin = (n_rows * blockIdx.x / gridDim.x) & ~3LL;
  const long long r_end =
      blockIdx.x + 1 == gridDim.x
          ? n_rows
          : (n_rows * (blockIdx.x + 1) / gridDim.x) & ~3LL;
  const int n_tiles = (int)((r_end - r_begin + kRows - 1) / kRows);

  for (int e = tid; e < t * d; e += kRows) sw[e] = w[e];
  for (int i = 0; i < ring - 1; ++i)
    stage_tile<VEC>(sx, x, r_begin, r_end, i, ring, d);

  // Running group counter of this thread's row: b = row / g, rem = row % g.
  const long long row0 = r_begin + tid;
  long long b = row0 / g;
  int rem = (int)(row0 - b * g);
  const int step_b = kRows / g, step_rem = kRows % g;

  for (int i = 0; i < n_tiles; ++i) {
    // Tile i has landed (this thread's copies, then every thread's after
    // the barrier), and every thread is done with tile i - 1: refill its
    // stage. A one-tile ring issues tile i itself here and waits for it.
    if (ring >= 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    stage_tile<VEC>(sx, x, r_begin, r_end, i + ring - 1, ring, d);
    if (ring == 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const long long r0 = r_begin + (long long)i * kRows;
    const int rows = (int)min((long long)kRows, r_end - r0);
    if (tid < rows) {
      const float* xs = sx + (i % ring) * tile_floats + tid * d;
      float z[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) z[j] = 0.0f;
      if (VEC) {
        const float4* xr = reinterpret_cast<const float4*>(xs);
        const float4* w4 = reinterpret_cast<const float4*>(sw);
        for (int c4 = 0; c4 < d / 4; ++c4) {
          const float4 a = xr[c4];
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            if (j < t) {
              const float4 wv = w4[j * (d / 4) + c4];
              z[j] = fmaf(a.x, wv.x, z[j]);
              z[j] = fmaf(a.y, wv.y, z[j]);
              z[j] = fmaf(a.z, wv.z, z[j]);
              z[j] = fmaf(a.w, wv.w, z[j]);
            }
          }
        }
      } else {
        for (int k = 0; k < d; ++k) {
          const float xv = xs[k];
#pragma unroll
          for (int j = 0; j < kS; ++j)
            if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
        }
      }
      const float* zb = zq + b * t;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        if (j < t) {
          acc += log_sigmoid(z[j] + __ldg(zb + j));
          so[tid * t + j] = acc;
        }
      }
    }
    __syncwarp();
    // The warp's rows [32 warp, 32 warp + nr) as one contiguous run.
    const int nr = min(32, rows - 32 * warp);
    if (nr > 0) {
      const int nf = nr * t;
      const float* src = so + 32 * warp * t;
      float* dst = out + (r0 + 32 * warp) * t;
      if (nf % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        for (int e = lane; e < nf / 4; e += 32)
          reinterpret_cast<float4*>(dst)[e] =
              reinterpret_cast<const float4*>(src)[e];
      } else {
        for (int e = lane; e < nf; e += 32) dst[e] = src[e];
      }
    }
    __syncwarp();                      // the staging is free for tile i + 1
    b += step_b;
    rem += step_rem;
    if (rem >= g) {
      rem -= g;
      ++b;
    }
  }
  cp_async_wait_all();
}

template <bool VEC, int TS>
int launch(const float* x, const float* w, const float* zq, float* out,
           long long n_rows, int g, int d, int t, cudaStream_t stream) {
  const int ring = ring_depth(d, t);
  const size_t smem = sizeof(float) * smem_floats(d, t, ring);
  cudaError_t e = allow_smem(cascade_score_batched_kernel<VEC, TS>, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per tile
  const int blocks = one_wave_blocks(cascade_score_batched_kernel<VEC, TS>,
                                     kRows, smem,
                                     (n_rows + kRows - 1) / kRows);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cascade_score_batched_kernel<VEC, TS><<<blocks, kRows, smem, stream>>>(
      x, w, zq, out, n_rows, g, d, t, ring);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The library's CUDA runtime error text, for the Python wrappers' errors.
const char* cascade_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// Dynamic shared memory one launch needs (its ring at least one tile
// deep); the wrapper refuses shapes above the card's per-block limit
// before launching.
size_t cascade_score_batched_smem(int d, int t) {
  return sizeof(float) * smem_floats(d, t, ring_depth(d, t));
}

// Returns cudaGetLastError() after the launch (0 = launched).
int cascade_score_batched(const float* x, const float* w, const float* zq,
                          float* out, int b, int g, int d, int t,
                          void* stream) {
  const long long n_rows = (long long)b * g;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // an instance for CLOES's T = 3, and one for any T
  auto run = t == 3 ? (vec ? launch<true, 3> : launch<false, 3>)
                    : (vec ? launch<true, 0> : launch<false, 0>);
  return run(x, w, zq, out, n_rows, g, d, t, s);
}

}  // extern "C"
