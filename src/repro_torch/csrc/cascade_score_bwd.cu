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
// f32 in, f32 out, f32 accumulation; T <= 8, any d whose ring fits in
// shared memory (d <= 825 at T = 3, 716 at T = 8).
//
// What bounds it on this card: bytes. Per item it reads d + T floats and
// writes d floats and does ~6*d*T flops (d = 24, T = 3: ~2.3 flops per
// byte), far below the ~20 flops/byte where f32 compute would take over.
//
// It replaces its first design: one block of 128 threads per group, each
// 128-row tile loaded, waited on, computed and stored in turn behind five
// barriers, an integer divide per float on the load and on the dx store,
// and one thread per (stage, feature) walking a tile's 128 items (26.8% of
// its bound at 4096 x 256). K3 is K5 (cascade_loss.cu) without the NLL and
// penalty streams, and takes K5's map and ring (warp_ring.cuh), not K1's row
// split: dzq is a sum per group, and a group split over two blocks' row
// ranges would need a combine across blocks. The design:
//   * persistent blocks of kWarps = 4 warps (one warp at a d too wide for
//     four warps' rings, see `score_bwd_warps`), one full wave of the card;
//     block k takes the groups k, k + grid, ..., and its warp w the chunks
//     w, w + kWarps, ... of 32 rows of each;
//   * each warp streams its chunks through its own two-stage cp.async ring,
//     prefetching across group boundaries. A stage holds the chunk's x rows
//     (32, d), copied 16 bytes at a time when d % 4 == 0 and x is 16-byte
//     aligned (else 4 bytes: the scalar path, any d), then its cotangent rows
//     (32, T), always copied 4 bytes at a time: at T = 3 a chunk's g rows
//     start at float (b G + r) 3, which is 16-byte aligned only where
//     b G + r is a multiple of 4 (with G = 7, most chunks are not);
//   * per chunk, lane = item recomputes its logits from its x row (no
//     residual of the forward) and forms its g_logit row in shared memory;
//     then lane = column k walks the chunk's items in order: T chains a
//     lane into the sums (k < d: dw, k = d: dzq, a column of ones; fmaf(v,
//     1, a) is a + v exactly) and the dx row formed in place of the item's
//     x; the warp stores the chunk as one contiguous run, float4 where
//     aligned;
//   * sums in a fixed order, without float atomics: dzq is, per group, each
//     warp's chain over its chunks' items in order, the warps' chains added
//     in warp order at the group's end (the block's one barrier per group);
//     dw is each warp's chain over all its items, the warps' chains added in
//     warp order into one partial per block, and `ordered_sum_kernel`
//     (ordered_sum.cuh) adds the blocks' partials in block order. The warps
//     and blocks depend only on (d, T) and the card, so the same inputs on
//     the same card give the same bits (tests/test_torch_losses.py holds a
//     plain copy of this order to the reference);
//   * two instances of each path with four warps: one for T = 3 (CLOES's
//     cascade, the main path), whose stage loops have three steps at compile
//     time, and one for any T <= 8, whose loops run to 8 behind a test of
//     j < T. Both take the same sums in the same order.
// Padded items carry a zero cotangent and add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ordered_sum.cuh"
#include "warp_ring.cuh"

namespace {

constexpr int kMaxStages = 8;

// Floats of one warp's shared memory: its ring of kRing stages, each a
// chunk's (kChunk, d) x rows and then its (kChunk, t) cotangent rows; the
// chunk's g_logit rows (kChunk, round4(t)); and its t * (d + 1) chains.
__host__ __device__ __forceinline__ int warp_floats(int d, int t) {
  return kRing * kChunk * (d + t) + kChunk * round4(t) + round4(t * (d + 1));
}

// Floats before the warps' memory: w_eff, and the nw warps' per-group dzq
// partials, double-buffered by group parity.
__host__ __device__ __forceinline__ int shared_floats(int d, int t, int nw) {
  return round4(t * d) + round4(2 * nw * t);
}

__host__ __device__ __forceinline__ size_t smem_floats(int d, int t, int nw) {
  return (size_t)shared_floats(d, t, nw) + (size_t)nw * warp_floats(d, t);
}

// Warps per block: kWarps up to d = 209 at T = 3 (185 at T = 8), then one,
// whose ring fits up to d = 825 at T = 3 (716 at T = 8): wider than its first
// design took (429, 395).
int score_bwd_warps(int d, int t) {
  return ring_warps(smem_floats(d, t, kWarps));
}

template <bool VEC, int NW, int TS>
__global__ void __launch_bounds__(32 * NW)
cascade_score_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ zq,
                         const float* __restrict__ gct,
                         float* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ dzq,
                         int n_groups, int g, int d, int t) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  const int ts = round4(t);            // row stride of the g_logit rows
  const int n_col = d + 1;             // dw columns, then dzq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wfloats = warp_floats(d, t);
  const int stage_floats = kChunk * (d + t);
  float* sw = smem;                                        // (t, d)
  float* part = smem + round4(t * d);                      // (2, NW, t)
  float* ring = smem + shared_floats(d, t, NW) + warp * wfloats;
  float* sl = ring + kRing * stage_floats;                 // (32, ts)
  float* acc = sl + kChunk * ts;                           // (t, n_col)

  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  for (int i = lane; i < t * n_col; i += 32) acc[i] = 0.0f;
  __syncthreads();                     // sw is shared by the warps

  ChunkWalk c = chunk_walk<NW>(n_groups, g, warp);
  auto copy = [&](int stage, int ib, int r0, int rows) {
    float* dst = ring + stage * stage_floats;
    const long long row = (long long)ib * g + r0;
    copy_run<VEC>(dst, x + row * d, rows * d, lane);
    copy_run<false>(dst + kChunk * d, gct + row * t, rows * t, lane);
  };
  stage_next_chunk<NW>(c, g, warp, copy);

  int q = 0;                           // the warp's chunks worked on
  for (int gi = 0; gi < c.n_mine; ++gi) {
    const int b = blockIdx.x + gi * gridDim.x;
    float zb[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) zb[j] = j < t ? __ldg(zq + b * t + j) : 0.0f;

    for (int m = 0; m < c.my_nc; ++m, ++q) {
      // Chunk q is in, and chunk q - 1 is stored out: refill its stage
      // with chunk q + 1 while this one is worked on.
      cp_async_wait<0>();
      __syncwarp();
      stage_next_chunk<NW>(c, g, warp, copy);
      float* sx = ring + (q % kRing) * stage_floats;
      const float* sg = sx + kChunk * d;
      const int r0 = (warp + m * NW) * kChunk;
      const int rows = min(kChunk, g - r0);

      // Lane = item: the logits and the g_logit row.
      if (lane < rows) {
        float z[kS], gv[kS];
        row_logits<VEC, kS>(sx + lane * d, sw, d, t, z);
        float total = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          gv[j] = j < t ? sg[lane * t + j] : 0.0f;
          total += gv[j];
        }
        float cum = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j < t) {
            cum += gv[j];
            // gc * sigma(-logit)
            sl[lane * ts + j] =
                (total - cum + gv[j]) / (1.0f + expf(z[j] + zb[j]));
          }
        }
      }
      __syncwarp();

      // Lane = column k of the chunk's rows, item by item in order: the
      // chains (k < d: dw, k = d: dzq) and the dx row, written in place of
      // the item's x in column k.
      const float4* sl4 = reinterpret_cast<const float4*>(sl);
      for (int k = lane; k < n_col; k += 32) {
        float a[kS], wk[kS];
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          a[j] = j < t ? acc[j * n_col + k] : 0.0f;
          wk[j] = j < t && k < d ? sw[j * d + k] : 0.0f;
        }
#pragma unroll 2
        for (int i = 0; i < rows; ++i) {
          float gl[(kS + 3) / 4 * 4];
#pragma unroll
          for (int j4 = 0; j4 < (kS + 3) / 4; ++j4) {
            if (4 * j4 < t) {
              const float4 v4 = sl4[i * (ts / 4) + j4];
              gl[4 * j4] = v4.x, gl[4 * j4 + 1] = v4.y;
              gl[4 * j4 + 2] = v4.z, gl[4 * j4 + 3] = v4.w;
            }
          }
          float* cell = sx + i * d + k;
          const float xv = k < d ? *cell : 1.0f;
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            if (j < t) {
              a[j] = fmaf(gl[j], xv, a[j]);
              v = fmaf(gl[j], wk[j], v);
            }
          }
          if (k < d) *cell = v;
        }
#pragma unroll
        for (int j = 0; j < kS; ++j)
          if (j < t) acc[j * n_col + k] = a[j];
      }
      __syncwarp();
      store_run<VEC>(dx + ((long long)b * g + r0) * d, sx, rows * d, lane);
    }

    // Group b's end: each warp's dzq chains (zero for a warp with no chunk
    // in it) are added in warp order.
    float* pw = part + ((gi & 1) * NW + warp) * t;
    for (int e = lane; e < t; e += 32) {
      pw[e] = acc[e * n_col + d];
      acc[e * n_col + d] = 0.0f;
    }
    __syncthreads();
    const float* pg = part + (gi & 1) * NW * t;
    for (int e = threadIdx.x; e < t; e += blockDim.x) {
      float sum = pg[e];
      for (int wp = 1; wp < NW; ++wp) sum += pg[wp * t + e];
      dzq[b * t + e] = sum;
    }
  }
  cp_async_wait_all();

  // The block's dw partial: its warps' chains added in warp order.
  __syncthreads();
  const float* acc0 = smem + shared_floats(d, t, NW) + kRing * stage_floats +
                      kChunk * ts;
  for (int e = threadIdx.x; e < t * d; e += blockDim.x) {
    const int j = e / d, k = e - j * d;
    float sum = acc0[j * n_col + k];
    for (int wp = 1; wp < NW; ++wp) sum += acc0[wp * wfloats + j * n_col + k];
    dw_part[(long long)e * gridDim.x + blockIdx.x] = sum;
  }
}

template <bool VEC, int NW, int TS>
int launch(const float* x, const float* w, const float* zq, const float* gct,
           float* dx, float* dw, float* dzq, float* dw_part, int b, int g,
           int d, int t, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(d, t, NW);
  cudaError_t e = allow_smem(cascade_score_bwd_kernel<VEC, NW, TS>, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per group
  const int blocks =
      one_wave_blocks(cascade_score_bwd_kernel<VEC, NW, TS>, 32 * NW, smem, b);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cascade_score_bwd_kernel<VEC, NW, TS><<<blocks, 32 * NW, smem, s>>>(
      x, w, zq, gct, dx, dw_part, dzq, b, g, d, t);
  launch_ordered_sum(dw_part, dw, t * d, blocks, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t cascade_score_bwd_smem(int d, int t) {
  return sizeof(float) * smem_floats(d, t, score_bwd_warps(d, t));
}

// dw_part is scratch of t * d * b floats (one partial per block is used,
// at most one block per group). Returns cudaGetLastError() after both
// launches (0 = launched).
int cascade_score_batched_bwd(const float* x, const float* w,
                              const float* zq, const float* gct, float* dx,
                              float* dw, float* dzq, float* dw_part, int b,
                              int g, int d, int t, void* stream) {
  const bool vec =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // an instance for CLOES's T = 3, and one for any T
  const bool four = score_bwd_warps(d, t) == kWarps;
  auto run = four && t == 3
                 ? (vec ? launch<true, kWarps, 3> : launch<false, kWarps, 3>)
             : four ? (vec ? launch<true, kWarps, 0> : launch<false, kWarps, 0>)
                    : (vec ? launch<true, 1, 0> : launch<false, 1, 0>);
  return run(x, w, zq, gct, dx, dw, dzq, dw_part, b, g, d, t,
             (cudaStream_t)stream);
}

}  // extern "C"
