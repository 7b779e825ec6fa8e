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
// f32 in, f32 out, f32 accumulation; T <= 8, any d whose one warp's ring
// fits in shared memory (K4 d <= 863 at T = 3, K5 d <= 716 at T = 8).
//
// What bounds them on this card: bytes. K4 reads d + 4 floats per item for
// ~2*d*T flops plus a few transcendentals per stage; K5 also writes d + 4
// floats per item for ~6*d*T flops: 1-3 flops per byte at d = 24, T = 3.
//
// K4's and K5's designs share one map and one ring (warp_ring.cuh, also
// K3's): persistent blocks of kWarps = 4 warps (one warp at a d too wide
// for four warps' rings: `fwd_warps`, `bwd_warps`), one full wave of the
// card; block k takes the groups k, k + grid, ..., and its warp w the
// chunks w, w + kWarps, ... of 32 rows of each group, streamed through the
// warp's own two-stage cp.async ring (16-byte copies when d % 4 == 0 and xc
// is 16-byte aligned, else 4-byte copies: the scalar path, any d),
// prefetching across group boundaries; only __syncwarp orders a warp's
// stages, and the block meets once per group. Per chunk, lane = item
// recomputes the item's logits and cumulative log pass-probabilities from
// its packed row (float4 reads on the vector path).
//
// K4 replaces its first design (one block of 128 threads per group, each
// 128-row tile loaded, waited on, summed and stored in turn, an integer
// divide per float, and one thread per output walking a tile's 128 items
// while 121 of 128 threads idled: 26.8% of its bound at 4096 x 256). Lane
// = item forms its 1 + 2T terms and adds them to chains the lane holds in
// registers; nothing is staged or walked:
//   * ll and cnt_pp are per group: each lane's chain over its warp's chunks
//     of the group (its item of each, in chunk order), the 32 lanes' chains
//     added in a butterfly (`warp_sum`) at the group's end, and the warps'
//     sums in warp order after the block's one barrier per group;
//   * cost_pp is over the whole grid: each lane's chain over all its items
//     of all the block's groups, a butterfly at the end, the warps' sums in
//     warp order into one partial per block, and `ordered_sum_kernel` adds
//     the blocks' partials in block order.
//
// K5: lane = item also forms both logit-gradient streams into shared
// memory; then lane = column k walks the chunk's items in order: T chains a
// lane into the sums (k < d: dw, k = d: dzq, k = d + 1: dzq_pen, a column
// of ones) and the dxc row formed in place of the item (exact zeros on the
// four data lanes); the warp stores the chunk as one contiguous run, float4
// where aligned. dzq and dzq_pen are, per group, each warp's chain over its
// chunks' items in order, the warps' chains added in warp order at the
// group's end; dw is each warp's chain over all its items, the warps'
// chains added in warp order into one partial per block, and
// `ordered_sum_kernel` adds the blocks' partials in block order. K4's first
// layout (above) would have left K5 waiting.
//
// Both: sums in a fixed order, without float atomics. The warps and blocks
// depend only on (d, T) and the card, so the same inputs on the same card
// give the same bits (tests/test_torch_losses.py holds plain copies of both
// orders to the reference). Two instances of each path with four warps: one
// for T = 3 (CLOES's cascade, the main path), whose stage loops have three
// steps at compile time, and one for any T <= 8, whose loops run to 8 behind
// a test of j < T. The per-item arrays of 8 held ~128 registers with spills
// in K5 and left the warps waiting on instructions; at T = 3 its instance
// needs ~56-72 registers (on the H100 it takes ~44% less time at 4096 x
// 256). Both instances take the same sums in the same order.
// Padded items carry mask = wgt = cost_w = 0 and add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ordered_sum.cuh"
#include "warp_ring.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kDataCols = 4;           // y, mask, wgt, cost_w
constexpr float kLogPClamp = -1e-7f;   // the NLL's clamp on log p

// An item's logits (zq included) and cumulative log pass-probabilities from
// its packed row xr; lp[j] for j >= t repeats lp[t - 1], so lp[kS - 1] is
// the last stage's. Also its four data columns, on the vector path the
// row's float4 d / 4 (read as xr + d, K5 took 3% longer on the H100).
template <bool VEC, int kS>
__device__ __forceinline__ void item_scores(const float* xr, const float* sw,
                                            const float (&zb)[kS], int d,
                                            int t, float (&z)[kS],
                                            float (&lp)[kS], float4& data) {
  row_logits<VEC, kS>(xr, sw, d, t, z);
  data = VEC ? reinterpret_cast<const float4*>(xr)[d / 4]
             : make_float4(xr[d], xr[d + 1], xr[d + 2], xr[d + 3]);
  float cum = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (j < t) {
      z[j] += zb[j];
      cum += log_sigmoid(z[j]);
    }
    lp[j] = cum;
  }
}

// ---------------------------------------------------------------------------
// K4: forward partials.
// ---------------------------------------------------------------------------

// Floats of one warp's shared memory: its ring of kRing (kChunk, dc) stages.
__host__ __device__ __forceinline__ int fwd_warp_floats(int d) {
  return kRing * kChunk * (d + kDataCols);
}

// Floats before the warps' memory: w_eff, the nw warps' per-group ll and
// cnt_pp sums, double-buffered by group parity, and their cost_pp sums.
__host__ __device__ __forceinline__ int fwd_shared_floats(int d, int t,
                                                          int nw) {
  return round4(t * d) + round4(2 * nw * (1 + t)) + round4(nw * t);
}

__host__ __device__ __forceinline__ size_t fwd_smem_floats(int d, int t,
                                                           int nw) {
  return (size_t)fwd_shared_floats(d, t, nw) + (size_t)nw * fwd_warp_floats(d);
}

// Warps per K4 block: kWarps up to d = 220 at T = 3 (215 at T = 8), then
// one, whose ring fits up to d = 863 at T = 3 (803 at T = 8): wider than
// its first design took (431, 406).
int fwd_warps(int d, int t) { return ring_warps(fwd_smem_floats(d, t, kWarps)); }

template <bool VEC, int NW, int TS>
__global__ void __launch_bounds__(32 * NW)
cascade_loss_kernel(const float* __restrict__ xc, const float* __restrict__ w,
                    const float* __restrict__ zq, float* __restrict__ ll,
                    float* __restrict__ cnt, float* __restrict__ cost_part,
                    int n_groups, int g, int d, int t) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  const int dc = d + kDataCols;
  const int nv = 1 + t;                // per group: ll, cnt_pp (t)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sw = smem;                                        // (t, d)
  float* part = smem + round4(t * d);                      // (2, NW, nv)
  float* cpart = part + round4(2 * NW * nv);               // (NW, t)
  float* ring = smem + fwd_shared_floats(d, t, NW) +
                warp * fwd_warp_floats(d);                 // (kRing, 32, dc)
  const int chunk_floats = kChunk * dc;

  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  __syncthreads();                     // sw is shared by the warps

  ChunkWalk c = chunk_walk<NW>(n_groups, g, warp);
  auto copy = [&](int stage, int ib, int r0, int rows) {
    copy_run<VEC>(ring + stage * chunk_floats, xc + ((long long)ib * g + r0) * dc,
                  rows * dc, lane);
  };
  stage_next_chunk<NW>(c, g, warp, copy);

  float cost[kS];                      // the lane's cost_pp chains
#pragma unroll
  for (int j = 0; j < kS; ++j) cost[j] = 0.0f;

  int q = 0;                           // the warp's chunks worked on
  for (int gi = 0; gi < c.n_mine; ++gi) {
    const int b = blockIdx.x + gi * gridDim.x;
    float zb[kS], s_cnt[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      zb[j] = j < t ? __ldg(zq + b * t + j) : 0.0f;
      s_cnt[j] = 0.0f;
    }
    float s_ll = 0.0f;

    for (int m = 0; m < c.my_nc; ++m, ++q) {
      // Chunk q is in, and chunk q - 1 is read: refill its stage with
      // chunk q + 1 while this one is worked on.
      cp_async_wait<0>();
      __syncwarp();
      stage_next_chunk<NW>(c, g, warp, copy);
      const int rows = min(kChunk, g - (warp + m * NW) * kChunk);
      // Lane = item: its terms, added to the lane's chains.
      if (lane < rows) {
        float z[kS], lp[kS];
        float4 data;                   // y, mask, wgt, cost_w
        item_scores<VEC, kS>(ring + (q % kRing) * chunk_floats + lane * dc,
                             sw, zb, d, t, z, lp, data);
        const float y = data.x, mask = data.y, wgt = data.z,
                    cost_w = data.w;
        const float lpc = fminf(lp[kS - 1], kLogPClamp);
        s_ll += (wgt * mask) * (y * lpc + (1.0f - y) * log1pf(-expf(lpc)));
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j < t) {
            const float pp = expf(lp[j]);
            cost[j] += pp * cost_w;
            s_cnt[j] += pp * mask;
          }
        }
      }
    }

    // Group b's end: the lanes' chains meet in a butterfly, and the warps'
    // sums (zero for a warp with no chunk in it) are added in warp order.
    s_ll = warp_sum(s_ll);
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (j < t) s_cnt[j] = warp_sum(s_cnt[j]);
    float* pw = part + ((gi & 1) * NW + warp) * nv;
    if (lane == 0) {
      pw[0] = s_ll;
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < t) pw[1 + j] = s_cnt[j];
    }
    __syncthreads();
    const float* pg = part + (gi & 1) * NW * nv;
    for (int e = threadIdx.x; e < nv; e += blockDim.x) {
      float sum = pg[e];
      for (int wp = 1; wp < NW; ++wp) sum += pg[wp * nv + e];
      if (e == 0)
        ll[b] = sum;
      else
        cnt[b * t + e - 1] = sum;
    }
  }
  cp_async_wait_all();

  // The block's cost_pp partial: the lanes' chains in a butterfly, the
  // warps' sums added in warp order.
#pragma unroll
  for (int j = 0; j < kS; ++j)
    if (j < t) cost[j] = warp_sum(cost[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (j < t) cpart[warp * t + j] = cost[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t; e += blockDim.x) {
    float sum = cpart[e];
    for (int wp = 1; wp < NW; ++wp) sum += cpart[wp * t + e];
    cost_part[(long long)e * gridDim.x + blockIdx.x] = sum;
  }
}

template <bool VEC, int NW, int TS>
int launch_fwd(const float* xc, const float* w, const float* zq, float* ll,
               float* cost_pp, float* cnt_pp, float* cost_part, int b, int g,
               int d, int t, cudaStream_t s) {
  const size_t smem = sizeof(float) * fwd_smem_floats(d, t, NW);
  cudaError_t e = allow_smem(cascade_loss_kernel<VEC, NW, TS>, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per group
  const int blocks =
      one_wave_blocks(cascade_loss_kernel<VEC, NW, TS>, 32 * NW, smem, b);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cascade_loss_kernel<VEC, NW, TS><<<blocks, 32 * NW, smem, s>>>(
      xc, w, zq, ll, cnt_pp, cost_part, b, g, d, t);
  launch_ordered_sum(cost_part, cost_pp, t, blocks, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: backward, one recompute pass fusing the three cotangent streams.
// ---------------------------------------------------------------------------

// Floats of one warp's shared memory: its ring of kRing (kChunk, dc)
// stages, the two logit-gradient streams (kChunk, round4(t)) each, and its
// T * (d + 2) chains.
__host__ __device__ __forceinline__ int bwd_warp_floats(int d, int t) {
  return kRing * kChunk * (d + kDataCols) + 2 * kChunk * round4(t) +
         round4(t * (d + 2));
}

// Floats before the warps' memory: w_eff, and the nw warps' per-group dzq
// and dzq_pen partials, double-buffered by group parity.
__host__ __device__ __forceinline__ int bwd_shared_floats(int d, int t,
                                                          int nw) {
  return round4(t * d) + round4(2 * nw * 2 * t);
}

__host__ __device__ __forceinline__ size_t bwd_smem_floats(int d, int t,
                                                           int nw) {
  return (size_t)bwd_shared_floats(d, t, nw) +
         (size_t)nw * bwd_warp_floats(d, t);
}

// Warps per K5 block: kWarps where their rings fit in a block's shared
// memory, else one (d > 185 at T = 8, d > 214 at T = 1), whose ring fits up
// to d = 716 at T = 8 (872 at T = 1).
int bwd_warps(int d, int t) { return ring_warps(bwd_smem_floats(d, t, kWarps)); }

template <bool VEC, int NW, int TS>
__global__ void __launch_bounds__(32 * NW)
cascade_loss_bwd_kernel(const float* __restrict__ xc,
                        const float* __restrict__ w,
                        const float* __restrict__ zq,
                        const float* __restrict__ g_ll,
                        const float* __restrict__ g_cost,
                        const float* __restrict__ g_cnt,
                        float* __restrict__ dxc, float* __restrict__ dw_part,
                        float* __restrict__ dzq, float* __restrict__ dzq_pen,
                        int n_groups, int g, int d, int t) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  const int dc = d + kDataCols;
  const int ts = round4(t);            // row stride of the gradient streams
  const int n_col = d + 2;             // dw columns, then dzq, dzq_pen
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wfloats = bwd_warp_floats(d, t);
  float* sw = smem;                                        // (t, d)
  float* part = smem + round4(t * d);                      // (2, NW, 2t)
  float* base = smem + bwd_shared_floats(d, t, NW) + warp * wfloats;
  float* ring_buf = base;                                  // (kRing, 32, dc)
  float* sm = base + kRing * kChunk * dc;                  // (32, ts) main
  float* sp = sm + kChunk * ts;                            // (32, ts) pen
  float* acc = sp + kChunk * ts;                           // (t, n_col)
  const int chunk_floats = kChunk * dc;

  for (int i = threadIdx.x; i < t * d; i += blockDim.x) sw[i] = w[i];
  for (int i = lane; i < t * n_col; i += 32) acc[i] = 0.0f;
  __syncthreads();                     // sw is shared by the warps

  ChunkWalk c = chunk_walk<NW>(n_groups, g, warp);
  auto copy = [&](int stage, int ib, int r0, int rows) {
    copy_run<VEC>(ring_buf + stage * chunk_floats,
                  xc + ((long long)ib * g + r0) * dc, rows * dc, lane);
  };
  stage_next_chunk<NW>(c, g, warp, copy);

  float gcost[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) gcost[j] = j < t ? g_cost[j] : 0.0f;

  int q = 0;                           // the warp's chunks worked on
  for (int gi = 0; gi < c.n_mine; ++gi) {
    const int b = blockIdx.x + gi * gridDim.x;
    float zb[kS], gcnt[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      zb[j] = j < t ? __ldg(zq + b * t + j) : 0.0f;
      gcnt[j] = j < t ? __ldg(g_cnt + b * t + j) : 0.0f;
    }
    const float gll = __ldg(g_ll + b);

    for (int m = 0; m < c.my_nc; ++m, ++q) {
      // Chunk q is in, and chunk q - 1 is stored out: refill its stage
      // with chunk q + 1 while this one is worked on.
      cp_async_wait<0>();
      __syncwarp();
      stage_next_chunk<NW>(c, g, warp, copy);
      float* sx = ring_buf + (q % kRing) * chunk_floats;
      const int r0 = (warp + m * NW) * kChunk;
      const int rows = min(kChunk, g - r0);

      // Lane = item: the logits and the two logit-gradient streams.
      if (lane < rows) {
        float z[kS], lp[kS];
        float4 data;                   // y, mask, wgt, cost_w
        item_scores<VEC, kS>(sx + lane * dc, sw, zb, d, t, z, lp, data);
        const float y = data.x, mask = data.y, wgt = data.z,
                    cost_w = data.w;
        const float lpl = lp[kS - 1];
        const float ppc = expf(fminf(lpl, kLogPClamp));
        const float dll =
            (wgt * mask) * (y - (1.0f - y) * ppc / (1.0f - ppc));
        // the clamp passes the tangent where lp <= clamp, ties included
        const float g_nll = lpl <= kLogPClamp ? gll * dll : 0.0f;
        float gm[kS], gp[kS];
        float tot_m = 0.0f, tot_p = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
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
        for (int j = 0; j < kS; ++j) {
          if (j < t) {
            cm += gm[j];
            cp += gp[j];
            const float sig = 1.0f / (1.0f + expf(z[j]));   // sigma(-logit)
            sm[lane * ts + j] = (tot_m - cm + gm[j]) * sig;
            sp[lane * ts + j] = (tot_p - cp + gp[j]) * sig;
          }
        }
      }
      __syncwarp();
      // Lane = column k of the chunk's rows, item by item in order: the
      // chains (k < d: dw, k = d: dzq, k = d + 1: dzq_pen; T a lane; the
      // last two multiply by 1, and fmaf(v, 1, a) is a + v exactly, so
      // every lane runs the same instructions) and the dxc row, written in
      // place of the item's column k (exact zeros on the four data lanes).
      const float4* sm4 = reinterpret_cast<const float4*>(sm);
      const float4* sp4 = reinterpret_cast<const float4*>(sp);
      for (int k = lane; k < dc; k += 32) {
        const bool pen = k == d + 1;
        float a[kS], wk[kS];
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          a[j] = j < t && k < n_col ? acc[j * n_col + k] : 0.0f;
          wk[j] = j < t && k < d ? sw[j * d + k] : 0.0f;
        }
#pragma unroll 2
        for (int i = 0; i < rows; ++i) {
          float gm[(kS + 3) / 4 * 4], gp[(kS + 3) / 4 * 4];
#pragma unroll
          for (int j4 = 0; j4 < (kS + 3) / 4; ++j4) {
            if (4 * j4 < t) {
              const float4 mv = sm4[i * (ts / 4) + j4];
              const float4 pv = sp4[i * (ts / 4) + j4];
              gm[4 * j4] = mv.x, gm[4 * j4 + 1] = mv.y;
              gm[4 * j4 + 2] = mv.z, gm[4 * j4 + 3] = mv.w;
              gp[4 * j4] = pv.x, gp[4 * j4 + 1] = pv.y;
              gp[4 * j4 + 2] = pv.z, gp[4 * j4 + 3] = pv.w;
            }
          }
          float* cell = sx + i * dc + k;
          const float xv = k < d ? *cell : 1.0f;
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            if (j < t) {
              a[j] = fmaf(pen ? gp[j] : gm[j], xv, a[j]);
              v = fmaf(gm[j] + gp[j], wk[j], v);
            }
          }
          *cell = k < d ? v : 0.0f;
        }
        if (k < n_col) {
#pragma unroll
          for (int j = 0; j < kS; ++j)
            if (j < t) acc[j * n_col + k] = a[j];
        }
      }
      __syncwarp();
      store_run<VEC>(dxc + ((long long)b * g + r0) * dc, sx, rows * dc, lane);
    }

    // Group b's end: each warp's dzq and dzq_pen chains (zero for a warp
    // with no chunk in it) are added in warp order.
    float* pw = part + ((gi & 1) * NW + warp) * 2 * t;
    for (int e = lane; e < 2 * t; e += 32) {
      const int col = d + e / t, j = e % t;
      pw[e] = acc[j * n_col + col];
      acc[j * n_col + col] = 0.0f;
    }
    __syncthreads();
    const float* pg = part + (gi & 1) * NW * 2 * t;
    for (int e = threadIdx.x; e < 2 * t; e += blockDim.x) {
      float sum = pg[e];
      for (int wp = 1; wp < NW; ++wp) sum += pg[wp * 2 * t + e];
      (e < t ? dzq : dzq_pen)[b * t + e % t] = sum;
    }
  }
  cp_async_wait_all();

  // The block's dw partial: its warps' chains added in warp order.
  __syncthreads();
  const float* acc0 = smem + bwd_shared_floats(d, t, NW) +
                      kRing * kChunk * dc + 2 * kChunk * ts;
  for (int e = threadIdx.x; e < t * d; e += blockDim.x) {
    const int j = e / d, k = e - j * d;
    float sum = acc0[j * n_col + k];
    for (int wp = 1; wp < NW; ++wp)
      sum += acc0[wp * wfloats + j * n_col + k];
    dw_part[(long long)e * gridDim.x + blockIdx.x] = sum;
  }
}

template <bool VEC, int NW, int TS>
int launch_bwd(const float* xc, const float* w, const float* zq,
               const float* g_ll, const float* g_cost, const float* g_cnt,
               float* dxc, float* dw, float* dzq, float* dzq_pen,
               float* dw_part, int b, int g, int d, int t,
               cudaStream_t s) {
  const size_t smem = sizeof(float) * bwd_smem_floats(d, t, NW);
  cudaError_t e = allow_smem(cascade_loss_bwd_kernel<VEC, NW, TS>, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per group
  const int blocks =
      one_wave_blocks(cascade_loss_bwd_kernel<VEC, NW, TS>, 32 * NW, smem, b);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cascade_loss_bwd_kernel<VEC, NW, TS><<<blocks, 32 * NW, smem, s>>>(
      xc, w, zq, g_ll, g_cost, g_cnt, dxc, dw_part, dzq, dzq_pen, b, g, d, t);
  launch_ordered_sum(dw_part, dw, t * d, blocks, s);
  return (int)cudaGetLastError();
}

// 16-byte copies where the packed rows' width and xc's base allow them.
bool packed_vec(const float* xc, int d) {
  return (d + kDataCols) % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(xc) & 15) == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch; the wrappers refuse shapes above the
// card's per-block limit before launching.
size_t cascade_loss_smem(int d, int t) {
  return sizeof(float) * fwd_smem_floats(d, t, fwd_warps(d, t));
}

size_t cascade_loss_bwd_smem(int d, int t) {
  return sizeof(float) * bwd_smem_floats(d, t, bwd_warps(d, t));
}

// cost_part is scratch of t * b floats (one partial per block is used, at
// most one block per group). Returns cudaGetLastError() after both
// launches (0 = launched).
int cascade_loss(const float* xc, const float* w, const float* zq, float* ll,
                 float* cost_pp, float* cnt_pp, float* cost_part, int b,
                 int g, int d, int t, void* stream) {
  const bool vec = packed_vec(xc, d);
  // an instance for CLOES's T = 3, and one for any T
  const bool four = fwd_warps(d, t) == kWarps;
  auto run = four && t == 3
                 ? (vec ? launch_fwd<true, kWarps, 3>
                        : launch_fwd<false, kWarps, 3>)
             : four ? (vec ? launch_fwd<true, kWarps, 0>
                           : launch_fwd<false, kWarps, 0>)
                    : (vec ? launch_fwd<true, 1, 0> : launch_fwd<false, 1, 0>);
  return run(xc, w, zq, ll, cost_pp, cnt_pp, cost_part, b, g, d, t,
             (cudaStream_t)stream);
}

// dw_part is scratch of t * d * b floats (one partial per block is used,
// at most one block per group). Returns cudaGetLastError() after both
// launches (0 = launched).
int cascade_loss_bwd(const float* xc, const float* w, const float* zq,
                     const float* g_ll, const float* g_cost,
                     const float* g_cnt, float* dxc, float* dw, float* dzq,
                     float* dzq_pen, float* dw_part, int b, int g, int d,
                     int t, void* stream) {
  const bool vec = packed_vec(xc, d);
  // an instance for CLOES's T = 3, and one for any T
  const bool four = bwd_warps(d, t) == kWarps;
  auto run = four && t == 3
                 ? (vec ? launch_bwd<true, kWarps, 3>
                        : launch_bwd<false, kWarps, 3>)
             : four ? (vec ? launch_bwd<true, kWarps, 0>
                           : launch_bwd<false, kWarps, 0>)
                    : (vec ? launch_bwd<true, 1, 0> : launch_bwd<false, 1, 0>);
  return run(xc, w, zq, g_ll, g_cost, g_cnt, dxc, dw, dzq, dzq_pen, dw_part,
             b, g, d, t, (cudaStream_t)stream);
}

}  // extern "C"
