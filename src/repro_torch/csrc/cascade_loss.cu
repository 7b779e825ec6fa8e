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
// K4's design (as K3, csrc/cascade_score_bwd.cu): one block per query
// group, walking the group in tiles of kRows items with one thread per
// item; the packed tile is read coalesced into shared memory (row stride
// d + 5) and the logits are recomputed from it. Each item leaves its terms
// in shared memory, one thread per output adds the tile's items in item
// order into its own accumulator; ll and cnt_pp are final when the block
// ends, cost_pp is a per-group partial that `ordered_sum_kernel`
// (ordered_sum.cuh) adds in group order.
//
// K5's design. K4's layout would leave K5 waiting: one thread per output
// walking all of a tile's items in one dependent chain while the other
// threads idle, several barriers a tile and no prefetch. Instead:
//   * persistent blocks of kWarps = 4 warps (one warp at a d too wide for
//     four warps' rings, see `bwd_warps`), one full wave of the card;
//     block k takes the groups k, k + grid, ... (a static map: no counter,
//     no atomics), and warp w of it the chunks w, w + kWarps, ... of 32
//     rows of each group, so a group's chunks are scored side by side;
//   * each warp streams its chunks through its own two-stage shared-memory
//     ring filled by cp.async (16-byte copies when d % 4 == 0 and xc is
//     16-byte aligned, else 4-byte copies: the scalar path, any d),
//     prefetching across group boundaries; only __syncwarp orders a warp's
//     stages, and the block meets once per group;
//   * per chunk, lane = item recomputes the item's logits (as K4 does) and
//     both logit-gradient streams into shared memory; then lane = column k
//     walks the chunk's items in order:
//     T chains a lane into the sums (k < d: dw, k = d: dzq, k = d + 1:
//     dzq_pen, a column of ones) and the dxc row formed in place of the
//     item (exact zeros on the four data lanes); the warp stores the chunk
//     as one contiguous run, float4 where aligned;
//   * sums in a fixed order, without float atomics: dzq and dzq_pen are, per
//     group, each warp's chain over its chunks' items in order, the warps'
//     chains added in warp order at the group's end (the block's one
//     barrier per group); dw is each warp's chain over all its items, the
//     warps' chains added in warp order into one partial per block, and
//     `ordered_sum_kernel` adds the blocks' partials in block order. The
//     warps and blocks depend only on (d, T) and the card, so the same
//     inputs on the same card give the same bits
//     (tests/test_torch_losses.py holds a plain copy of this order to the
//     reference).
//   * two instances of each path with four warps: one for T = 3 (CLOES's
//     cascade, the main path), whose stage loops have three steps at
//     compile time, and one for any T <= 8, whose loops run to 8 behind a
//     test of j < T. The per-item arrays of 8 held ~128 registers with
//     spills and left the warps waiting on instructions; at T = 3 the
//     instance needs ~56-72 registers (on the H100 it takes ~44% less time
//     at 4096 x 256). Both take the same sums in the same order.
// Padded items carry mask = wgt = cost_w = 0 and add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ordered_sum.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;             // K4: items per tile, one thread each
constexpr int kWarps = 4;              // K5: warps per block, where they fit
constexpr int kChunk = 32;             // K5: items per chunk, one lane each
constexpr int kRing = 2;               // K5: a warp's stages (one in flight)
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
// to d = 716 at T = 8 (872 at T = 1): wider than K3 and K4 take.
int bwd_warps(int d, int t) {
  return sizeof(float) * bwd_smem_floats(d, t, kWarps) <= kMaxSmemBytes
             ? kWarps
             : 1;
}

// Copy a warp's next chunk (group ib, chunk ic: rows ic * 32 ..) into its
// stage `issued % kRing` when it has one left, and step (ib, ic) on to the
// warp's following chunk: chunks ic, ic + NW, ... of each group, then
// the block's next group. 16-byte copies on the vector path, 4-byte ones on
// the scalar path. One commit group per call (empty when no chunk is left),
// so the waits count chunks.
template <bool VEC, int NW>
__device__ __forceinline__ void stage_next_chunk(
    float* ring_buf, const float* xc, int& issued, int& ib, int& ic,
    int n_chunks, int g, int dc, int nc, int warp, int lane) {
  if (issued < n_chunks) {
    const int r0 = ic * kChunk;
    const int n = min(kChunk, g - r0) * dc;
    const float* src = xc + ((long long)ib * g + r0) * dc;
    float* dst = ring_buf + (issued % kRing) * (kChunk * dc);
    if (VEC) {
      for (int e = lane; e < n / 4; e += 32)
        cp_async16(dst + 4 * e, src + 4 * e);
    } else {
      for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + e);
    }
    ++issued;
    ic += NW;
    if (ic >= nc) {
      ic = warp;
      ib += gridDim.x;
    }
  }
  cp_async_commit();
}

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

  // The block's groups blockIdx.x, + gridDim.x, ...; warp w takes chunks
  // w, w + NW, ... of each (of nc chunks of 32 rows): my_nc of them.
  const int nc = (g + kChunk - 1) / kChunk;
  const int my_nc = nc > warp ? (nc - 1 - warp) / NW + 1 : 0;
  const int n_mine = (int)blockIdx.x < n_groups
                         ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1
                         : 0;
  const int n_chunks = n_mine * my_nc;

  int issued = 0, ib = blockIdx.x, ic = warp;   // the next chunk to copy
  stage_next_chunk<VEC, NW>(ring_buf, xc, issued, ib, ic, n_chunks, g, dc, nc,
                        warp, lane);

  float gcost[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) gcost[j] = j < t ? g_cost[j] : 0.0f;

  int q = 0;                           // the warp's chunks worked on
  for (int gi = 0; gi < n_mine; ++gi) {
    const int b = blockIdx.x + gi * gridDim.x;
    float zb[kS], gcnt[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      zb[j] = j < t ? __ldg(zq + b * t + j) : 0.0f;
      gcnt[j] = j < t ? __ldg(g_cnt + b * t + j) : 0.0f;
    }
    const float gll = __ldg(g_ll + b);

    for (int m = 0; m < my_nc; ++m, ++q) {
      // Chunk q is in, and chunk q - 1 is stored out: refill its stage
      // with chunk q + 1 while this one is worked on.
      cp_async_wait<0>();
      __syncwarp();
      stage_next_chunk<VEC, NW>(ring_buf, xc, issued, ib, ic, n_chunks, g, dc,
                            nc, warp, lane);
      float* sx = ring_buf + (q % kRing) * chunk_floats;
      const int r0 = (warp + m * NW) * kChunk;
      const int rows = min(kChunk, g - r0);

      // Lane = item: the logits and the two logit-gradient streams.
      if (lane < rows) {
        const float* xr = sx + lane * dc;
        float z[kS], lp[kS];
#pragma unroll
        for (int j = 0; j < kS; ++j) z[j] = 0.0f;
        float y, mask, wgt, cost_w;
        if (VEC) {
          const float4* x4 = reinterpret_cast<const float4*>(xr);
          const float4* w4 = reinterpret_cast<const float4*>(sw);
          for (int k4 = 0; k4 < d / 4; ++k4) {
            const float4 a = x4[k4];
#pragma unroll
            for (int j = 0; j < kS; ++j) {
              if (j < t) {
                const float4 wv = w4[j * (d / 4) + k4];
                z[j] = fmaf(a.x, wv.x, z[j]);
                z[j] = fmaf(a.y, wv.y, z[j]);
                z[j] = fmaf(a.z, wv.z, z[j]);
                z[j] = fmaf(a.w, wv.w, z[j]);
              }
            }
          }
          const float4 dv = x4[d / 4];
          y = dv.x, mask = dv.y, wgt = dv.z, cost_w = dv.w;
        } else {
          for (int k = 0; k < d; ++k) {
            const float xv = xr[k];
#pragma unroll
            for (int j = 0; j < kS; ++j)
              if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
          }
          y = xr[d], mask = xr[d + 1], wgt = xr[d + 2], cost_w = xr[d + 3];
        }
        float cum = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j < t) {
            z[j] += zb[j];
            cum += log_sigmoid(z[j]);
          }
          lp[j] = cum;  // so lp[kS - 1] is the last stage's, lp[t-1]
        }
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
      const int n = rows * dc;
      float* dst = dxc + ((long long)b * g + r0) * dc;
      if (VEC) {
        for (int e = lane; e < n / 4; e += 32)
          reinterpret_cast<float4*>(dst)[e] =
              reinterpret_cast<const float4*>(sx)[e];
      } else {
        for (int e = lane; e < n; e += 32) dst[e] = sx[e];
      }
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
  return sizeof(float) * bwd_smem_floats(d, t, bwd_warps(d, t));
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

// dw_part is scratch of t * d * b floats (one partial per block is used,
// at most one block per group). Returns cudaGetLastError() after both
// launches (0 = launched).
int cascade_loss_bwd(const float* xc, const float* w, const float* zq,
                     const float* g_ll, const float* g_cost,
                     const float* g_cnt, float* dxc, float* dw, float* dzq,
                     float* dzq_pen, float* dw_part, int b, int g, int d,
                     int t, void* stream) {
  const bool vec = (d + kDataCols) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xc) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // an instance for CLOES's T = 3, and one for any T
  const bool four = bwd_warps(d, t) == kWarps;
  auto run = four && t == 3
                 ? (vec ? launch_bwd<true, kWarps, 3>
                        : launch_bwd<false, kWarps, 3>)
             : four ? (vec ? launch_bwd<true, kWarps, 0>
                           : launch_bwd<false, kWarps, 0>)
                    : (vec ? launch_bwd<true, 1, 0> : launch_bwd<false, 1, 0>);
  return run(xc, w, zq, g_ll, g_cost, g_cnt, dxc, dw, dzq, dzq_pen, dw_part,
             b, g, d, t, s);
}

}  // extern "C"
