// K2: fused cascade score + filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_filter` / `_kernel`
// (src/repro/kernels/cascade_filter/kernel.py:60-167). Per query group b:
//
//   lp[i, j]  = sum_{k <= j} log sigmoid(x[i] . w_eff[k] + zq[b, k])
//   counts[j] = (m_q / N_q) * sum_{i valid} exp(lp[i, j])             (Eq 10)
//   n_keep[j] = clip(ceil(counts[j] * N_q / max(m_q, 1)), 1, G)
//   surv_j    = surv_{j-1} * (rank_j < n_keep[j]), where over the group
//               (non-survivors scoring -inf) rank_j[i] = #{k : s_k > s_i}
//               + #{k < i : s_k == s_i}
//
// x (B, G, d), w_eff (T, d), zq (B, T), mask (B, G), m_q (B,) ->
// lp, survivors (B, G, T) as f32 0/1, expected_counts, n_keep (B, T).
// T <= 8, G <= 512, any d; f32 throughout.
//
// What bounds it on this card: bytes. A group reads G*d floats of x and
// writes 2*G*T; everything between the score and the survivors can stay on
// chip. The first design ranked each surviving item against all G items
// per stage: 399 M (item, survivor) pairs at B = 4096, G = 256, T = 3,
// several instructions each, far more time than the 0.039 ms in which the
// card streams x. The design:
//   * one thread per item (blockDim = G rounded up to a warp), and a grid of
//     the blocks that fit on the card at once, each walking the groups b =
//     blockIdx.x, + gridDim.x, ... The group's x tile (contiguous G*d
//     floats), mask, zq and m_q are copied to shared memory with cp.async
//     (16 bytes a copy for x) into one of two buffers, the next group's
//     while this one is scored and selected, so the stream of x does not
//     wait for the selection's barriers. Tiles that do not fit two buffers
//     (or d % 4 != 0, or an unaligned x) are read per group, in chunks of
//     columns where the tile would exceed 64 KB; the per-item fmaf order
//     over k is the same in every case, so lp keeps its bits;
//   * the per-stage sums for Eq 10 are the fixed-order tree red[k] +=
//     red[k + s], s = p/2 .. 1, taken by one warp per row (the levels
//     s >= 32 in registers, then shuffles: one barrier instead of log2 p),
//     and thread j forms stage j's count and n_keep in the reference's
//     operation order ((m_q / N_q) * sum, then ceil(counts * N_q /
//     max(m_q, 1))), so counts and n_keep are the same from run to run;
//   * the stable top-n_keep is an exact threshold select, not a rank per
//     item: with v* the n_keep-th largest score of the group and c_gt =
//     #{s > v*}, item i stays iff s_i > v*, or s_i == v* and #{k < i :
//     s_k == v*} < n_keep - c_gt. This is the same set as rank < n_keep:
//     the items above v* are fewer than n_keep and all rank below it; an
//     item below v* has at least n_keep items at or above it; and an item
//     at v* has rank c_gt + #{k < i : s_k == v*}. v* is found on an
//     order-preserving uint32 key of the float (-0.0 taken as +0.0, which
//     compare equal) one 8-bit digit a round from the top: a histogram of
//     integer counts (one atomic per warp and digit; the order of integer
//     additions does not change their sum), one barrier, and every warp
//     reads the same digit off it. The select ends at the first round
//     whose digit bin holds exactly the items still needed (all of them
//     stay and no tie is cut) — on scores that are not tied, after one or
//     two rounds. The tie prefix, where still needed, is a ballot scan in
//     index order. Scores that are NaN never compare, so they neither
//     count nor drop (as in the rank). When n_keep covers every survivor
//     the stage keeps them all without a search;
//   * lp and the survivors are staged in shared memory and written once
//     per group as coalesced 16-byte vectors.
// Rows at or past G (the warp round-up) take no part; rows with mask 0
// score -inf and never survive.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxGroup = 512;
constexpr int kMaxWarps = kMaxGroup / 32;
constexpr int kTileFloats = 16384;   // x chunk + w chunk: 64 KB
constexpr int kBins = 256;           // radix-select digit: 8 bits

__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

// Order-preserving key: a > b (floats, not NaN) iff key(a) > key(b).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Row stride (floats) of a staged x chunk of dc columns, chosen so that
// the item-per-thread reads hit no bank twice: for dc % 4 == 0 (rows read
// as 16-byte vectors) an odd number of vectors, else an odd number of
// floats.
__host__ __device__ __forceinline__ int x_stride(int dc) {
  return dc % 4 == 0 ? 4 * ((dc / 4) | 1) : (dc | 1);
}

// Columns of x staged at once: all of d where the chunk fits kTileFloats,
// else the most dc with g * (dc + 4) + t * dc <= kTileFloats (>= 27 at
// g <= 512, t <= 8).
__host__ __device__ __forceinline__ int chunk_cols(int g, int d, int t) {
  if (g * x_stride(d) + t * d <= kTileFloats) return d;
  return (kTileFloats - 4 * g) / (g + t);
}

// One count per distinct digit of the warp (the lanes that share it sum
// theirs first): the top digits of a group's keys are mostly equal, and
// one atomic per lane on one address would serialise.
__device__ __forceinline__ void count_digit(int* hist, bool in,
                                            unsigned digit, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, in ? digit : ~0u);
  if (in && __ffs(peers) - 1 == lane) atomicAdd(hist + digit, __popc(peers));
}

__host__ __device__ __forceinline__ int width(int threads) {
  int p = 1;
  while (p < threads) p <<= 1;
  return p;
}

// The whole (g, d) tile read as 16-byte copies, double-buffered: each
// buffer holds a group's tile, then (red, lp, surv) of that group. The
// tile's rows are unpadded (stride d): the item-per-thread reads of 16
// bytes then meet at most 2-way bank conflicts at d % 8 == 0.
constexpr int kVecFloats = 40960;    // both buffers + w: 160 KB

__host__ __device__ __forceinline__ int after_floats(int g, int t, int p) {
  return (t + 1) * p + 2 * g * t;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of one buffer: the x tile (or chunk), then (red, lp, surv); with
// `vec` the group's mask, zq and m_q after them (copied with the tile).
__host__ __device__ __forceinline__ int buffer_floats(int g, int d, int t,
                                                      int p, bool vec) {
  const int x = vec ? g * d : g * x_stride(chunk_cols(g, d, t));
  const int after = after_floats(g, t, p);
  return round4(x > after ? x : after) + (vec ? round4(g + t + 1) : 0);
}

__host__ __device__ __forceinline__ bool vec_fits(int g, int d, int t,
                                                  int p) {
  return d % 4 == 0 && 2 * buffer_floats(g, d, t, p, true) + t * d <=
                           kVecFloats;
}

__host__ __device__ __forceinline__ size_t smem_floats(int g, int d, int t,
                                                       int p, bool vec) {
  return vec ? 2 * (size_t)buffer_floats(g, d, t, p, true) + (size_t)t * d
             : (size_t)buffer_floats(g, d, t, p, false) +
                   (size_t)t * chunk_cols(g, d, t);
}

// Issue the copies of group b's (g, d) tile into `buf`, and of its mask,
// zq and m_q into `aux` (vec layout).
__device__ __forceinline__ void prefetch(float* buf, float* aux,
                                         const float* x, const float* mask,
                                         const float* zq, const float* mq,
                                         int b, int g, int d, int t, int i,
                                         int nthreads) {
  const float* xg = x + (long long)b * g * d;
  for (int c = i; c < g * d / 4; c += nthreads)
    cp_async16(buf + 4 * c, xg + 4 * c);
  for (int c = i; c < g + t + 1; c += nthreads) {
    const float* src = c < g ? mask + (long long)b * g + c
                       : c < g + t ? zq + (long long)b * t + (c - g)
                                   : mq + b;
    cp_async4(aux + c, src);
  }
}

// p: the reduction width, the power of two >= blockDim. A block walks the
// groups b = blockIdx.x, + gridDim.x, ... (gridDim.x = the blocks that fit
// on the card at once). With `vec` the next group's tile is in flight
// while this one is scored and selected.
__global__ void __launch_bounds__(kMaxGroup, 2)
cascade_filter_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ zq,
                      const float* __restrict__ mask,
                      const float* __restrict__ mq,
                      float* __restrict__ lp_out,
                      float* __restrict__ surv_out,
                      float* __restrict__ counts_out,
                      float* __restrict__ nkeep_out, int n_groups, int g,
                      int d, int t, int p, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int dc = vec ? d : chunk_cols(g, d, t);
  const int stride = vec ? d : x_stride(dc);
  const int nbuf = buffer_floats(g, d, t, p, vec);
  const int naux = vec ? round4(g + t + 1) : 0;   // at the buffer's end
  float* sw = smem + (vec ? 2 : 1) * nbuf;        // (t, dc) w's chunk
  __shared__ float s_sum[kMaxStages + 1];
  __shared__ float s_nkeep[kMaxStages];
  __shared__ __align__(16) int s_hist[3][kBins];
  __shared__ int s_alive[2][2][kMaxWarps];
  __shared__ int s_eq[kMaxWarps];
  __shared__ int s_pick[2][4];       // a round's digit, skipped, bin, hit

  const int i = threadIdx.x, nthreads = blockDim.x;
  const int lane = i & 31, warp = i >> 5, nwarps = nthreads >> 5;
  const bool real = i < g;
  const unsigned full = 0xffffffffu, lt_mask = (1u << lane) - 1u;

  for (int k = i; k < 2 * kBins; k += nthreads) s_hist[k / kBins][k % kBins] = 0;
  if (vec) {
    for (int e = i; e < t * d; e += nthreads) sw[e] = w[e];
    for (int q = 0; q < 2; ++q) {
      const int bq = blockIdx.x + q * gridDim.x;
      float* bufq = smem + q * nbuf;
      if (bq < n_groups)
        prefetch(bufq, bufq + nbuf - naux, x, mask, zq, mq, bq, g, d, t, i,
                 nthreads);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  int round = 0;     // histograms used so far (s_hist[round % 3] is next)
  int it = 0;
  for (int b = blockIdx.x; b < n_groups; b += gridDim.x, ++it) {
    float* buf = smem + (vec ? (it & 1) * nbuf : 0);
    float* xs = buf;                   // (g, stride) the tile or chunk of x
    float* red = buf;                  // after the scores: (t + 1, p) sums,
    float* lps = red + (t + 1) * p;    // (g, t) lp and
    float* svs = lps + g * t;          // (g, t) survivors, staged for output
    const float* aux = buf + nbuf - naux;   // vec: mask (g), zq (t), m_q
    const long long item = (long long)b * g + i;
    const float* xg = x + (long long)b * g * d;

    // Scores: x . w_eff[j] per item, over x's columns in order.
    float lp[kMaxStages];
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j) lp[j] = 0.0f;
    if (vec) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      if (real) {
        const float4* xr = reinterpret_cast<const float4*>(xs + i * stride);
        const float4* w4 = reinterpret_cast<const float4*>(sw);
        for (int c4 = 0; c4 < d / 4; ++c4) {
          const float4 a = xr[c4];
#pragma unroll
          for (int j = 0; j < kMaxStages; ++j) {
            if (j < t) {
              const float4 wv = w4[j * (d / 4) + c4];
              lp[j] = fmaf(a.x, wv.x, lp[j]);
              lp[j] = fmaf(a.y, wv.y, lp[j]);
              lp[j] = fmaf(a.z, wv.z, lp[j]);
              lp[j] = fmaf(a.w, wv.w, lp[j]);
            }
          }
        }
      }
    } else {
      for (int k0 = 0; k0 < d; k0 += dc) {
        const int cols = min(dc, d - k0);
        if (k0 > 0) __syncthreads();   // every item is done with the chunk
        for (int e = i; e < t * cols; e += nthreads) {
          const int j = e / cols, c = e - j * cols;
          sw[j * dc + c] = w[j * d + k0 + c];
        }
#pragma unroll 4
        for (int e = i; e < g * cols; e += nthreads) {
          const int row = e / cols, c = e - row * cols;
          xs[row * stride + c] = __ldcs(xg + (long long)row * d + k0 + c);
        }
        __syncthreads();
        if (real) {
          const float* xr = xs + i * stride;
          for (int c = 0; c < cols; ++c) {
            const float xv = xr[c];
#pragma unroll
            for (int j = 0; j < kMaxStages; ++j)
              if (j < t) lp[j] = fmaf(xv, sw[j * dc + c], lp[j]);
          }
        }
      }
    }
    __syncthreads();                   // the buffer now holds red, lps, svs

    const float valid = !real ? 0.0f : vec ? aux[i] : mask[item];
    if (real) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        if (j < t) {
          acc += log_sigmoid(lp[j] + (vec ? aux[g + j] : zq[b * t + j]));
          lp[j] = acc;
          lps[i * t + j] = acc;
        }
      }
    }

    // Eq 10 sums, the fixed-order tree red[k] += red[k + s] for s = p/2 ..
    // 1: row 0 sums the mask (N_q), row 1 + j sums mask * exp(lp_j). Row c
    // is summed by one warp: lane l first takes the levels s >= 32 over
    // its entries l + 32 k in registers, then the levels 16 .. 1 by
    // shuffles, the same additions in the same order.
    for (int k = i; k < p; k += nthreads) {
      const bool mine = k == i;
      red[k] = mine ? valid : 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j)
        if (j < t) red[(1 + j) * p + k] = mine && real ? expf(lp[j]) * valid : 0.0f;
    }
    __syncthreads();
    for (int c = warp; c <= t; c += nwarps) {
      const float* row = red + c * p;
      const int n = p >> 5;            // entries per lane, 1 .. 16
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = k < n ? row[lane + 32 * k] : 0.0f;
#pragma unroll
      for (int h = 8; h >= 1; h >>= 1) {
        if (2 * h <= n) {
#pragma unroll
          for (int k = 0; k < h; ++k) v[k] += v[k + h];
        }
      }
      float sum = v[0];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        sum += __shfl_down_sync(full, sum, off);
      if (lane == 0) s_sum[c] = sum;
    }
    __syncthreads();
    if (i < t) {                       // thread j: stage j's count
      const int j = i;
      const float n_valid = s_sum[0];
      const float m = vec ? aux[g + t] : mq[b];
      const float n_q = fmaxf(n_valid, 1.0f);
      const float c = (m / n_q) * s_sum[1 + j];
      float nk = ceilf(c * n_valid / fmaxf(m, 1.0f));
      nk = fminf(fmaxf(nk, 1.0f), (float)g);
      counts_out[b * t + j] = c;
      nkeep_out[b * t + j] = nk;
      s_nkeep[j] = nk;
    }

    // Chained stable top-n_keep by threshold. Each radix round is one
    // histogram of 8-bit digits in s_hist[round % 3]: filled by integer
    // atomics (one a warp and digit) before the round's barrier, read
    // after it by every warp (each finds the same digit), and the
    // histogram two rounds ahead is zeroed after it, so one barrier a
    // round keeps the three apart. Not unrolled: the select's code is
    // large, and t copies of it would crowd the instruction cache; lp[j]
    // is picked out of registers.
    float surv = valid;
#pragma unroll 1
    for (int j = 0; j < t; ++j) {
      float lpj = lp[0];
#pragma unroll
      for (int jj = 1; jj < kMaxStages; ++jj) lpj = jj == j ? lp[jj] : lpj;
      const bool alive = real && surv > 0.0f;
      const float sj = alive ? lpj : -INFINITY;
      const bool nan = sj != sj;
      const bool keyed = real && !nan;
      const unsigned key = keyed ? order_key(sj) : 0u;
      // Round 0 (top digit) also counts the survivors, and those at -inf.
      const unsigned b_alive = __ballot_sync(full, alive);
      const unsigned b_inf = __ballot_sync(full, alive && sj == -INFINITY);
      if (lane == 0) {
        s_alive[j & 1][0][warp] = __popc(b_alive);
        s_alive[j & 1][1][warp] = __popc(b_inf);
      }
      count_digit(s_hist[round % 3], keyed, key >> 24, lane);
      __syncthreads();   // also publishes s_nkeep (stage 0)
      for (int k = i; k < kBins; k += nthreads)
        s_hist[(round + 2) % 3][k] = 0;
      const int* hist = s_hist[round % 3];
      ++round;
      int n_alive = 0, n_inf = 0;
      for (int w2 = 0; w2 < nwarps; ++w2) {
        n_alive += s_alive[j & 1][0][w2];
        n_inf += s_alive[j & 1][1][w2];
      }
      const int nk = (int)s_nkeep[j];
      bool keep = true;
      // Every survivor ranks below n_alive unless one scores -inf (it then
      // ties the non-survivors before it), and every item below g.
      if (nk < g && (nk < n_alive || n_inf > 0)) {
        unsigned kstar = 0;            // v*'s digits found so far
        int above = 0;                 // keys known to exceed v*
        int cut = -1;                  // shift where the select ended early
#pragma unroll 1
        for (int r = 0; r < 4; ++r) {
          const int shift = 24 - 8 * r;
          if (r > 0) {
            count_digit(s_hist[round % 3],
                        keyed && (key >> (shift + 8)) == (kstar >> (shift + 8)),
                        (key >> shift) & (kBins - 1), lane);
            __syncthreads();
            for (int k = i; k < kBins; k += nthreads)
              s_hist[(round + 2) % 3][k] = 0;
            hist = s_hist[round % 3];
            ++round;
          }
          // The digit b with above + #{> b} < nk <= above + #{>= b}: lane l
          // of a scanning warp holds bins 8l .. 8l + 7, the higher lanes
          // the higher digits. In a group of more than two warps warp 0
          // scans and the others read its pick after one more barrier
          // (instructions are then what limits the card); else every warp
          // scans for itself (then the barrier's latency would).
          const int need = nk - above;
          const bool shared = nwarps > 2;
          int pick[4] = {0, 0, 0, 0};        // digit, skipped, bin, hit
          if (!shared || warp == 0) {
            const int4 h0 = reinterpret_cast<const int4*>(hist)[2 * lane];
            const int4 h1 = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
            const int hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
            int tot = 0;
#pragma unroll
            for (int u = 0; u < 8; ++u) tot += hv[u];
            int incl = tot;            // over this lane and the ones above
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const int o = __shfl_down_sync(full, incl, off);
              if (lane + off < 32) incl += o;
            }
            const int excl = incl - tot;
            const bool mine = excl < need && need <= incl;   // one lane
            if (mine) {
              int skipped = excl;
#pragma unroll
              for (int u = 7; u >= 0; --u) {
                if (skipped + hv[u] >= need) {
                  pick[0] = lane * 8 + u;
                  pick[1] = skipped;
                  pick[2] = hv[u];
                  break;
                }
                skipped += hv[u];
              }
            }
            const unsigned hit = __ballot_sync(full, mine);
            pick[3] = hit != 0;
            if (hit) {
              const int src = __ffs(hit) - 1;
#pragma unroll
              for (int q = 0; q < 3; ++q) pick[q] = __shfl_sync(full, pick[q], src);
            }
            if (shared && lane == 0) {
#pragma unroll
              for (int q = 0; q < 4; ++q) s_pick[r & 1][q] = pick[q];
            }
          }
          if (shared) {
            __syncthreads();
#pragma unroll
            for (int q = 0; q < 4; ++q) pick[q] = s_pick[r & 1][q];
          }
          if (!pick[3]) {   // fewer keyed items than nk (NaNs): all of
            kstar = 0;      // them stay, as every key is > 0
            cut = 24;
            break;
          }
          const int digit = pick[0], skipped = pick[1], bin = pick[2];
          kstar |= (unsigned)digit << shift;
          above += skipped;
          if (skipped + bin == need) { // the whole bin stays: no tie is cut
            cut = shift;
            break;
          }
        }
        if (cut >= 0) {
          keep = nan || (keyed && (key >> cut) >= (kstar >> cut));
        } else {
          // above = c_gt; the ties at v* in index order
          const bool gt = keyed && key > kstar;
          const bool eq = keyed && key == kstar;
          const unsigned beq = __ballot_sync(full, eq);
          if (lane == 0) s_eq[warp] = __popc(beq);
          __syncthreads();
          int before = __popc(beq & lt_mask);
          for (int w2 = 0; w2 < warp; ++w2) before += s_eq[w2];
          keep = nan || gt || (eq && before < nk - above);
        }
      }
      if (alive) surv = surv * (keep ? 1.0f : 0.0f);
      if (real) svs[i * t + j] = surv;
    }
    __syncthreads();

    // Write the group's lp and survivors, contiguous (g, t) runs, once.
    const int n = g * t;
    float* lo = lp_out + (long long)b * n;
    float* so = surv_out + (long long)b * n;
    if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(lo) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(so) & 15) == 0) {
      for (int e = i; e < n / 4; e += nthreads) {
        reinterpret_cast<float4*>(lo)[e] = make_float4(
            lps[4 * e], lps[4 * e + 1], lps[4 * e + 2], lps[4 * e + 3]);
        reinterpret_cast<float4*>(so)[e] = make_float4(
            svs[4 * e], svs[4 * e + 1], svs[4 * e + 2], svs[4 * e + 3]);
      }
    } else {
      for (int e = i; e < n; e += nthreads) {
        lo[e] = lps[e];
        so[e] = svs[e];
      }
    }
    __syncthreads();                   // the buffer is free again
    if (vec) {
      const int bn = b + 2 * gridDim.x;
      if (bn < n_groups)
        prefetch(buf, buf + nbuf - naux, x, mask, zq, mq, bn, g, d, t, i,
                 nthreads);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Blocks of one launch: those that fit on the device at once, at most one
// per group (0 if the runtime cannot say).
int grid_blocks(int n_groups, int threads, size_t smem) {
  int dev = 0, per_sm = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cascade_filter_kernel, threads, smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * n_sm < n_groups ? per_sm * n_sm : n_groups;
}

}  // namespace

extern "C" {

int cascade_filter_threads(int g) { return (g + 31) / 32 * 32; }

int cascade_filter_width(int g) { return width(cascade_filter_threads(g)); }

// Shared memory of a launch whose x is 16-byte aligned.
size_t cascade_filter_smem(int g, int d, int t) {
  const int p = cascade_filter_width(g);
  return sizeof(float) * smem_floats(g, d, t, p, vec_fits(g, d, t, p));
}

// Returns cudaGetLastError() after the launch (0 = launched).
int cascade_filter(const float* x, const float* w, const float* zq,
                   const float* mask, const float* mq, float* lp,
                   float* surv, float* counts, float* nkeep, int b, int g,
                   int d, int t, void* stream) {
  const int threads = cascade_filter_threads(g);
  const int p = cascade_filter_width(g);
  const bool vec = vec_fits(g, d, t, p) &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const size_t smem = sizeof(float) * smem_floats(g, d, t, p, vec);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cascade_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = grid_blocks(b, threads, smem);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cascade_filter_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      x, w, zq, mask, mq, lp, surv, counts, nkeep, b, g, d, t, p, (int)vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
