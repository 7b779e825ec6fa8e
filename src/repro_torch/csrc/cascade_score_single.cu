// K6's backward and K7: the single-group cascade scorer's backward, launched
// once for a vmapped batch of groups, and the feature-major scorer, for
// Hopper (sm_90a). K6's forward is K1's kernel (cascade_score.cu).
//
// Replaces the Pallas TPU kernels (src/repro/kernels/cascade_score/kernel.py)
//   K6 backward  `cascade_score_bwd` / `_bwd_kernel`  (kernel.py:154)
//   K7           `cascade_score_fm` / `_kernel_fm`    (kernel.py:365)
//
// K6's backward takes B groups of N items (one group is B = 1), x (B, N, d),
// w_eff (T, d), zq rows zq_stride apart (T for zq (B, T); 0 for one row
// (T,) shared by every group, an unmapped zq under vmap) and the cotangent
// g (B, N, T):
//
//   gc[i, k]   = sum_{j >= k} g[i, j]            (as total - cumsum + g)
//   g_logit    = gc * sigmoid(-logit)
//   dx (B, N, d) = g_logit . w_eff    dw (T, d) = sum over every item of
//   g_logit^T x    dzq = sum_i g_logit per group (B, T), or over every
//   item (T,) when zq is shared
//
// K7 computes the forward of one group from xt (d, N), the features stored
// feature-major, and returns (N, T) like K6. x, w_eff, zq (and the
// cotangent g) are float32 or bfloat16, up-cast in registers; every output
// and every sum is float32. T <= 8.
//
// What bounds them on this card: bytes. Per item the backward reads d + T
// values and writes d floats for ~6*d*T flops (d = 24, T = 3: ~2.3 flops
// per float32 byte), far below the ~20 flops/byte where f32 compute would
// take over; K7 reads d values and writes T floats for 2*d*T flops.
//
// K6's backward replaces its first design, one block of 128 threads per
// 128-row tile walking a run of tiles: each tile loaded, waited on,
// computed and stored in turn, an integer divide per float, stage loops of
// 8 with T at run time, one thread per (stage, feature) walking the tile's
// items, and one launch (plus a second pass) per group under vmap (28.0%
// of its bound at N = 1,048,576). One group can hold 10^6 items and one
// vmapped call thousands of groups of 7, so neither K3's map (whole groups
// per block) nor a split of the rows alone fits both. The design:
//   * each group is cut into pieces of `piece_rows` rows (the wrapper's
//     `piece_plan`: the whole group up to 256 items, 128-row pieces past
//     that), a function of N alone, so the order of every sum depends only
//     on the shapes and (through the warps per block) d and T;
//   * persistent blocks of kWarps = 4 warps (one warp at a d too wide for
//     four warps' rings), one full wave of the card; block k takes the
//     pieces k, k + grid, ..., and its warp w the 32-row chunks w, w + 4,
//     ... of each, streamed through the warp's own two-stage cp.async ring
//     of warp_ring.cuh (x rows by 16-byte copies when a row is a whole
//     number of 16-byte pieces and x is 16-byte aligned, else 4-byte ones,
//     bfloat16 by plain loads there; cotangent rows by 4-byte copies, or
//     plain loads up-cast when bfloat16), prefetching across pieces;
//   * per chunk, as K3: lane = item recomputes its logits (no residual of
//     the forward) and forms its g_logit row in shared memory; then lane =
//     column k walks the chunk's items in order, chaining dw (k < d) and
//     dzq (k = d, a column of ones: fmaf(v, 1, a) is a + v exactly) in
//     registers and storing the item's dx element (a warp stores an item's
//     d contiguous floats at once);
//   * at a piece's end (one barrier) the warps' chains are added in warp
//     order into the piece's partials; a second barrier frees the chains.
//     A piece that is a whole group with its own zq row writes its dzq
//     there; otherwise the partials land in scratch, dw's laid out (T d,
//     pieces) and dzq's (segments, T, segment's pieces), a segment being a
//     group's pieces (every piece when zq is shared), and
//     `ordered_sum_kernel` (ordered_sum.cuh) adds each row in piece order:
//     dw over every piece, dzq over each segment. No float atomics: the
//     same inputs give the same bits on every run;
//   * two instances with four warps: one for T = 3 (CLOES's cascade), whose
//     stage loops have three steps at compile time, and one for any T <= 8.
// All-zero rows stay inert: their output is cumsum log sigmoid(zq) (K7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ordered_sum.cuh"
#include "warp_ring.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;          // K7: items per block, one thread each
// Bits of `bf16`: which inputs are bfloat16 (the others are float32).
constexpr int kXBf16 = 1, kWBf16 = 2, kZqBf16 = 4, kGBf16 = 8;

// Element i of a float32 or bfloat16 array.
__device__ __forceinline__ float load(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

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
  for (int i = threadIdx.x; i < rows * t; i += blockDim.x)
    out[row0 * t + i] = so[i];
}

// ---------------------------------------------------------------------------
// K6's backward
// ---------------------------------------------------------------------------

// Floats of one stage of a warp's ring: a chunk's (kChunk, d) x rows, in
// x's element size and rounded to whole float4s, then its (kChunk, t)
// cotangent rows as float32.
__host__ __device__ __forceinline__ int stage_floats(int d, int t,
                                                     int xbytes) {
  return round4(kChunk * d * xbytes / 4) + kChunk * t;
}

// Floats of one warp's shared memory: its ring, the chunk's g_logit rows
// (kChunk, round4(t)), and its t * (d + 1) chains.
__host__ __device__ __forceinline__ int warp_floats(int d, int t, int xbytes) {
  return kRing * stage_floats(d, t, xbytes) + kChunk * round4(t) +
         round4(t * (d + 1));
}

// w_eff (t, d) as float32, then the nw warps' memory.
__host__ __device__ __forceinline__ size_t smem_floats(int d, int t, int nw,
                                                       int xbytes) {
  return (size_t)round4(t * d) + (size_t)nw * warp_floats(d, t, xbytes);
}

int bwd_warps(int d, int t, int xbytes) {
  return ring_warps(smem_floats(d, t, kWarps, xbytes));
}

template <typename TX, bool VEC, int NW, int TS>
__global__ void __launch_bounds__(32 * NW)
score_bwd_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                 const void* __restrict__ zq, const void* __restrict__ gct,
                 float* __restrict__ dx, float* __restrict__ part,
                 float* __restrict__ dzq, int n, int d, int t, int zq_stride,
                 int piece_rows, int pieces_per_group, int n_pieces,
                 int bf16, bool dzq_direct) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  constexpr int kV = 16 / sizeof(TX);           // elements per 16 bytes
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  const int ts = round4(t);            // row stride of the g_logit rows
  const int n_col = d + 1;             // dw columns, then dzq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sfloats = stage_floats(d, t, sizeof(TX));
  const int gfloat = sfloats - kChunk * t;     // a stage's cotangent rows
  const int wfloats = warp_floats(d, t, sizeof(TX));
  const bool g_bf16 = bf16 & kGBf16, zq_bf16 = bf16 & kZqBf16;
  // the pieces whose dzq partials add up: a group's, or all when zq is
  // shared
  const int seg = zq_stride != 0 ? pieces_per_group : n_pieces;
  float* sw = smem;                                        // (t, d)
  float* wmem = smem + round4(t * d);                      // the warps'
  float* ring = wmem + warp * wfloats;
  float* sl = ring + kRing * sfloats;                      // (32, ts)
  float* acc = sl + kChunk * ts;                           // (t, n_col)

  for (int i = threadIdx.x; i < t * d; i += blockDim.x)
    sw[i] = load(w, i, bf16 & kWBf16);
  for (int i = lane; i < t * n_col; i += 32) acc[i] = 0.0f;
  __syncthreads();                     // sw is shared by the warps

  auto piece_len = [&](int p) {
    return min(piece_rows, n - (p % pieces_per_group) * piece_rows);
  };
  // The warp's next chunk to copy: chunk cc of piece cp (none left once
  // cp >= n_pieces), and the chunks copied so far.
  int cp = blockIdx.x, cc = warp, issued = 0;
  auto settle = [&]() {                // on to a chunk that exists
    while (cp < n_pieces && cc * kChunk >= piece_len(cp)) {
      cp += gridDim.x;
      cc = warp;
    }
  };
  // Copy the warp's next chunk into its stage issued % kRing, and step on.
  // One commit group per call (empty when no chunk is left), so the waits
  // count chunks.
  auto copy_next = [&]() {
    if (cp < n_pieces) {
      const int b = cp / pieces_per_group;
      const int r0 = (cp - b * pieces_per_group) * piece_rows + cc * kChunk;
      const int rows = min(kChunk, piece_len(cp) - cc * kChunk);
      const long long row = (long long)b * n + r0;
      float* dst = ring + (issued % kRing) * sfloats;
      TX* sx_dst = reinterpret_cast<TX*>(dst);
      const TX* src = x + row * d;
      const int nx = rows * d;
      if (VEC) {
        for (int e = lane; e < nx / kV; e += 32)
          cp_async16(sx_dst + kV * e, src + kV * e);
      } else if (sizeof(TX) == 4) {
        for (int e = lane; e < nx; e += 32) cp_async4(sx_dst + e, src + e);
      } else {
        for (int e = lane; e < nx; e += 32) sx_dst[e] = src[e];
      }
      float* dg = dst + gfloat;
      if (g_bf16) {
        for (int e = lane; e < rows * t; e += 32)
          dg[e] = load(gct, row * t + e, true);
      } else {
        const float* gs = static_cast<const float*>(gct) + row * t;
        for (int e = lane; e < rows * t; e += 32) cp_async4(dg + e, gs + e);
      }
      ++issued;
      cc += NW;
      settle();
    }
    cp_async_commit();
  };
  settle();
  copy_next();

  int q = 0;                           // the warp's chunks worked on
  for (int p = blockIdx.x; p < n_pieces; p += gridDim.x) {
    const int b = p / pieces_per_group;
    const int p0 = (p - b * pieces_per_group) * piece_rows;
    const int len = piece_len(p);
    float zb[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j)
      zb[j] = j < t ? load(zq, (long long)b * zq_stride + j, zq_bf16) : 0.0f;

    for (int c = warp; c * kChunk < len; c += NW, ++q) {
      // Chunk q is in, and chunk q - 1 is done with: refill its stage with
      // chunk q + 1 while this one is worked on.
      cp_async_wait<0>();
      __syncwarp();
      copy_next();
      const float* stage = ring + (q % kRing) * sfloats;
      const TX* sx = reinterpret_cast<const TX*>(stage);
      const float* sg = stage + gfloat;
      const int rows = min(kChunk, len - c * kChunk);

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
      // chains (k < d: dw, k = d: dzq) and the item's dx element.
      const float4* sl4 = reinterpret_cast<const float4*>(sl);
      float* dxc = dx + ((long long)b * n + p0 + c * kChunk) * d;
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
          const float xv = k < d ? to_f32(sx[i * d + k]) : 1.0f;
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            if (j < t) {
              a[j] = fmaf(gl[j], xv, a[j]);
              v = fmaf(gl[j], wk[j], v);
            }
          }
          if (k < d) dxc[(long long)i * d + k] = v;
        }
#pragma unroll
        for (int j = 0; j < kS; ++j)
          if (j < t) acc[j * n_col + k] = a[j];
      }
      __syncwarp();
    }

    // Piece p's end: its partials, the warps' chains added in warp order
    // (zero for a warp with no chunk in it); each chain is read and zeroed
    // by one thread, and the second barrier hands the zeroed chains back.
    // dzq's partial goes to row (segment, s) of the segment's pieces.
    const int seg_i = p / seg, seg_p = p - seg_i * seg;
    __syncthreads();
    float* acc0 = wmem + kRing * sfloats + kChunk * ts;   // warp 0's chains
    for (int e = threadIdx.x; e < t * n_col; e += blockDim.x) {
      float sum = acc0[e];
      acc0[e] = 0.0f;
      for (int wp = 1; wp < NW; ++wp) {
        sum += acc0[wp * wfloats + e];
        acc0[wp * wfloats + e] = 0.0f;
      }
      const int s = e / n_col, k = e - s * n_col;
      if (k < d)
        part[(long long)(s * d + k) * n_pieces + p] = sum;
      else if (dzq_direct)
        dzq[(long long)b * t + s] = sum;
      else
        part[(long long)t * d * n_pieces + ((long long)seg_i * t + s) * seg +
             seg_p] = sum;
    }
    __syncthreads();
  }
  cp_async_wait_all();
}

template <typename TX, bool VEC, int NW, int TS>
int launch_bwd(const void* x, const void* w, const void* zq, const void* g,
               float* dx, float* part, float* dzq, int n, int d, int t,
               int zq_stride, int piece_rows, int pieces_per_group,
               int n_pieces, int bf16, bool dzq_direct, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(d, t, NW, sizeof(TX));
  auto kernel = score_bwd_kernel<TX, VEC, NW, TS>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per piece
  const int blocks = one_wave_blocks(kernel, 32 * NW, smem, n_pieces);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, 32 * NW, smem, s>>>(
      static_cast<const TX*>(x), w, zq, g, dx, part, dzq, n, d, t, zq_stride,
      piece_rows, pieces_per_group, n_pieces, bf16, dzq_direct);
  return (int)cudaGetLastError();
}

// The instance for x's element type: vector or scalar path, four warps at
// T = 3 or any T, or one warp.
template <typename TX>
int run_bwd(const void* x, const void* w, const void* zq, const void* g,
            float* dx, float* part, float* dzq, int n, int d, int t,
            int zq_stride, int piece_rows, int pieces_per_group,
            int n_pieces, int bf16, bool dzq_direct, cudaStream_t s) {
  const bool vec = d % (16 / sizeof(TX)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool four = bwd_warps(d, t, sizeof(TX)) == kWarps;
  auto fn = four && t == 3
                ? (vec ? launch_bwd<TX, true, kWarps, 3>
                       : launch_bwd<TX, false, kWarps, 3>)
            : four ? (vec ? launch_bwd<TX, true, kWarps, 0>
                          : launch_bwd<TX, false, kWarps, 0>)
                   : (vec ? launch_bwd<TX, true, 1, 0>
                          : launch_bwd<TX, false, 1, 0>);
  return fn(x, w, zq, g, dx, part, dzq, n, d, t, zq_stride, piece_rows,
            pieces_per_group, n_pieces, bf16, dzq_direct, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (x float32, or bfloat16 with
// bf16 & 1); the wrappers refuse shapes above the card's per-block limit
// before launching.
size_t cascade_score_groups_bwd_smem(int d, int t, int bf16) {
  const int xbytes = bf16 & kXBf16 ? 2 : 4;
  return sizeof(float) * smem_floats(d, t, bwd_warps(d, t, xbytes), xbytes);
}

size_t cascade_score_fm_smem(int d, int t) {
  return sizeof(float) * ((size_t)t * d + t + (size_t)kRows * t);
}

// K7: xt (d, n), w (t, d), zq (t) -> out (n, t). Returns cudaGetLastError()
// after the launch (0 = launched).
int cascade_score_fm(const void* xt, const void* w, const void* zq,
                     float* out, int n, int d, int t, int bf16,
                     void* stream) {
  const size_t smem = cascade_score_fm_smem(d, t);
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kRows - 1) / kRows;
  cudaError_t e;
  if (bf16 & kXBf16) {
    e = allow_smem(score_fm_kernel<__nv_bfloat16>, smem);
    if (e != cudaSuccess) return (int)e;
    score_fm_kernel<<<blocks, kRows, smem, s>>>(
        static_cast<const __nv_bfloat16*>(xt), w, zq, out, n, d, t, bf16);
  } else {
    e = allow_smem(score_fm_kernel<float>, smem);
    if (e != cudaSuccess) return (int)e;
    score_fm_kernel<<<blocks, kRows, smem, s>>>(
        static_cast<const float*>(xt), w, zq, out, n, d, t, bf16);
  }
  return (int)cudaGetLastError();
}

// K6's backward: b groups of n items, x (b, n, d), w (t, d), zq rows
// zq_stride apart (t, or 0 for one shared row), cotangent g (b, n, t) ->
// dx (b, n, d) and sums = [dw (t, d) | dzq (b, t), or (t) when zq_stride
// is 0].
// Each group is cut into pieces of piece_rows rows; part is scratch of
// (t * d + t) * b * ceil(n / piece_rows) floats. Returns cudaGetLastError()
// after the launches (0 = launched): the kernel, then dw's sum over the
// pieces and, unless the pieces wrote it, dzq's: one pass when dzq too
// sums every piece, else two.
int cascade_score_groups_bwd(const void* x, const void* w, const void* zq,
                             const void* g, float* dx, float* sums,
                             float* part, int b, int n, int d, int t,
                             int zq_stride, int piece_rows, int bf16,
                             void* stream) {
  const int per_group = (n + piece_rows - 1) / piece_rows;
  const int n_pieces = b * per_group;
  // a piece that is a whole group with its own zq row writes its dzq
  const bool direct = zq_stride != 0 && per_group == 1;
  // the pieces whose dzq partials add up: a group's, or all when zq is
  // shared
  const int seg = zq_stride != 0 ? per_group : n_pieces;
  const int td = t * d;
  float* dzq = sums + td;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      bf16 & kXBf16
          ? run_bwd<__nv_bfloat16>(x, w, zq, g, dx, part, dzq, n, d, t,
                                   zq_stride, piece_rows, per_group, n_pieces,
                                   bf16, direct, s)
          : run_bwd<float>(x, w, zq, g, dx, part, dzq, n, d, t, zq_stride,
                           piece_rows, per_group, n_pieces, bf16, direct, s);
  if (rc != 0) return rc;
  if (direct) {
    launch_ordered_sum(part, sums, td, n_pieces, s);
  } else if (seg == n_pieces) {
    // dzq's rows are every piece's too: dw and dzq in one pass
    launch_ordered_sum(part, sums, td + t, n_pieces, s);
  } else {
    launch_ordered_sum(part, sums, td, n_pieces, s);
    launch_ordered_sum(part + (size_t)td * n_pieces, dzq, b * t, seg, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
