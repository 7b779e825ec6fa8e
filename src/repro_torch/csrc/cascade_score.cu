// K1, the batched cascade scorer, and K6, the single-group scorer launched
// once for a vmapped batch of groups, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `cascade_score_batched` /
// `_batched_kernel` (src/repro/kernels/cascade_score/kernel.py:224-259)
// and `cascade_score` / `_kernel` (kernel.py:73), whose `jax.vmap` prepends
// the group axis to its grid:
//
//   lp[b, g, j] = sum_{k <= j} log sigmoid(x[b, g, :] . w_eff[k, :] + zq[b, k])
//
// x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T); f32 accumulation;
// T <= 8, any d whose ring of tiles fits in shared memory. K1 takes float32.
// K6 takes x, w_eff and zq in float32 or bfloat16 (up-cast in registers),
// and a zq group stride of 0 for one bias row shared by every group (an
// unmapped zq under vmap); one group of N items is B = 1. K1 and K6 are
// the same kernel: K6 on float32 inputs gives K1's bits.
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
//     addresses, when a row is a whole number of 16-byte pieces (d % 4 == 0
//     in float32, d % 8 == 0 in bfloat16) and x is 16-byte aligned, else
//     4-byte copies of the same contiguous run (the scalar path, for any d;
//     bfloat16 there takes plain 2-byte loads, as cp.async copies no less
//     than 4 bytes). The next tiles are in flight while the current one is
//     scored, and one barrier per tile keeps the ring's stages apart.
//     Where two tiles do not fit in shared memory (float32 d > ~220) the
//     ring is one tile, loaded and scored in turn, so the kernel takes
//     every d whose one tile fits;
//   * an item's row is read from its stage four elements at a time
//     (scalars on the scalar path), w_eff sits in shared memory as float32
//     float4 broadcasts, and the T logits stay in registers;
//   * the group of a row (which zq row it adds) comes from a running
//     counter: one divide per thread at the start, then per tile
//     b += kRows / G, rem += kRows % G with one carry;
//   * each warp stages its 32 items' (32, T) lp rows in shared memory and
//     stores them as one contiguous run, float4 where aligned.
//   * two instances of each path: one for T = 3 (CLOES's cascade, the
//     main path), whose stage loops have three steps at compile time, and
//     one for any T <= 8, whose loops run to 8 behind a test of j < T (on
//     the H100 the T = 3 instance takes ~12% less time at 4096 x 256).
// Numerics: per item, fmaf over k = 0..d-1 in order, then the log_sigmoid
// and cumulative add of K7 (cascade_score_single.cu), so K7 gives the same
// bits as K6 on a group.
// The TPU kernel's padding (LANE = 128 on d, MAX_STAGES on T, BLOCK_ITEMS)
// is a layout choice and is not carried over. All-zero padded rows stay
// inert: their lp is log sigmoid(zq), as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kRows = 128;            // items per tile, one thread each
constexpr int kMaxRing = 3;           // tiles in flight or in use per block
// Bits of `bf16`: which inputs are bfloat16 (the others are float32).
constexpr int kXBf16 = 1, kWBf16 = 2, kZqBf16 = 4;

// Floats of one (kRows, d) tile of x elements of `xbytes` bytes (a whole
// number of float4s: kRows is a multiple of 8).
__host__ __device__ __forceinline__ size_t tile_floats(int d, int xbytes) {
  return (size_t)kRows * d * xbytes / 4;
}

// Floats of shared memory: w_eff (rounded to whole float4s), the ring of
// `ring` (kRows, d) tiles, and the (kRows, t) lp staging.
__host__ __device__ __forceinline__ size_t smem_floats(int d, int t, int ring,
                                                       int xbytes) {
  return (size_t)round4(t * d) + (size_t)ring * tile_floats(d, xbytes) +
         (size_t)kRows * t;
}

// The deepest ring (<= kMaxRing) whose shared memory fits a block; 1 when
// not even two tiles fit (the wrapper refuses a d whose one tile does not).
int ring_depth(int d, int t, int xbytes) {
  for (int r = kMaxRing; r > 1; --r)
    if (sizeof(float) * smem_floats(d, t, r, xbytes) <= kMaxSmemBytes)
      return r;
  return 1;
}

// Tile i of a block's rows [r_begin, r_end) into its stage i % ring of
// sx: 16-byte copies on the vector path, 4-byte ones on the scalar path
// (plain loads for bfloat16 there). One commit group per call (empty past
// the last tile), so the waits count tiles.
template <typename TX, bool VEC>
__device__ __forceinline__ void stage_tile(float* sx, const TX* x,
                                           long long r_begin, long long r_end,
                                           int i, int ring, int d) {
  const long long r0 = r_begin + (long long)i * kRows;
  if (r0 < r_end) {
    const int n = (int)min((long long)kRows, r_end - r0) * d;
    const TX* src = x + r0 * d;
    TX* dst = reinterpret_cast<TX*>(sx + (i % ring) *
                                             tile_floats(d, sizeof(TX)));
    constexpr int kV = 16 / sizeof(TX);          // elements per 16 bytes
    if (VEC) {
      for (int c = threadIdx.x; c < n / kV; c += kRows)
        cp_async16(dst + kV * c, src + kV * c);
    } else if (sizeof(TX) == 4) {
      for (int c = threadIdx.x; c < n; c += kRows) cp_async4(dst + c, src + c);
    } else {
      for (int c = threadIdx.x; c < n; c += kRows) dst[c] = src[c];
    }
  }
  cp_async_commit();
}

template <typename TX, typename TZ, bool VEC, int TS>
__global__ void __launch_bounds__(kRows)
cascade_score_batched_kernel(const TX* __restrict__ x,
                             const void* __restrict__ w,
                             const TZ* __restrict__ zq,
                             float* __restrict__ out, long long n_rows,
                             int g, int d, int t, int ring, int zq_stride,
                             bool w_bf16) {
  // TS > 0: an instance for T = TS, whose stage loops have TS steps
  constexpr int kS = TS > 0 ? TS : kMaxStages;
  if (TS > 0) t = TS;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                            // (t, d) stage weights
  float* sx = smem + round4(t * d);            // ring x (kRows, d) tiles
  const int tile = (int)tile_floats(d, sizeof(TX));
  float* so = sx + (size_t)ring * tile;        // (kRows, t) lp staging
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This block's rows, cut at multiples of 4 (the last block ends at n).
  const long long r_begin = (n_rows * blockIdx.x / gridDim.x) & ~3LL;
  const long long r_end =
      blockIdx.x + 1 == gridDim.x
          ? n_rows
          : (n_rows * (blockIdx.x + 1) / gridDim.x) & ~3LL;
  const int n_tiles = (int)((r_end - r_begin + kRows - 1) / kRows);

  for (int e = tid; e < t * d; e += kRows)
    sw[e] = w_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(w)[e])
                   : static_cast<const float*>(w)[e];
  for (int i = 0; i < ring - 1; ++i)
    stage_tile<TX, VEC>(sx, x, r_begin, r_end, i, ring, d);

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
    stage_tile<TX, VEC>(sx, x, r_begin, r_end, i + ring - 1, ring, d);
    if (ring == 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const long long r0 = r_begin + (long long)i * kRows;
    const int rows = (int)min((long long)kRows, r_end - r0);
    if (tid < rows) {
      const TX* xs = reinterpret_cast<const TX*>(sx + (i % ring) * tile) +
                     tid * d;
      float z[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) z[j] = 0.0f;
      if (VEC) {
        const float4* w4 = reinterpret_cast<const float4*>(sw);
        for (int c4 = 0; c4 < d / 4; ++c4) {
          const float4 a = load4(xs + 4 * c4);
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
          const float xv = to_f32(xs[k]);
#pragma unroll
          for (int j = 0; j < kS; ++j)
            if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
        }
      }
      const TZ* zb = zq + b * zq_stride;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        if (j < t) {
          acc += log_sigmoid(z[j] + to_f32(__ldg(zb + j)));
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

template <typename TX, typename TZ, bool VEC, int TS>
int launch(const void* x, const void* w, const void* zq, float* out,
           long long n_rows, int g, int d, int t, int zq_stride, bool w_bf16,
           cudaStream_t stream) {
  const int ring = ring_depth(d, t, sizeof(TX));
  const size_t smem = sizeof(float) * smem_floats(d, t, ring, sizeof(TX));
  auto kernel = cascade_score_batched_kernel<TX, TZ, VEC, TS>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // one full wave of the card, at most one block per tile
  const int blocks =
      one_wave_blocks(kernel, kRows, smem, (n_rows + kRows - 1) / kRows);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, kRows, smem, stream>>>(
      static_cast<const TX*>(x), w, static_cast<const TZ*>(zq), out, n_rows,
      g, d, t, ring, zq_stride, w_bf16);
  return (int)cudaGetLastError();
}

// The instance for x's and zq's element types: the vector or scalar path,
// T = 3 (CLOES's cascade) or any T.
template <typename TX, typename TZ>
int run(const void* x, const void* w, const void* zq, float* out,
        long long n_rows, int g, int d, int t, int zq_stride, bool w_bf16,
        cudaStream_t s) {
  const bool vec = d % (16 / sizeof(TX)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto fn = t == 3 ? (vec ? launch<TX, TZ, true, 3> : launch<TX, TZ, false, 3>)
                   : (vec ? launch<TX, TZ, true, 0> : launch<TX, TZ, false, 0>);
  return fn(x, w, zq, out, n_rows, g, d, t, zq_stride, w_bf16, s);
}

}  // namespace

extern "C" {

// The library's CUDA runtime error text, for the Python wrappers' errors.
const char* cascade_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// Dynamic shared memory one launch needs (its ring at least one tile
// deep) for x of float32 or, with bf16 & 1, bfloat16; the wrappers refuse
// shapes above the card's per-block limit before launching.
size_t cascade_score_groups_smem(int d, int t, int bf16) {
  const int xbytes = bf16 & kXBf16 ? 2 : 4;
  return sizeof(float) * smem_floats(d, t, ring_depth(d, t, xbytes), xbytes);
}

size_t cascade_score_batched_smem(int d, int t) {
  return cascade_score_groups_smem(d, t, 0);
}

// K6: x (b, g, d), w (t, d), zq rows zq_stride apart (t, or 0 for one row
// shared by every group) -> out (b, g, t); `bf16` says which of x, w, zq
// are bfloat16. Returns cudaGetLastError() after the launch (0 = launched).
int cascade_score_groups(const void* x, const void* w, const void* zq,
                         float* out, int b, int g, int d, int t,
                         int zq_stride, int bf16, void* stream) {
  const long long n_rows = (long long)b * g;
  const bool w_bf16 = bf16 & kWBf16;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 & kXBf16)
    return bf16 & kZqBf16
               ? run<__nv_bfloat16, __nv_bfloat16>(x, w, zq, out, n_rows, g,
                                                   d, t, zq_stride, w_bf16, s)
               : run<__nv_bfloat16, float>(x, w, zq, out, n_rows, g, d, t,
                                           zq_stride, w_bf16, s);
  return bf16 & kZqBf16
             ? run<float, __nv_bfloat16>(x, w, zq, out, n_rows, g, d, t,
                                         zq_stride, w_bf16, s)
             : run<float, float>(x, w, zq, out, n_rows, g, d, t, zq_stride,
                                 w_bf16, s);
}

// K1: float32 x (b, g, d), w (t, d), zq (b, t) -> out (b, g, t).
int cascade_score_batched(const float* x, const float* w, const float* zq,
                          float* out, int b, int g, int d, int t,
                          void* stream) {
  return cascade_score_groups(x, w, zq, out, b, g, d, t, t, 0, stream);
}

}  // extern "C"
