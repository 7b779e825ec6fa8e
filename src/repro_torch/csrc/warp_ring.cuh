// The per-warp chunk ring of the training kernels K3 (cascade_score_bwd.cu),
// K4 and K5 (cascade_loss.cu) and K6's backward (cascade_score_single.cu),
// and the pieces of their per-item work that they share.
//
// The map: persistent blocks of NW warps, one full wave of the card; block
// k takes the groups k, k + grid, ... (a static map: no counter, no
// atomics), and its warp w the chunks w, w + NW, ... of kChunk rows of each
// group, so a group's chunks are worked on side by side and the block meets
// once per group to add its warps' per-group sums in warp order. A group
// never straddles two blocks, so a per-group sum needs no combine across
// blocks; a sum over the whole grid is one partial per block, added in block
// order by `ordered_sum_kernel` (ordered_sum.cuh).
//
// The ring: each warp streams its chunks through its own kRing stages of
// shared memory filled by cp.async, prefetching across group boundaries;
// only __syncwarp orders a warp's stages. A chunk's rows are contiguous in
// device memory, so a stage is one contiguous run per input, copied with
// 16-byte cp.async where the run's width and base allow it and with 4-byte
// copies otherwise.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // warps per block, where their rings fit
constexpr int kChunk = 32;   // items per chunk, one lane each
constexpr int kRing = 2;     // a warp's stages (one in flight)

// Warps per block: kWarps where the shared memory of kWarps warps
// (`smem_floats_at_kwarps`) fits in a block, else one.
inline int ring_warps(size_t smem_floats_at_kwarps) {
  return sizeof(float) * smem_floats_at_kwarps <= kMaxSmemBytes ? kWarps : 1;
}

// A warp's walk: the groups blockIdx.x, + gridDim.x, ... (n_mine of them)
// and of each the chunks warp, warp + NW, ... (my_nc of nc).
struct ChunkWalk {
  int nc;        // chunks of a group
  int my_nc;     // of them this warp's
  int n_mine;    // groups of this block
  int n_chunks;  // n_mine * my_nc
  int issued;    // chunks copied so far
  int ib, ic;    // the next chunk to copy: its group and chunk
};

template <int NW>
__device__ __forceinline__ ChunkWalk chunk_walk(int n_groups, int g,
                                                int warp) {
  ChunkWalk c;
  c.nc = (g + kChunk - 1) / kChunk;
  c.my_nc = c.nc > warp ? (c.nc - 1 - warp) / NW + 1 : 0;
  c.n_mine = (int)blockIdx.x < n_groups
                 ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1
                 : 0;
  c.n_chunks = c.n_mine * c.my_nc;
  c.issued = 0;
  c.ib = blockIdx.x;
  c.ic = warp;
  return c;
}

// Copy the warp's next chunk, when it has one left, into its stage
// `issued % kRing` — copy(stage, group, first row, rows) issues the
// copies — and step (ib, ic) on to the warp's following chunk: the next of
// this group, then the block's next group. One commit group per call
// (empty when no chunk is left), so the waits count chunks.
template <int NW, typename Copy>
__device__ __forceinline__ void stage_next_chunk(ChunkWalk& c, int g,
                                                 int warp, Copy copy) {
  if (c.issued < c.n_chunks) {
    const int r0 = c.ic * kChunk;
    copy(c.issued % kRing, c.ib, r0, min(kChunk, g - r0));
    ++c.issued;
    c.ic += NW;
    if (c.ic >= c.nc) {
      c.ic = warp;
      c.ib += gridDim.x;
    }
  }
  cp_async_commit();
}

// n contiguous floats, device -> shared, by the warp's lanes: 16-byte
// copies when VEC (n, src and dst multiples of 4 floats), else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void copy_run(float* dst, const float* src, int n,
                                         int lane) {
  if (VEC) {
    for (int e = lane; e < n / 4; e += 32) cp_async16(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + e);
  }
}

// n contiguous floats, shared -> device, by the warp's lanes (float4
// stores when VEC, on the same conditions as copy_run).
template <bool VEC>
__device__ __forceinline__ void store_run(float* dst, const float* src, int n,
                                          int lane) {
  if (VEC) {
    for (int e = lane; e < n / 4; e += 32)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
  } else {
    for (int e = lane; e < n; e += 32) dst[e] = src[e];
  }
}

// An item's logits without the bias, z[j] = x . w_eff[j] for j < t, from
// its row xr (float32 or bfloat16) in shared memory and w_eff (t, d) in
// shared memory as float32: fmaf over k = 0..d-1 in order, four elements at
// a time when VEC (d % 4 == 0, xr aligned to four elements). kS is the
// stages the loops run to (t, or 8 behind j < t).
template <bool VEC, int kS, typename TX>
__device__ __forceinline__ void row_logits(const TX* xr, const float* sw,
                                           int d, int t, float (&z)[kS]) {
#pragma unroll
  for (int j = 0; j < kS; ++j) z[j] = 0.0f;
  if (VEC) {
    const float4* w4 = reinterpret_cast<const float4*>(sw);
    for (int k4 = 0; k4 < d / 4; ++k4) {
      const float4 a = load4(xr + 4 * k4);
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
  } else {
    for (int k = 0; k < d; ++k) {
      const float xv = to_f32(xr[k]);
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < t) z[j] = fmaf(xv, sw[j * d + k], z[j]);
    }
  }
}

// The sum of v over the warp's 32 lanes, in one fixed order (a butterfly:
// v += v of lane ^ 16, ^ 8, ^ 4, ^ 2, ^ 1); every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
