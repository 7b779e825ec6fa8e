// K8: one-token GQA flash-decode attention over a (windowed) KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `swa_decode` / `_kernel`
// (src/repro/kernels/swa_decode/kernel.py:34-116):
//
//   out[b, h] = sum_p softmax_p(q[b, h] . k[b, p, h / rep] / sqrt(hd))
//                            * v[b, p, h / rep],
//   p over (cache_len - window, cache_len]
//
// q (B, H, hd), k/v (B, S, Hkv, hd), rep = H / Hkv, all float32 or all
// bfloat16; out (B, H, hd) in that dtype. Logits, softmax and accumulation
// in float32. hd in {64, 128}, any rep, any S.
//
// What bounds it on this card: bytes. Each in-window position is read once
// (2 * hd elements of K and V) and used by the rep query heads that share
// its kv head: 2 * rep flops per byte in bf16, far below the ~295 at which
// the tensor cores would take over. So the kernel must keep enough K/V
// bytes in flight to cover the device memory's latency on every SM, spend
// few instructions per byte, and add little before and after the stream.
// The first design had 8 rows of one warp in flight at a time, issued V's
// loads only after K's scores, and combined the splits in a second kernel.
// The design:
//   * only in-window positions [lo, hi) are visited, cut into `n_split`
//     contiguous splits (flash-decode). The wrapper sizes the grid to one
//     full wave of the card: n_split = the block slots (SMs x the blocks
//     that fit on an SM, from the occupancy of this instance) over the
//     (batch, kv head, head group) units, so even B = 1 with 16 kv heads
//     fills the 132 SMs and no block waits for a second wave;
//   * one block per (split, kv head x head group, batch): the K/V rows are
//     loaded once for all (up to 8) query heads of the group. The block
//     streams its positions through a ring of kStages shared-memory stages
//     of 32 KB (K and V of kTile positions) with 16-byte cp.async copies
//     issued by all threads, two stages in flight while the warps compute
//     on the third: K and V travel together and the copies never wait for
//     the arithmetic. A position's row is one contiguous hd x elt run (256
//     B in bf16 at hd 128), so a warp's copies are whole lines;
//   * a row is read from shared memory as 16-byte vectors, 8 elements per
//     lane, hd / 8 lanes per row, so a warp scores 2 (hd 128) or 4 (hd 64)
//     positions per instruction and sums a score in 4 (3) xor-shuffle
//     rounds instead of 5. Each such lane group keeps its own online
//     softmax (m, l, acc over its 8 columns) for the positions it visits,
//     so a score never has to be broadcast to the lanes that weight V.
//     Scores are kept in the log2 domain (q carries scale * log2 e), so a
//     weight is one ex2.approx (relative error ~2^-22), and the rescale of
//     (l, acc) is skipped when a tile does not raise the max;
//   * groups combine with shuffles in a fixed tree, warps in shared memory
//     in warp order. With several splits each block writes its (m, l, acc)
//     partial, and the last block of a (batch, head group) to finish, told
//     so by an integer ticket (one acq_rel atomic) that it then resets to
//     0, combines the partials in split order in one pass: one CUDA launch
//     per call, no float atomics, and the bits do not depend on which
//     block finishes last, so two launches on the same inputs give the
//     same bits. The tickets are zero between calls, and the wrapper
//     keeps one array per (device, stream): calls on one stream run in
//     order, so they never share a ticket, and calls on two streams get
//     two arrays (kernels/swa_decode/kernel.py `_tickets`).
//
// Partials mode (`res_acc` non-null; the `swa_decode_partial` entry): the
// same launch over one rank's block of a sequence-cut cache, whose slots
// [lo, hi) the wrapper gives directly. Where the normalising mode writes
// acc / l, the block that finishes a (batch, head) row writes the row's
// combined softmax state instead: m (the largest logit q.k * scale,
// converted from the kernel's log2 domain to natural-log units, the
// reference's `blockwise_attention` stats), l and acc (unnormalised),
// all float32, so that the ranks' states combine across the cut
// (models/parallel.py `combine_partials`). The normalising mode's
// arithmetic is untouched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageBytes = 32768;          // K and V of one tile
constexpr int kStages = 3;
constexpr int kCombineBatch = 16;           // partials in flight at a time
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr float kLn2 = 0.6931471805599453f;  // log2 units -> natural

template <typename T, int HD>
struct Shape {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kTile = kStageBytes / (2 * kRowBytes);  // positions
  static constexpr int kChunks = kRowBytes / 16;     // 16-byte copies a row
  static constexpr int kLanesPerRow = HD / 8;        // 8 elements a lane
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  static constexpr int kGroups = kWarps * kRowsPerWarp;
  static constexpr int kRowsPerGroup = kTile / kGroups;   // per stage
  static constexpr int kCopies = kTile * kChunks / kThreads;  // per thread
  static_assert(kTile % kGroups == 0, "a stage splits evenly over groups");
  static_assert(kTile * kChunks % kThreads == 0, "whole copies per thread");
};

// 8 consecutive elements (16-byte aligned) as float32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 c = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^(m - mx), 0 for a state that has seen no position (m = -inf).
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.0f : exp2_approx(m - mx);
}

template <int REPG>
constexpr int min_blocks() { return REPG <= 4 ? 2 : 1; }

template <typename T, int HD, int REPG>
__global__ void __launch_bounds__(kThreads, min_blocks<REPG>())
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int* __restrict__ tickets,
                  float* __restrict__ res_m, float* __restrict__ res_l,
                  float* __restrict__ res_acc,
                  int s, int h, int hkv, int lo, int hi, int split_len,
                  float scale) {
  using S = Shape<T, HD>;
  constexpr int LPR = S::kLanesPerRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR;                 // this lane's 8 columns
  const int grp_row = warp * S::kRowsPerWarp + lane / LPR;  // lane group
  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_groups = gridDim.y / hkv;
  const int kvh = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int b = blockIdx.z;
  const int rep = h / hkv;
  const int r0 = grp * REPG;
  const int nrep = min(REPG, rep - r0);
  const int start = lo + split * split_len;
  const int end = min(hi, start + split_len);
  const int n_tiles = (end - start + S::kTile - 1) / S::kTile;

  // Scores are kept in the log2 domain: q carries scale * log2(e), so a
  // softmax weight is one 2^x.
  const float qscale = scale * 1.4426950408889634f;
  float qr[REPG][8], acc[REPG][8], m[REPG], l[REPG];
#pragma unroll
  for (int r = 0; r < REPG; ++r) {
    if (r < nrep) {
      load8<T>(q + ((size_t)b * h + kvh * rep + r0 + r) * HD + sub * 8,
               qr[r]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  const size_t row_stride = (size_t)hkv * HD * sizeof(T);   // bytes
  const size_t base = ((size_t)b * s * hkv + kvh) * HD * sizeof(T);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + base;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + base;

  // Copy tile `t` (positions start + t * kTile ...) into stage `st`;
  // positions at or past `end` are zero-filled (and masked below).
  auto load_tile = [&](int st, int t) {
    unsigned char* ks = smem + st * kStageBytes;
    unsigned char* vs = ks + kStageBytes / 2;
    const int p0 = start + t * S::kTile;
#pragma unroll
    for (int i = 0; i < S::kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / S::kChunks, col = c % S::kChunks;
      const bool ok = p0 + row < end;
      const size_t off = (size_t)(ok ? p0 + row : start) * row_stride +
                         col * 16;
      cp_async16_zfill(ks + row * S::kRowBytes + col * 16, kb + off, ok);
      cp_async16_zfill(vs + row * S::kRowBytes + col * 16, vb + off, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();    // empty groups keep the wait count uniform
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();      // tile t landed; every warp is done with t - 1
    if (t + kStages - 1 < n_tiles)
      load_tile((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    const T* ks = reinterpret_cast<const T*>(smem + (t % kStages) *
                                             kStageBytes);
    const T* vs = reinterpret_cast<const T*>(smem + (t % kStages) *
                                             kStageBytes + kStageBytes / 2);
    const int p0 = start + t * S::kTile;

    float sc[S::kRowsPerGroup][REPG];
#pragma unroll
    for (int j = 0; j < S::kRowsPerGroup; ++j) {
      float kr[8];
      load8<T>(ks + (j * S::kGroups + grp_row) * HD + sub * 8, kr);
#pragma unroll
      for (int r = 0; r < REPG; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[r][e], kr[e], d);
        sc[j][r] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < S::kRowsPerGroup; ++j) {
#pragma unroll
        for (int r = 0; r < REPG; ++r)
          sc[j][r] += __shfl_xor_sync(0xffffffffu, sc[j][r], off);
      }
    }
    bool in[S::kRowsPerGroup];
#pragma unroll
    for (int j = 0; j < S::kRowsPerGroup; ++j)
      in[j] = p0 + j * S::kGroups + grp_row < end;
#pragma unroll
    for (int r = 0; r < REPG; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < S::kRowsPerGroup; ++j) {
        sc[j][r] = in[j] ? sc[j][r] : -INFINITY;
        mt = fmaxf(mt, sc[j][r]);
      }
      if (mt > m[r]) {     // else the rescale would multiply by 2^0 = 1
        const float corr = weight(m[r], mt);
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
        m[r] = mt;
      }
      // m = -inf: nothing seen yet, and every score here is -inf too
      const float mu = m[r] == -INFINITY ? 0.0f : m[r];
#pragma unroll
      for (int j = 0; j < S::kRowsPerGroup; ++j) {
        sc[j][r] = exp2_approx(sc[j][r] - mu);
        l[r] += sc[j][r];
      }
    }
#pragma unroll
    for (int j = 0; j < S::kRowsPerGroup; ++j) {
      float vr[8];   // zero past `end`, where the weight is 0 too
      load8<T>(vs + (j * S::kGroups + grp_row) * HD + sub * 8, vr);
#pragma unroll
      for (int r = 0; r < REPG; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(sc[j][r], vr[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();        // the stages are free for the combine below

  // Combine the lane groups of a warp (fixed xor tree): lanes 0..LPR-1
  // end with the warp's state.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REPG; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float ca = weight(m[r], mx), cb = weight(mo, mx);
      l[r] = fmaf(l[r], ca, lo_ * cb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = fmaf(acc[r][e], ca, ao * cb);
      }
      m[r] = mx;
    }
  }

  // Then the warps, in warp order, through shared memory.
  float* sm_m = reinterpret_cast<float*>(smem);        // [kWarps][REPG]
  float* sm_l = sm_m + kWarps * REPG;                  // [kWarps][REPG]
  float* sm_acc = sm_l + kWarps * REPG;                // [kWarps][REPG][HD]
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < REPG; ++r) {
      if (lane == 0) {
        sm_m[warp * REPG + r] = m[r];
        sm_l[warp * REPG + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[(warp * REPG + r) * HD + sub * 8 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < nrep * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * REPG + r]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(sm_m[w * REPG + r], mx);
      lsum = fmaf(sm_l[w * REPG + r], c, lsum);
      asum = fmaf(sm_acc[(w * REPG + r) * HD + d], c, asum);
    }
    const size_t bh = (size_t)b * h + kvh * rep + r0 + r;
    if (n_split == 1) {
      if (res_acc != nullptr) {
        res_acc[bh * HD + d] = asum;
        if (d == 0) {
          res_m[bh] = mx * kLn2;
          res_l[bh] = lsum;
        }
      } else {
        store(out + bh * HD + d, asum / fmaxf(lsum, 1e-30f));
      }
    } else {
      const size_t pi = bh * n_split + split;
      part_acc[pi * HD + d] = asum;
      if (d == 0) {
        part_m[pi] = mx;
        part_l[pi] = lsum;
      }
    }
  }
  if (n_split == 1) return;

  // The last block of this (batch, head group) to finish combines the
  // splits: out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M =
  // max_s m_s, in split order, in one pass with a running max.
  __syncthreads();        // every thread's partial is written before ...
  const int unit = b * gridDim.y + blockIdx.y;
  if (tid == 0) {
    // ... this ticket, which releases them device-wide and, for the last
    // block, acquires every other block's
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(tickets + unit)
                 : "memory");
    s_last = prev == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  for (int i = tid; i < nrep * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const size_t bh = (size_t)b * h + kvh * rep + r0 + r;
    const float* pm = part_m + bh * n_split;
    const float* pl = part_l + bh * n_split;
    const float* pa = part_acc + bh * n_split * HD + d;
    float mx = -INFINITY, lsum = 0.0f, asum = 0.0f;
    for (int j0 = 0; j0 < n_split; j0 += kCombineBatch) {
      float mj[kCombineBatch], lj[kCombineBatch], aj[kCombineBatch];
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        const int j = j0 + u;
        const bool ok = j < n_split;
        mj[u] = ok ? __ldcg(pm + j) : -INFINITY;
        lj[u] = ok ? __ldcg(pl + j) : 0.0f;
        aj[u] = ok ? __ldcg(pa + (size_t)j * HD) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        if (mj[u] > mx) {  // every split has a position: m_s is finite
          const float c = weight(mx, mj[u]);
          lsum *= c;
          asum *= c;
          mx = mj[u];
        }
        const float c = weight(mj[u], mx);
        lsum = fmaf(lj[u], c, lsum);
        asum = fmaf(aj[u], c, asum);
      }
    }
    if (res_acc != nullptr) {
      res_acc[bh * HD + d] = asum;
      if (d == 0) {
        res_m[bh] = mx * kLn2;
        res_l[bh] = lsum;
      }
    } else {
      store(out + bh * HD + d, asum / fmaxf(lsum, 1e-30f));
    }
  }
  if (tid == 0) tickets[unit] = 0;    // ready for the next call
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float *part_m, *part_l, *part_acc;
  int* tickets;
  float *res_m, *res_l, *res_acc;   // partials mode; null to normalise
  int b, s, h, hkv, lo, hi, n_split, split_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int REPG>
cudaError_t prepare() {
  static cudaError_t e = cudaFuncSetAttribute(
      swa_decode_kernel<T, HD, REPG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return e;
}

template <typename T, int HD, int REPG>
cudaError_t launch(const Args& a) {
  cudaError_t e = prepare<T, HD, REPG>();
  if (e != cudaSuccess) return e;
  const int rep = a.h / a.hkv;
  const int n_groups = (rep + REPG - 1) / REPG;
  const dim3 grid(a.n_split, a.hkv * n_groups, a.b);
  swa_decode_kernel<T, HD, REPG><<<grid, kThreads, kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.part_m,
      a.part_l, a.part_acc, a.tickets, a.res_m, a.res_l, a.res_acc, a.s,
      a.h, a.hkv, a.lo, a.hi,
      a.split_len, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, int REPG>
int blocks_per_sm() {
  if (prepare<T, HD, REPG>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, swa_decode_kernel<T, HD, REPG>, kThreads, kSmemBytes) !=
      cudaSuccess)
    return -1;
  return n;
}

struct Instance {
  int (*occupancy)();
  cudaError_t (*run)(const Args&);
  int tile;
};

template <typename T, int HD, int REPG>
Instance instance() {
  return {blocks_per_sm<T, HD, REPG>, launch<T, HD, REPG>,
          Shape<T, HD>::kTile};
}

template <typename T, int HD>
bool by_group(int group, Instance* out) {
  switch (group) {
    case 2: *out = instance<T, HD, 2>(); return true;
    case 4: *out = instance<T, HD, 4>(); return true;
    case 8: *out = instance<T, HD, 8>(); return true;
    default: return false;
  }
}

bool find(int hd, int group, int is_bf16, Instance* out) {
  if (is_bf16) {
    if (hd == 64) return by_group<__nv_bfloat16, 64>(group, out);
    if (hd == 128) return by_group<__nv_bfloat16, 128>(group, out);
  } else {
    if (hd == 64) return by_group<float, 64>(group, out);
    if (hd == 128) return by_group<float, 128>(group, out);
  }
  return false;
}

}  // namespace

extern "C" {

// Blocks of the (hd, group, dtype) instance that fit on one SM (registers,
// shared memory, threads), or -1 for an instance the kernel lacks.
int swa_decode_blocks_per_sm(int hd, int group, int is_bf16) {
  Instance in;
  return find(hd, group, is_bf16, &in) ? in.occupancy() : -1;
}

// Positions per shared-memory stage of the instance (0 if none).
int swa_decode_tile(int hd, int is_bf16) {
  Instance in;
  return find(hd, 2, is_bf16, &in) ? in.tile : 0;
}

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// (kernels/swa_decode/kernel.py) plans lo, hi, the split and the head
// group, and allocates out, the partials and the zeroed tickets (one per
// batch x kv head x head group).
int swa_decode(const void* q, const void* k, const void* v, void* out,
               float* part_m, float* part_l, float* part_acc, int* tickets,
               int b, int s, int h, int hkv, int hd, int group, int is_bf16,
               int lo, int hi, int n_split, int split_len, float scale,
               void* stream) {
  Instance in;
  if (!find(hd, group, is_bf16, &in)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, part_m, part_l, part_acc, tickets,
               nullptr, nullptr, nullptr, b, s, h, hkv, lo, hi, n_split,
               split_len, scale, (cudaStream_t)stream};
  return (int)in.run(a);
}

// The partials mode: the same launch over the slots [lo, hi) of k/v,
// writing each (batch, head) row's m (natural-log units), l and
// unnormalised acc (float32, (B, H), (B, H), (B, H, hd)) instead of an
// output. The wrapper launches it only for a non-empty range.
int swa_decode_partial(const void* q, const void* k, const void* v,
                       float* res_m, float* res_l, float* res_acc,
                       float* part_m, float* part_l, float* part_acc,
                       int* tickets, int b, int s, int h, int hkv, int hd,
                       int group, int is_bf16, int lo, int hi, int n_split,
                       int split_len, float scale, void* stream) {
  Instance in;
  if (!find(hd, group, is_bf16, &in)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, part_m, part_l, part_acc, tickets,
               res_m, res_l, res_acc, b, s, h, hkv, lo, hi, n_split,
               split_len, scale, (cudaStream_t)stream};
  return (int)in.run(a);
}

}  // extern "C"
