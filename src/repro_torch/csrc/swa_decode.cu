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
// What bounds it on this card: bytes. Each cached position is read once
// (2 * hd elements of K and V) and used by the rep query heads that share
// its kv head: ~4 * rep flops per element, 2 * rep flops per byte in bf16,
// far below the ~295 at which even the tensor cores would take over, and
// the kernel's float32 FMAs (~20 flops per byte) are not reached either.
// So the design streams the in-window K/V at full width and keeps
// everything else on chip:
//   * only in-window positions [lo, hi) are visited (the TPU kernel masked
//     out-of-window chunks; skipping them keeps the semantics), cut into
//     `n_split` contiguous splits (flash-decode) so that even B = 1 with 16
//     kv heads fills the 132 SMs;
//   * one block per (split, kv head x head group, batch): the K/V rows are
//     loaded once for all (up to 8) query heads of the group. Each of the 8
//     warps walks its own tiles of 8 positions, with the 8 rows' loads in
//     flight together; a row is read by the 32 lanes as consecutive 4-16
//     byte vectors (one 128/256/512-byte line per row);
//   * scores are lane partial dots summed by a xor butterfly (every lane
//     ends with the same bits), then the online softmax (m, l, acc) per
//     head stays in registers, acc as each lane's hd/32 columns;
//   * the block's warps combine in shared memory in warp order; with
//     several splits each block writes its (m, l, acc) partial and a
//     second kernel combines them in split order. No atomics: two launches
//     on the same inputs give the same bits.
// A simple kernel that is right: wgmma / TMA are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;    // positions a warp has in flight per step

// Load hd/32 = E consecutive elements as float32 (one vector load).
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[E]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (E == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    } else {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      out[0] = a.x; out[1] = a.y;
    }
  } else {
    if constexpr (E == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      out[0] = a.x; out[1] = a.y; out[2] = c.x; out[3] = c.y;
    } else {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u));
      out[0] = a.x; out[1] = a.y;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T, int HD, int REPG>
__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int s, int h, int hkv,
                  int lo, int hi, int split_len, float scale) {
  constexpr int E = HD / 32;
  __shared__ float sm_m[kWarps][REPG];
  __shared__ float sm_l[kWarps][REPG];
  __shared__ float sm_acc[kWarps][REPG][HD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_groups = gridDim.y / hkv;
  const int kvh = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int b = blockIdx.z;
  const int rep = h / hkv;
  const int r0 = grp * REPG;
  const int nrep = min(REPG, rep - r0);
  const int start = lo + split * split_len;
  const int end = min(hi, start + split_len);

  float qr[REPG][E], acc[REPG][E], m[REPG], l[REPG];
#pragma unroll
  for (int r = 0; r < REPG; ++r) {
    if (r < nrep) {
      load_row<T, E>(q + ((size_t)b * h + kvh * rep + r0 + r) * HD + lane * E,
                     qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  const size_t row = (size_t)hkv * HD;           // stride between positions
  const size_t base = ((size_t)b * s * hkv + kvh) * HD + lane * E;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int t0 = start + warp * kTile; t0 < end; t0 += kWarps * kTile) {
    float sc[kTile][REPG];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float kr[E];
      if (t0 + j < end) {
        load_row<T, E>(kb + (size_t)(t0 + j) * row, kr);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < REPG; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kr[e], d);
        sc[j][r] = d;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
#pragma unroll
        for (int r = 0; r < REPG; ++r)
          sc[j][r] += __shfl_xor_sync(0xffffffffu, sc[j][r], off);
      }
    }
#pragma unroll
    for (int r = 0; r < REPG; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        sc[j][r] = (t0 + j < end) ? sc[j][r] * scale : -INFINITY;
        mt = fmaxf(mt, sc[j][r]);
      }
      // t0 < end, so mt is finite: the first tile turns m = -inf into a
      // finite max and corr into 0.
      const float m_new = fmaxf(m[r], mt);
      const float corr = expf(m[r] - m_new);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        sc[j][r] = expf(sc[j][r] - m_new);      // masked: exp(-inf) = 0
        l[r] += sc[j][r];
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (t0 + j < end) {
        float vr[E];
        load_row<T, E>(vb + (size_t)(t0 + j) * row, vr);
#pragma unroll
        for (int r = 0; r < REPG; ++r) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = fmaf(sc[j][r], vr[e], acc[r][e]);
        }
      }
    }
  }

  // Combine the warps in warp order. A warp that had no tile keeps
  // m = -inf, l = 0, acc = 0 and weighs 0; warp 0 always has one.
#pragma unroll
  for (int r = 0; r < REPG; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrep * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][r];
      const float c = mw == -INFINITY ? 0.0f : expf(mw - mx);
      lsum = fmaf(sm_l[w][r], c, lsum);
      asum = fmaf(sm_acc[w][r][d], c, asum);
    }
    const size_t bh = (size_t)b * h + kvh * rep + r0 + r;
    if (n_split == 1) {
      store(out + bh * HD + d, asum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t pi = bh * n_split + split;
      part_acc[pi * HD + d] = asum;
      if (d == 0) {
        part_m[pi] = mx;
        part_l[pi] = lsum;
      }
    }
  }
}

// Second pass: out[bh] = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M),
// M = max_s m_s, the splits taken in order. Every split is non-empty, so
// every m_s is finite.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
swa_combine_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  const float* pa = part_acc + bh * n_split * HD + d;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.0f, asum = 0.0f;
  for (int i = 0; i < n_split; ++i) {
    const float c = expf(pm[i] - mx);
    lsum = fmaf(pl[i], c, lsum);
    asum = fmaf(pa[(size_t)i * HD], c, asum);
  }
  store(out + bh * HD + d, asum / fmaxf(lsum, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float *part_m, *part_l, *part_acc;
  int b, s, h, hkv, lo, hi, n_split, split_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int REPG>
cudaError_t launch(const Args& a) {
  const int rep = a.h / a.hkv;
  const int n_groups = (rep + REPG - 1) / REPG;
  const dim3 grid(a.n_split, a.hkv * n_groups, a.b);
  swa_decode_kernel<T, HD, REPG><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.part_m,
      a.part_l, a.part_acc, a.s, a.h, a.hkv, a.lo, a.hi, a.split_len,
      a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  swa_combine_kernel<T, HD><<<a.b * a.h, HD, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), a.n_split);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_group(int group, const Args& a) {
  switch (group) {
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_head_dim(int hd, int group, const Args& a) {
  if (hd == 64) return by_group<T, 64>(group, a);
  if (hd == 128) return by_group<T, 128>(group, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch(es) (0 = launched). The
// wrapper (kernels/swa_decode/kernel.py) plans lo, hi, the split and the
// head group, and allocates out and the partials.
int swa_decode(const void* q, const void* k, const void* v, void* out,
               float* part_m, float* part_l, float* part_acc, int b, int s,
               int h, int hkv, int hd, int group, int is_bf16, int lo, int hi,
               int n_split, int split_len, float scale, void* stream) {
  const Args a{q, k, v, out, part_m, part_l, part_acc, b, s, h, hkv, lo, hi,
               n_split, split_len, scale, (cudaStream_t)stream};
  return (int)(is_bf16 ? by_head_dim<__nv_bfloat16>(hd, group, a)
                       : by_head_dim<float>(hd, group, a));
}

}  // extern "C"
