// Device helpers shared by the port's kernels: the log-sigmoid the cascade
// kernels score with, float32 reads of float32 or bfloat16 elements,
// cp.async copies into shared memory, the opt-in to more than 48 KB of
// dynamic shared memory, and the grid of one full wave of the card that the
// persistent kernels launch.
//
// REPRO_MAX_SMEM_BYTES, the per-block shared-memory limit, is set by the
// build (kernels/_build.py MAX_SMEM_BYTES, which the wrappers' refusals
// read too).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef REPRO_MAX_SMEM_BYTES
#error "REPRO_MAX_SMEM_BYTES is set by the build (kernels/_build.py)"
#endif

namespace {

constexpr size_t kMaxSmemBytes = REPRO_MAX_SMEM_BYTES;

// log sigma(z) = min(z, 0) - log1p(exp(-|z|)): no overflow for any finite z.
__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

// An element as float32 (bfloat16 up-casts exactly).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Elements p[0..3] as float32: one 16-byte read of float32 (p 16-byte
// aligned), one 8-byte read of bfloat16 (p 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// 16 bytes global -> shared, bypassing L1 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// As cp_async16, but writes 16 zero bytes and reads nothing when !full.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (any float-aligned address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs
// it; returns the CUDA error of the attribute call (0 = fine).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of one full wave of the card for `kernel` at this block size and
// shared memory (the SMs times the blocks that fit on one), at most `cap`;
// 0 if the runtime cannot say.
template <typename Kernel>
inline int one_wave_blocks(Kernel kernel, int threads, size_t smem,
                           long long cap) {
  int dev = 0, per_sm = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long wave = (long long)per_sm * n_sm;
  return (int)(wave < cap ? wave : cap);
}

}  // namespace
