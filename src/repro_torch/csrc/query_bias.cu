// query_bias: the serving cascade's per-query stage biases for Hopper
// (sm_90a), a port-only kernel.
//
// The reference computes zq = q @ w_q.T + b in XLA inside its serving
// pipeline (src/repro/core/pipeline.py `run_cascade`); there is no Pallas
// kernel to replace. On this card a library matmul orders the dot
// product's sums by the batch's row count, so a request's zq, and with it
// its lp bits, would depend on the size of the chunk it was served in.
// This kernel computes, one thread per (row r, stage t),
//
//   zq[r, t] = (((b[t] + q[r,0] w[t,0]) + q[r,1] w[t,1]) + ...) + q[r,J-1] w[t,J-1]
//
// summing over j in index order with explicit round-to-nearest products
// and sums (__fmul_rn / __fadd_rn: nvcc may not contract them into FMAs),
// so every row's bits depend on that row alone, never on the row count.
// The plain version (kernels/query_bias/ref.py) takes the same operations
// in the same order and gives the same bits.
//
// q (R, J), w (T, J), b (T,) -> zq (R, T), float32, T <= 8 and J the log's
// query-bucket count (8). What bounds it on this card: launch latency; the
// data is a few KB (R * (J + T) floats), so a simple kernel is enough.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void query_bias_kernel(const float* __restrict__ q,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b,
                                  float* __restrict__ zq, int rows, int dq,
                                  int t) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * t) return;
  const int r = (int)(i / t), s = (int)(i % t);
  const float* qr = q + (long long)r * dq;
  const float* ws = w + (long long)s * dq;
  float acc = b[s];
  for (int j = 0; j < dq; ++j) acc = __fadd_rn(acc, __fmul_rn(qr[j], ws[j]));
  zq[i] = acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int query_bias(const float* q, const float* w, const float* b, float* zq,
               int rows, int dq, int t, void* stream) {
  const long long n = (long long)rows * t;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  query_bias_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q, w, b, zq, rows, dq, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
