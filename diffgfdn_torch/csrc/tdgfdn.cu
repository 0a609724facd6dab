// Time-domain GFDN delay-line outputs by the exact block-feedforward recursion.
//
// Replaces: diffgfdn_tpu/kernels/tdgfdn.py::_tdgfdn_kernel (tdgfdn.py:167,
// called through delay_line_outputs_pallas), reached by time-domain RIR
// synthesis with broadband (scalar) absorption.
//
// Computes, for an input u (T,), per-line gains g (N,), feedback matrix A
// (N, N), input gains b (N,) and integer delays m (N,), the delay-line outputs
//     y_i[t] = g_i * x_i[t - m_i],   x_j[t] = sum_i A[j][i] y_i[t] + b_j u[t]
// with x = 0 before t = 0, written line-major as y (N, T) float32 (the
// wrapper hands callers its (T, N) transposed view). Sample t's step reads
// only x at t - m_i <= t - m_min, so within a block of L <= m_min consecutive
// samples no read depends on a write of the same block: the block's L samples
// are independent and the result is exact. Each sum over i runs in ascending
// order from A[j][0] y_0, then b_j u[t] is added: the order of
// delay_line_outputs_plain in diffgfdn_torch/kernels/tdgfdn.py, so with
// --fmad=false the two agree bit for bit.
//
// Design: ONE thread block walks the blocks of L samples in order (the loop
// inside the block replaces the TPU's sequential grid); thread tid owns
// sample start + tid, and __syncthreads() separates one block of samples
// from the next. The Pallas kernel's 0/1 selection matmuls and shifting
// history work around Mosaic's static-index rule; here a delayed read is a
// plain index. The history is a line-major (N, T + m_max) float32 scratch in
// device memory, hist[i][m_max + t] = x_i[t], that the wrapper allocates
// (6.3 MB at the served shape: it stays in the 50 MB L2) and this kernel
// zeroes up to m_max. It holds any delay set; there is no size limit and no
// fallback. A, g, b and m sit in shared memory. History reads, history
// writes and y writes of one line are consecutive across threads, so each
// warp access is coalesced (a (T, N) layout of y would spread one warp's
// store of a line over 32 sectors).
//
// Bound on an H100: at the served shape (T = 131072, N = 12) the function
// reads u and writes y, (T + T N) x 4 B = 6.8 MB, 2.0 us at 3.35 TB/s, and
// does (2 N^2 + 2 N) T = 41 MFLOP, 0.6 us at 67 TFLOP/s. Neither sets this
// design's time: the T / L = 256 steps (L = 512) must run one after another,
// each a dependent chain of history loads, the N x N mix, stores and a
// barrier on one SM. Spreading a step over a thread-block cluster, or a
// larger L where the delays allow it, is what would shorten that chain.

#include <cuda_runtime.h>

namespace {

// One sample: y[t, :] from the history, then x[t, :] into the history.
template <int N>
__device__ __forceinline__ void tdgfdn_step(long long t, const float* u, const float* g,
                                            const float* a, const float* b, const int* delay,
                                            float* y, long long t_len, float* hist,
                                            long long h_len, int m_max) {
  float yv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    yv[i] = g[i] * hist[i * h_len + (t + m_max - delay[i])];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y[i * t_len + t] = yv[i];
  }
  const float ut = u[t];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = a[j * N] * yv[0];
#pragma unroll
    for (int i = 1; i < N; ++i) {
      acc = acc + a[j * N + i] * yv[i];
    }
    hist[j * h_len + t + m_max] = acc + b[j] * ut;
  }
}

// Launched as ONE block of L threads, L <= min(delays).
template <int N>
__global__ void tdgfdn_kernel(const float* __restrict__ u, const float* __restrict__ gains,
                              const float* __restrict__ a, const float* __restrict__ b,
                              const int* __restrict__ delays, float* y, float* hist,
                              long long t_len, int m_max) {
  __shared__ float a_s[N * N];
  __shared__ float g_s[N];
  __shared__ float b_s[N];
  __shared__ int d_s[N];
  const int tid = threadIdx.x;
  const int L = blockDim.x;
  for (int k = tid; k < N * N; k += L) a_s[k] = a[k];
  for (int k = tid; k < N; k += L) {
    g_s[k] = gains[k];
    b_s[k] = b[k];
    d_s[k] = delays[k];
  }
  const long long h_len = t_len + m_max;
  for (long long k = tid; k < (long long)N * m_max; k += L) {
    hist[(k / m_max) * h_len + k % m_max] = 0.0f;
  }
  __syncthreads();
  for (long long start = 0; start < t_len; start += L) {
    const long long t = start + tid;
    if (t < t_len) tdgfdn_step<N>(t, u, g_s, a_s, b_s, d_s, y, t_len, hist, h_len, m_max);
    __syncthreads();
  }
}

}  // namespace

#define TD_CASE(n)                                                                   \
  case n:                                                                            \
    tdgfdn_kernel<n><<<1, block, 0, st>>>(ui, gi, ai, bi, di, yo, ho, t_len, m_max); \
    break;

// u (T,), gains (N,), a (N, N) row-major, b (N,): float32 device pointers;
// delays (N,) int32; y (N, T) and hist (N, T + m_max) float32 device
// pointers; block: threads, a power of two <= min(delays) and <= 1024;
// stream: a cudaStream_t. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported N or block).
extern "C" int diffgfdn_tdgfdn_f32(const void* u, const void* gains, const void* a,
                                   const void* b, const void* delays, void* y, void* hist,
                                   long long t_len, int n, int m_max, int block, void* stream) {
  if (t_len <= 0) return cudaSuccess;
  if (block < 1 || block > 1024) return cudaErrorInvalidValue;
  const float* ui = static_cast<const float*>(u);
  const float* gi = static_cast<const float*>(gains);
  const float* ai = static_cast<const float*>(a);
  const float* bi = static_cast<const float*>(b);
  const int* di = static_cast<const int*>(delays);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    TD_CASE(1) TD_CASE(2) TD_CASE(3) TD_CASE(4) TD_CASE(5) TD_CASE(6) TD_CASE(7)
    TD_CASE(8) TD_CASE(9) TD_CASE(10) TD_CASE(11) TD_CASE(12) TD_CASE(13) TD_CASE(14)
    TD_CASE(15) TD_CASE(16) TD_CASE(17) TD_CASE(18) TD_CASE(19) TD_CASE(20) TD_CASE(21)
    TD_CASE(22) TD_CASE(23) TD_CASE(24) TD_CASE(25) TD_CASE(26) TD_CASE(27) TD_CASE(28)
    TD_CASE(29) TD_CASE(30) TD_CASE(31) TD_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
