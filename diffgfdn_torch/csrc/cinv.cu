// Batched complex inverse by Gauss-Jordan elimination with partial pivoting.
//
// Replaces: diffgfdn_tpu/kernels/pallas_cinv.py::_gj_kernel (cinv_pallas),
// which FeedbackLoop._inv calls for the per-bin loop matrices.
//
// Computes, for each of K independent systems, inv(M) of an N x N complex64
// matrix: row-reduce [M | I] with the pivot of step k taken as the FIRST row
// r >= k that maximises |M[r][k]|^2, rows k and p swapped, the pivot row
// scaled by 1/pivot (as conj(pivot) / |pivot|^2) and column k eliminated from
// every other row. The order of operations is that of _gj_kernel and of the
// plain version in diffgfdn_torch/kernels/cinv.py; built with --fmad=false
// they round alike, so pivots agree bit for bit.
//
// Layout: input and output (K, N, N) complex64, contiguous (float2 per
// element). Any 1 <= N <= 32 (a switch over template instantiations).
//
// Bound on an H100: at the serving shape (K = 3 x 65537, N = 4) the kernel
// must read and write 2 x K x N^2 x 8 B = 50 MB, 15 us at 3.35 TB/s, against
// about 16 N^3 = 1 kFLOP of fp32 work per system (0.2 GFLOP, 3 us at
// 67 TFLOP/s): memory bound. Design: one thread per system keeps the whole
// augmented system in registers (fully unrolled for N <= 8; larger N spill to
// local memory, which L1 caches), so device memory sees one read and one
// write of each matrix. Each thread reads and writes its own contiguous
// 8 N^2 bytes; the L1 cache merges those accesses into whole lines. The
// ragged edge is masked by the thread index; no padding.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void cinv_kernel(const float2* __restrict__ m, float2* __restrict__ out,
                            long long k_sys) {
  constexpr int U = N <= 8 ? N : 1;         // full unroll only for small N
  constexpr int U2 = N <= 8 ? 2 * N : 1;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= k_sys) return;
  const float2* a_in = m + s * N * N;

  float ar[N][2 * N];
  float ai[N][2 * N];
#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      const float2 v = a_in[r * N + c];
      ar[r][c] = v.x;
      ai[r][c] = v.y;
      ar[r][N + c] = (r == c) ? 1.0f : 0.0f;
      ai[r][N + c] = 0.0f;
    }
  }

#pragma unroll U
  for (int k = 0; k < N; ++k) {
    // pivot: the first row r >= k with the largest |a[r][k]|^2
    int p = k;
    float best = ar[k][k] * ar[k][k] + ai[k][k] * ai[k][k];
#pragma unroll U
    for (int r = k + 1; r < N; ++r) {
      const float mag = ar[r][k] * ar[r][k] + ai[r][k] * ai[r][k];
      if (mag > best) {
        best = mag;
        p = r;
      }
    }
    // swap rows k and p (columns < k of both rows are never read again)
#pragma unroll U
    for (int r = k + 1; r < N; ++r) {
      if (r == p) {
#pragma unroll U2
        for (int c = k; c < 2 * N; ++c) {
          const float tr = ar[k][c], ti = ai[k][c];
          ar[k][c] = ar[r][c];
          ai[k][c] = ai[r][c];
          ar[r][c] = tr;
          ai[r][c] = ti;
        }
      }
    }
    // normalize the pivot row: row_k * conj(pivot) / |pivot|^2
    const float pr = ar[k][k], pi = ai[k][k];
    const float inv_den = 1.0f / (pr * pr + pi * pi);
#pragma unroll U2
    for (int c = k; c < 2 * N; ++c) {
      const float xr = ar[k][c], xi = ai[k][c];
      ar[k][c] = (xr * pr + xi * pi) * inv_den;
      ai[k][c] = (xi * pr - xr * pi) * inv_den;
    }
    // eliminate column k from every other row
#pragma unroll U
    for (int r = 0; r < N; ++r) {
      if (r == k) continue;
      const float fr = ar[r][k], fi = ai[r][k];
#pragma unroll U2
      for (int c = k; c < 2 * N; ++c) {
        ar[r][c] = ar[r][c] - (fr * ar[k][c] - fi * ai[k][c]);
        ai[r][c] = ai[r][c] - (fr * ai[k][c] + fi * ar[k][c]);
      }
    }
  }

  float2* a_out = out + s * N * N;
#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      a_out[r * N + c] = make_float2(ar[r][N + c], ai[r][N + c]);
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

#define CINV_CASE(n)                                                        \
  case n:                                                                   \
    cinv_kernel<n><<<blocks, kThreads, 0, st>>>(in, o, k_sys);              \
    break;

// m, out: (K, N, N) complex64 device pointers; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported N).
extern "C" int diffgfdn_cinv_c64(const void* m, void* out, long long k_sys, int n,
                                 void* stream) {
  if (k_sys <= 0) return cudaSuccess;
  const float2* in = static_cast<const float2*>(m);
  float2* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((k_sys + kThreads - 1) / kThreads);
  switch (n) {
    CINV_CASE(1) CINV_CASE(2) CINV_CASE(3) CINV_CASE(4) CINV_CASE(5) CINV_CASE(6)
    CINV_CASE(7) CINV_CASE(8) CINV_CASE(9) CINV_CASE(10) CINV_CASE(11) CINV_CASE(12)
    CINV_CASE(13) CINV_CASE(14) CINV_CASE(15) CINV_CASE(16) CINV_CASE(17) CINV_CASE(18)
    CINV_CASE(19) CINV_CASE(20) CINV_CASE(21) CINV_CASE(22) CINV_CASE(23) CINV_CASE(24)
    CINV_CASE(25) CINV_CASE(26) CINV_CASE(27) CINV_CASE(28) CINV_CASE(29) CINV_CASE(30)
    CINV_CASE(31) CINV_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
