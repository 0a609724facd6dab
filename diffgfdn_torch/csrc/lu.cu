// Batched single-RHS solve x = M^-1 b by pivoted LU with product-form pivoting.
//
// Replaces: diffgfdn_tpu/kernels/pallas_lu.py::_lu_solve_kernel
// (lu_solve_pallas, reached through csolve1_pallas and FeedbackLoop._solve1).
//
// Computes, for each of K independent N x N complex64 systems: at step k the
// pivot p_k is the FIRST row r >= k that maximises |A[r][k]|^2; rows k and
// p_k are swapped over the active columns k.. and in the right-hand side only
// (the multipliers already stored left of column k stay put: the product
// form A = S_0 (I + f_0 e_0^T) ... S_{n-1} (I + f_{n-1} e_{n-1}^T) U);
// the multipliers f = A[i][k] * conj(pivot) / |pivot|^2 are stored below the
// diagonal and the trailing block and the RHS are updated; back substitution
// then gives x. Order of operations as in _lu_solve_kernel and the plain
// version in diffgfdn_torch/kernels/lu.py; with --fmad=false the pivots agree
// bit for bit.
//
// Layout (documented for the transposed-solve kernel of the training slice):
//   m   (K, N, N) complex64, b (K, N) complex64   -- inputs, contiguous
//   x   (K, N) complex64                          -- solution
//   lu  (N, N, K) complex64: lu[i][j][s] = U[i][j] for j >= i, the
//       multiplier f_j[i] for j < i, of system s (bins last: coalesced)
//   piv (N, K) int32: piv[k][s] = absolute pivot row p_k >= k of system s
// Any 1 <= N <= 32 (a switch over template instantiations).
//
// Bound on an H100: at the serving shape (K = 3 x 65537, N = 4) the kernel
// reads m and b and writes x, lu and piv: K x (N^2 x 16 + N x 20) B = 66 MB,
// 20 us at 3.35 TB/s, against about 8 N^3 / 3 FLOP per system: memory bound.
// Design: one thread per system keeps the active block in registers (fully
// unrolled for N <= 8; larger N spill to local memory, which L1 caches);
// device memory sees one read of each input and one write of each output.
// The factor and pivot writes are bins-last, so a warp's stores are
// coalesced. The ragged edge is masked by the thread index; no padding.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void lu_solve_kernel(const float2* __restrict__ m, const float2* __restrict__ b,
                                float2* __restrict__ x, float2* __restrict__ lu,
                                int* __restrict__ piv, long long k_sys) {
  constexpr int U = N <= 8 ? N : 1;  // full unroll only for small N
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= k_sys) return;
  const float2* a_in = m + s * N * N;
  const float2* b_in = b + s * N;

  float lr[N][N], li[N][N], rr[N], ri[N];
#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      const float2 v = a_in[r * N + c];
      lr[r][c] = v.x;
      li[r][c] = v.y;
    }
    const float2 v = b_in[r];
    rr[r] = v.x;
    ri[r] = v.y;
  }

#pragma unroll U
  for (int k = 0; k < N; ++k) {
    // pivot: the first row r >= k with the largest |a[r][k]|^2
    int p = k;
    float best = lr[k][k] * lr[k][k] + li[k][k] * li[k][k];
#pragma unroll U
    for (int r = k + 1; r < N; ++r) {
      const float mag = lr[r][k] * lr[r][k] + li[r][k] * li[r][k];
      if (mag > best) {
        best = mag;
        p = r;
      }
    }
    piv[k * k_sys + s] = p;
    // swap rows k and p over the active columns and the RHS only
#pragma unroll U
    for (int r = k + 1; r < N; ++r) {
      if (r == p) {
#pragma unroll U
        for (int c = k; c < N; ++c) {
          const float tr = lr[k][c], ti = li[k][c];
          lr[k][c] = lr[r][c];
          li[k][c] = li[r][c];
          lr[r][c] = tr;
          li[r][c] = ti;
        }
        const float tr = rr[k], ti = ri[k];
        rr[k] = rr[r];
        ri[k] = ri[r];
        rr[r] = tr;
        ri[r] = ti;
      }
    }
    if (k == N - 1) break;
    // multipliers f = a[i][k] / pivot, stored below the diagonal
    const float pr = lr[k][k], pi = li[k][k];
    const float inv_den = 1.0f / (pr * pr + pi * pi);
    const float ipr = pr * inv_den;
    const float ipi = -pi * inv_den;
#pragma unroll U
    for (int i = k + 1; i < N; ++i) {
      const float c1r = lr[i][k], c1i = li[i][k];
      const float fr = c1r * ipr - c1i * ipi;
      const float fi = c1r * ipi + c1i * ipr;
      lr[i][k] = fr;
      li[i][k] = fi;
      // trailing update of row i and of its RHS entry
#pragma unroll U
      for (int j = k + 1; j < N; ++j) {
        const float ur = lr[k][j], ui = li[k][j];
        lr[i][j] = lr[i][j] - (fr * ur - fi * ui);
        li[i][j] = li[i][j] - (fr * ui + fi * ur);
      }
      rr[i] = rr[i] - (fr * rr[k] - fi * ri[k]);
      ri[i] = ri[i] - (fr * ri[k] + fi * rr[k]);
    }
  }

  // back substitution: x[k] = (rhs[k] - sum_{j>k} U[k][j] x[j]) / U[k][k]
  float xr[N], xi[N];
#pragma unroll U
  for (int k = N - 1; k >= 0; --k) {
    float sr = 0.0f, si = 0.0f;
#pragma unroll U
    for (int j = k + 1; j < N; ++j) {
      sr = sr + (lr[k][j] * xr[j] - li[k][j] * xi[j]);
      si = si + (lr[k][j] * xi[j] + li[k][j] * xr[j]);
    }
    const float num_r = (k < N - 1) ? rr[k] - sr : rr[k];
    const float num_i = (k < N - 1) ? ri[k] - si : ri[k];
    const float dr = lr[k][k], di = li[k][k];
    const float inv_den = 1.0f / (dr * dr + di * di);
    xr[k] = (num_r * dr + num_i * di) * inv_den;
    xi[k] = (num_i * dr - num_r * di) * inv_den;
  }

  float2* x_out = x + s * N;
#pragma unroll U
  for (int r = 0; r < N; ++r) {
    x_out[r] = make_float2(xr[r], xi[r]);
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      lu[(r * N + c) * k_sys + s] = make_float2(lr[r][c], li[r][c]);
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

#define LU_CASE(n)                                                              \
  case n:                                                                       \
    lu_solve_kernel<n><<<blocks, kThreads, 0, st>>>(mi, bi, xo, luo, po, k_sys); \
    break;

// m (K,N,N), b (K,N), x (K,N), lu (N,N,K): complex64 device pointers;
// piv (N,K) int32; stream: a cudaStream_t. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported N).
extern "C" int diffgfdn_lu_solve_c64(const void* m, const void* b, void* x, void* lu,
                                     void* piv, long long k_sys, int n, void* stream) {
  if (k_sys <= 0) return cudaSuccess;
  const float2* mi = static_cast<const float2*>(m);
  const float2* bi = static_cast<const float2*>(b);
  float2* xo = static_cast<float2*>(x);
  float2* luo = static_cast<float2*>(lu);
  int* po = static_cast<int*>(piv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((k_sys + kThreads - 1) / kThreads);
  switch (n) {
    LU_CASE(1) LU_CASE(2) LU_CASE(3) LU_CASE(4) LU_CASE(5) LU_CASE(6) LU_CASE(7)
    LU_CASE(8) LU_CASE(9) LU_CASE(10) LU_CASE(11) LU_CASE(12) LU_CASE(13) LU_CASE(14)
    LU_CASE(15) LU_CASE(16) LU_CASE(17) LU_CASE(18) LU_CASE(19) LU_CASE(20) LU_CASE(21)
    LU_CASE(22) LU_CASE(23) LU_CASE(24) LU_CASE(25) LU_CASE(26) LU_CASE(27) LU_CASE(28)
    LU_CASE(29) LU_CASE(30) LU_CASE(31) LU_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
