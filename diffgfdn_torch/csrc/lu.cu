// Batched single-RHS solve x = M^-1 b by pivoted LU with product-form pivoting,
// and the conjugate-transposed solve M^H y = g from the same factors.
//
// Replaces: diffgfdn_tpu/kernels/pallas_lu.py::_lu_solve_kernel
// (lu_solve_pallas, reached through csolve1_pallas and FeedbackLoop._solve1),
// and ::_lut_apply_kernel (lut_apply_pallas), the solve's backward (second
// part of this file).
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

// Backward of the solve: y = M^-H g from the packed factors and pivots that
// lu_solve_kernel wrote, which is torch's complex gradient of a real loss
// through x = M^-1 b (grad_b = y, grad_M = -y x^H). The Pallas kernel solves
// M^T y = g for JAX's cotangent; with every factor conjugated on load the
// same two passes solve M^H y = g:
//   1. U^H w = g by forward substitution (column updates, row k of U);
//   2. for k = N-1..0: w[k] -= sum_{i>k} conj(f_k[i]) w[i], then swap w[k]
//      and w[p_k] (undoing the multipliers and swaps in reverse order).
// Order of operations as in lut_apply_plain in diffgfdn_torch/kernels/lu.py
// (the sums of pass 2 run over i = k+1..N-1 from zero); with --fmad=false the
// two agree bit for bit.
//
// Layout: lu (N, N, K) and piv (N, K) as lu_solve_kernel writes them; g and
// y (K, N) complex64, contiguous. Any 1 <= N <= 32.
//
// Bound on an H100: at the training shape (K = 3 x 65537, N = 4) the kernel
// reads the factors (K N^2 8 B = 25.2 MB), the pivots (3.1 MB) and g
// (6.3 MB) and writes y (6.3 MB): 40.9 MB, 12 us at 3.35 TB/s, against about
// 8 N^2 + 11 N FLOP per system: memory bound. Design: one thread per system
// keeps w in registers and reads each factor entry once; the factor and pivot
// reads are bins-last, so a warp's loads are coalesced.
template <int N>
__global__ void lut_apply_kernel(const float2* __restrict__ lu, const int* __restrict__ piv,
                                 const float2* __restrict__ g, float2* __restrict__ y,
                                 long long k_sys) {
  constexpr int U = N <= 8 ? N : 1;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= k_sys) return;
  const float2* g_in = g + s * N;

  float wr[N], wi[N];
#pragma unroll U
  for (int r = 0; r < N; ++r) {
    const float2 v = g_in[r];
    wr[r] = v.x;
    wi[r] = v.y;
  }

  // pass 1: U^H w = g, with d = conj(U[k][k]) and conj(U[k][i]) below it
#pragma unroll U
  for (int k = 0; k < N; ++k) {
    const float2 d = lu[(k * N + k) * k_sys + s];
    const float dr = d.x, di = -d.y;
    const float inv_den = 1.0f / (dr * dr + di * di);
    const float wkr = (wr[k] * dr + wi[k] * di) * inv_den;
    const float wki = (wi[k] * dr - wr[k] * di) * inv_den;
    wr[k] = wkr;
    wi[k] = wki;
#pragma unroll U
    for (int i = k + 1; i < N; ++i) {
      const float2 u = lu[(k * N + i) * k_sys + s];
      const float ur = u.x, ui = -u.y;
      wr[i] = wr[i] - (ur * wkr - ui * wki);
      wi[i] = wi[i] - (ur * wki + ui * wkr);
    }
  }

  // pass 2: undo the multipliers (conjugated) and the swaps, last step first
#pragma unroll U
  for (int k = N - 1; k >= 0; --k) {
    if (k < N - 1) {
      float sr = 0.0f, si = 0.0f;
#pragma unroll U
      for (int i = k + 1; i < N; ++i) {
        const float2 f = lu[(i * N + k) * k_sys + s];
        const float fr = f.x, fi = -f.y;
        sr = sr + (fr * wr[i] - fi * wi[i]);
        si = si + (fr * wi[i] + fi * wr[i]);
      }
      wr[k] = wr[k] - sr;
      wi[k] = wi[k] - si;
    }
    const int p = piv[k * k_sys + s];
#pragma unroll U
    for (int r = k + 1; r < N; ++r) {
      if (r == p) {
        const float tr = wr[k], ti = wi[k];
        wr[k] = wr[r];
        wi[k] = wi[r];
        wr[r] = tr;
        wi[r] = ti;
      }
    }
  }

  float2* y_out = y + s * N;
#pragma unroll U
  for (int r = 0; r < N; ++r) {
    y_out[r] = make_float2(wr[r], wi[r]);
  }
}

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

#define LUT_CASE(n)                                                             \
  case n:                                                                       \
    lut_apply_kernel<n><<<blocks, kThreads, 0, st>>>(li, pi, gi, yo, k_sys);    \
    break;

// lu (N,N,K) complex64, piv (N,K) int32, g and y (K,N) complex64 device
// pointers; stream: a cudaStream_t. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported N).
extern "C" int diffgfdn_lut_apply_c64(const void* lu, const void* piv, const void* g, void* y,
                                      long long k_sys, int n, void* stream) {
  if (k_sys <= 0) return cudaSuccess;
  const float2* li = static_cast<const float2*>(lu);
  const int* pi = static_cast<const int*>(piv);
  const float2* gi = static_cast<const float2*>(g);
  float2* yo = static_cast<float2*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((k_sys + kThreads - 1) / kThreads);
  switch (n) {
    LUT_CASE(1) LUT_CASE(2) LUT_CASE(3) LUT_CASE(4) LUT_CASE(5) LUT_CASE(6) LUT_CASE(7)
    LUT_CASE(8) LUT_CASE(9) LUT_CASE(10) LUT_CASE(11) LUT_CASE(12) LUT_CASE(13) LUT_CASE(14)
    LUT_CASE(15) LUT_CASE(16) LUT_CASE(17) LUT_CASE(18) LUT_CASE(19) LUT_CASE(20) LUT_CASE(21)
    LUT_CASE(22) LUT_CASE(23) LUT_CASE(24) LUT_CASE(25) LUT_CASE(26) LUT_CASE(27) LUT_CASE(28)
    LUT_CASE(29) LUT_CASE(30) LUT_CASE(31) LUT_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
