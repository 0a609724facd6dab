// Fused biquad-cascade frequency response.
//
// Replaces: diffgfdn_tpu/kernels/pallas_sos.py::_fwd_kernel
// (sos_cascade_response_pallas), which evaluates the SVF output heads
// (models/gain_heads.py) and the GEQ absorption cascades
// (models/feedback_loop.py gamma_response).
//
// Computes h[r][f] = prod_k P_k(w_f) / Q_k(w_f) for rows r < R and bins f < F,
// where P_k(w) = b0 + b1 w + b2 w^2 and Q_k(w) = a0 + a1 w + a2 w^2 are the
// k-th section's real coefficients and w = 1/z is computed by the wrapper.
// Each section's quotient is formed as P conj(Q) / |Q|^2, as _fwd_kernel and
// the plain version in diffgfdn_torch/kernels/sos.py do.
//
// Layout: num, den (R, K, 3) float32; w (F,) complex64; h (R, F) complex64;
// all contiguous.
//
// Bound on an H100: at the SVF-head shape (R = 96, K = 11, F = 65537) the
// kernel writes R F 8 B = 50 MB (15 us at 3.35 TB/s) and does about
// 32 K + 3 = 355 fp32 operations per output (2.2 GFLOP, 33 us at 67 TFLOP/s
// outside the tensor cores): bound by fp32 operations, with a reciprocal per
// section on top. Design: one thread per (row, bin), bins along x so that the
// reads of w and the writes of h are coalesced; the row's 6K coefficients
// are staged once per block in shared memory and read as broadcasts; the
// running product stays in registers, so h is written once. Rows are not
// padded; the ragged bin edge is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sos_cascade_kernel(const float* __restrict__ num,
                                   const float* __restrict__ den,
                                   const float2* __restrict__ w, float2* __restrict__ h,
                                   int n_sec, long long n_bins) {
  extern __shared__ float coef[];  // [num: 3K | den: 3K] of this block's row
  const int row = blockIdx.y;
  const int width = 3 * n_sec;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    coef[i] = num[(long long)row * width + i];
    coef[width + i] = den[(long long)row * width + i];
  }
  __syncthreads();

  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= n_bins) return;
  const float2 zw = w[f];
  const float zre = zw.x, zim = zw.y;
  const float z2re = zre * zre - zim * zim;
  const float z2im = 2.0f * zre * zim;

  float hre = 1.0f, him = 0.0f;
  for (int k = 0; k < n_sec; ++k) {
    const float* c = coef + 3 * k;
    const float* d = coef + width + 3 * k;
    const float pre = c[0] + c[1] * zre + c[2] * z2re;
    const float pim = c[1] * zim + c[2] * z2im;
    const float qre = d[0] + d[1] * zre + d[2] * z2re;
    const float qim = d[1] * zim + d[2] * z2im;
    const float inv = 1.0f / (qre * qre + qim * qim);
    const float sre = (pre * qre + pim * qim) * inv;
    const float sim = (pim * qre - pre * qim) * inv;
    const float tre = hre * sre - him * sim;
    him = hre * sim + him * sre;
    hre = tre;
  }
  h[(long long)row * n_bins + f] = make_float2(hre, him);
}

}  // namespace

// num, den (R, K, 3) float32; w (F,) complex64; h (R, F) complex64 device
// pointers; stream: a cudaStream_t. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for R > 65535 or coefficients past 48 KB).
extern "C" int diffgfdn_sos_cascade_c64(const void* num, const void* den, const void* w,
                                        void* h, int n_rows, int n_sec, long long n_bins,
                                        void* stream) {
  if (n_rows <= 0 || n_bins <= 0) return cudaSuccess;
  const size_t smem = sizeof(float) * 6 * (size_t)n_sec;
  if (n_rows > 65535 || smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((n_bins + kThreads - 1) / kThreads),
            static_cast<unsigned>(n_rows));
  sos_cascade_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(num), static_cast<const float*>(den),
      static_cast<const float2*>(w), static_cast<float2*>(h), n_sec, n_bins);
  return cudaGetLastError();
}
