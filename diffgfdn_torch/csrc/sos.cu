// Fused biquad-cascade frequency response, and its coefficient gradients.
//
// Replaces: diffgfdn_tpu/kernels/pallas_sos.py::_fwd_kernel
// (sos_cascade_response_pallas), which evaluates the SVF output heads
// (models/gain_heads.py) and the GEQ absorption cascades
// (models/feedback_loop.py gamma_response), and ::_bwd_kernel, the
// cascade's backward (second part of this file).
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

// Backward of the cascade: for a real loss with gradient G (R, F) with
// respect to h (torch's convention, d/dRe + i d/dIm; JAX's cotangent is
// conj(G)), the coefficient gradients
//   dL/dn_kj =  sum_f Re[conj(G) h w^j / P_k],
//   dL/dd_kj = -sum_f Re[conj(G) h w^j / Q_k],
// with h recomputed per bin and |P|^2, |Q|^2 clamped at 1e-30 as in
// _bwd_kernel (the factored form is finite at zeros of P_k, but 0 * inf is
// not).
//
// The Pallas kernel carries its sums across a sequential grid; a CUDA grid
// has no order, so this is a deterministic two-pass reduction without
// atomics:
//   1. sos_bwd_partial_kernel: grid (blocks, R); each thread accumulates the
//      6K sums over `bins_per_thread` bins (strided by the block size) in
//      registers, the block reduces them (warp shuffles, then the warps in
//      order through shared memory) and writes one partial row to
//      partial[block][r][0..6K), laid out as [3K of d num | 3K of d den];
//   2. sos_bwd_reduce_kernel: one thread per (r, v) sums the partials over
//      the blocks in order and writes dnum, dden (R, K, 3) float32.
// K is a template parameter (1..16) so the 6K accumulators stay in
// registers.
//
// Bound on an H100: at the SVF-head shape (R = 96, K = 11, F = 65537) the
// kernel reads G (R F 8 B = 50.3 MB, 15 us at 3.35 TB/s) and w, and does
// 91 K + 11 fp32 operations per (r, f) by chip_smoke.py's count (6.4 GFLOP,
// 95 us at 67 TFLOP/s outside the tensor cores): bound by operations, three
// of them reciprocals per section. The partials are (F / (threads x bins_per_thread)) x R x 6K
// floats, under 1 MB.
template <int K>
__global__ void sos_bwd_partial_kernel(const float* __restrict__ num,
                                       const float* __restrict__ den,
                                       const float2* __restrict__ w,
                                       const float2* __restrict__ g,
                                       float* __restrict__ partial, int n_rows,
                                       long long n_bins, int bins_per_thread) {
  constexpr int W3 = 3 * K;
  constexpr int W6 = 6 * K;
  extern __shared__ float coef[];  // [num: 3K | den: 3K] of this block's row
  __shared__ float warp_sums[32][W6];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < W3; i += blockDim.x) {
    coef[i] = num[(long long)row * W3 + i];
    coef[W3 + i] = den[(long long)row * W3 + i];
  }
  __syncthreads();

  const float tiny = 1e-30f;
  float acc[W6];
#pragma unroll
  for (int v = 0; v < W6; ++v) acc[v] = 0.0f;

  const float2* g_row = g + (long long)row * n_bins;
  for (int it = 0; it < bins_per_thread; ++it) {
    const long long f =
        ((long long)blockIdx.x * bins_per_thread + it) * blockDim.x + threadIdx.x;
    if (f >= n_bins) break;
    const float2 zw = w[f];
    const float zre = zw.x, zim = zw.y;
    const float z2re = zre * zre - zim * zim;
    const float z2im = 2.0f * zre * zim;

    // pass 1: recompute h at this bin
    float hre = 1.0f, him = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* c = coef + 3 * k;
      const float* d = coef + W3 + 3 * k;
      const float pre = c[0] + c[1] * zre + c[2] * z2re;
      const float pim = c[1] * zim + c[2] * z2im;
      const float qre = d[0] + d[1] * zre + d[2] * z2re;
      const float qim = d[1] * zim + d[2] * z2im;
      const float iq = 1.0f / fmaxf(qre * qre + qim * qim, tiny);
      const float sre = (pre * qre + pim * qim) * iq;
      const float sim = (pim * qre - pre * qim) * iq;
      const float tre = hre * sre - him * sim;
      him = hre * sim + him * sre;
      hre = tre;
    }
    // s = conj(G) h
    const float2 gv = g_row[f];
    const float sre = gv.x * hre + gv.y * him;
    const float sim = gv.x * him - gv.y * hre;

    // pass 2: t = s / P_k and u = s / Q_k, times 1, w, w^2
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* c = coef + 3 * k;
      const float* d = coef + W3 + 3 * k;
      const float pre = c[0] + c[1] * zre + c[2] * z2re;
      const float pim = c[1] * zim + c[2] * z2im;
      const float qre = d[0] + d[1] * zre + d[2] * z2re;
      const float qim = d[1] * zim + d[2] * z2im;
      const float ip = 1.0f / fmaxf(pre * pre + pim * pim, tiny);
      const float iq = 1.0f / fmaxf(qre * qre + qim * qim, tiny);
      const float tre = (sre * pre + sim * pim) * ip;
      const float tim = (sim * pre - sre * pim) * ip;
      const float ure = (sre * qre + sim * qim) * iq;
      const float uim = (sim * qre - sre * qim) * iq;
      acc[3 * k] = acc[3 * k] + tre;
      acc[3 * k + 1] = acc[3 * k + 1] + (tre * zre - tim * zim);
      acc[3 * k + 2] = acc[3 * k + 2] + (tre * z2re - tim * z2im);
      acc[W3 + 3 * k] = acc[W3 + 3 * k] - ure;
      acc[W3 + 3 * k + 1] = acc[W3 + 3 * k + 1] - (ure * zre - uim * zim);
      acc[W3 + 3 * k + 2] = acc[W3 + 3 * k + 2] - (ure * z2re - uim * z2im);
    }
  }

  // block reduction: lanes of a warp by shuffles, then the warps in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int v = 0; v < W6; ++v) {
    float x = acc[v];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][v] = x;
  }
  __syncthreads();
  float* out = partial + ((long long)blockIdx.x * n_rows + row) * W6;
  for (int v = threadIdx.x; v < W6; v += blockDim.x) {
    float total = 0.0f;
    for (int i = 0; i < n_warps; ++i) total = total + warp_sums[i][v];
    out[v] = total;
  }
}

__global__ void sos_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dnum, float* __restrict__ dden,
                                      int n_blocks, int n_rows, int width3) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int width6 = 2 * width3;
  if (idx >= (long long)n_rows * width6) return;
  const int row = static_cast<int>(idx / width6);
  const int v = static_cast<int>(idx % width6);
  float total = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    total = total + partial[((long long)b * n_rows + row) * width6 + v];
  }
  if (v < width3) {
    dnum[(long long)row * width3 + v] = total;
  } else {
    dden[(long long)row * width3 + v - width3] = total;
  }
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

#define SOS_BWD_CASE(k)                                                               \
  case k:                                                                             \
    sos_bwd_partial_kernel<k><<<grid, threads, smem, st>>>(                           \
        nu, de, wi, gi, part, n_rows, n_bins, bins_per_thread);                       \
    break;

// num, den (R, K, 3) float32; w (F,) complex64; g (R, F) complex64;
// partial (n_blocks, R, 6K) float32 scratch with
// n_blocks = ceil(F / (threads x bins_per_thread)); dnum, dden (R, K, 3)
// float32; stream: a cudaStream_t. Returns cudaGetLastError() after the two
// launches (cudaErrorInvalidValue for K outside 1..16, R > 65535, threads not
// a multiple of 32 in 32..1024, or an n_blocks that does not cover F).
extern "C" int diffgfdn_sos_cascade_bwd_c64(const void* num, const void* den, const void* w,
                                            const void* g, void* partial, void* dnum,
                                            void* dden, int n_rows, int n_sec,
                                            long long n_bins, int n_blocks, int threads,
                                            int bins_per_thread, void* stream) {
  if (n_rows <= 0 || n_bins <= 0) return cudaSuccess;
  if (n_sec < 1 || n_sec > 16 || n_rows > 65535 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || bins_per_thread < 1 ||
      (long long)n_blocks * threads * bins_per_thread < n_bins) {
    return cudaErrorInvalidValue;
  }
  const float* nu = static_cast<const float*>(num);
  const float* de = static_cast<const float*>(den);
  const float2* wi = static_cast<const float2*>(w);
  const float2* gi = static_cast<const float2*>(g);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 6 * (size_t)n_sec;
  dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(n_rows));
  switch (n_sec) {
    SOS_BWD_CASE(1) SOS_BWD_CASE(2) SOS_BWD_CASE(3) SOS_BWD_CASE(4) SOS_BWD_CASE(5)
    SOS_BWD_CASE(6) SOS_BWD_CASE(7) SOS_BWD_CASE(8) SOS_BWD_CASE(9) SOS_BWD_CASE(10)
    SOS_BWD_CASE(11) SOS_BWD_CASE(12) SOS_BWD_CASE(13) SOS_BWD_CASE(14) SOS_BWD_CASE(15)
    SOS_BWD_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outputs = (long long)n_rows * 6 * n_sec;
  const unsigned reduce_blocks = static_cast<unsigned>((outputs + 255) / 256);
  sos_bwd_reduce_kernel<<<reduce_blocks, 256, 0, st>>>(
      part, static_cast<float*>(dnum), static_cast<float*>(dden), n_blocks, n_rows,
      3 * n_sec);
  return cudaGetLastError();
}
