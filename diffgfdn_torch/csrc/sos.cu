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
//
// Arithmetic. The polynomials are evaluated separately rounded, in the plain
// version's order (diffgfdn_torch/kernels/sos.py): near DC a low-cutoff
// section cancels about four digits there (a0 + a1 + a2 ~ 4 f^2), so a fused
// evaluation would round differently by ~1e-3 of max |h|, more than the
// kernel's tolerance against its plain version. Everything after the
// polynomials uses explicit fused multiply-adds (__fmaf_rn stays fused under
// the build's --fmad=false, which keeps the other sources bit-identical to
// their plain versions). The forward carries the products prod_k P_k and
// prod_k Q_k (complex) through the sections and divides once per output,
// with one IEEE reciprocal (__frcp_rn) of |prod Q|^2, where the plain
// version forms each section's quotient P conj(Q) / |Q|^2. Whenever the
// larger part of prod Q leaves [2^-16, 2^17), both products are multiplied
// by the same power of two, which brings it to [1, 2): exact in float32, so
// it changes no rounding and keeps the products in range at any K. The
// kernel therefore agrees with its plain version within a tolerance (1e-4
// of max |h| on the model's inputs), not bit for bit.
//
// Layout: num, den (R, K, 3) float32; w (F,) complex64; h (R, F) complex64;
// all contiguous.
//
// Bound on an H100: at the SVF-head shape (R = 96, K = 11, F = 65537) the
// kernel writes R F 8 B = 50 MB (15 us at 3.35 TB/s) and does about
// 32 K + 3 = 355 fp32 operations per output by chip_smoke.py's count
// (2.2 GFLOP, 33 us at 67 TFLOP/s outside the tensor cores): bound by fp32
// operations. As written it issues about 25 instructions per section and
// output (14 for the separately rounded polynomials, 8 for the two complex
// products, 3 for the range check). Design: K a template parameter (1..16,
// any other count through K = 0), so the loop over the sections unrolls;
// kFwdBins bins per thread
// (independent chains that hide the latency of the dependent complex
// products), strided by the block size so that the float2 reads of w and
// writes of h are coalesced; the row's coefficients are staged once per
// block in shared memory as two float4 per section and read as broadcasts;
// h is written once. Rows are not padded; the ragged bin edge is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdBins = 4;   // bins per thread of the forward
constexpr int kSplit = 2;     // warps that share a bin's sections in the backward

// c0 + c1 w + c2 w^2, each product and sum rounded on its own in the plain
// version's order (see the note above)
__device__ __forceinline__ void poly(float c0, float c1, float c2, float zre, float zim,
                                     float z2re, float z2im, float& re, float& im) {
  re = __fadd_rn(__fadd_rn(c0, __fmul_rn(c1, zre)), __fmul_rn(c2, z2re));
  im = __fadd_rn(__fmul_rn(c1, zim), __fmul_rn(c2, z2im));
}

// w and w^2 as the plain version forms them
__device__ __forceinline__ void powers(float2 zw, float& zre, float& zim, float& z2re,
                                       float& z2im) {
  zre = zw.x;
  zim = zw.y;
  z2re = __fsub_rn(__fmul_rn(zre, zre), __fmul_rn(zim, zim));
  z2im = __fmul_rn(__fmul_rn(2.0f, zre), zim);
}

// (are, aim) *= (bre, bim), fused
__device__ __forceinline__ void cmul(float& are, float& aim, float bre, float bim) {
  const float re = __fmaf_rn(are, bre, -__fmul_rn(aim, bim));
  aim = __fmaf_rn(are, bim, __fmul_rn(aim, bre));
  are = re;
}

// 1 / x with one MUFU instruction (PTX's rcp.approx: absolute error at most
// 2^-23 for x in [1, 2), a relative error under 2^-22); the host build of
// the tests takes the rounded reciprocal
__device__ __forceinline__ float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / x;
#endif
}

// Stage row `row`'s coefficients: per section (b0, b1, b2, a0), (a1, a2, 0, 0).
__device__ __forceinline__ void stage(const float* __restrict__ num,
                                      const float* __restrict__ den, int row, int n_sec,
                                      float4* coef4) {
  for (int k = threadIdx.x; k < n_sec; k += blockDim.x) {
    const float* c = num + ((long long)row * n_sec + k) * 3;
    const float* d = den + ((long long)row * n_sec + k) * 3;
    coef4[2 * k] = make_float4(c[0], c[1], c[2], d[0]);
    coef4[2 * k + 1] = make_float4(d[1], d[2], 0.0f, 0.0f);
  }
}

// max(|re|, |im|) of prod Q as bits, outside [2^-16, 2^17)
__device__ __forceinline__ bool out_of_range(float qre, float qim) {
  const unsigned m = __float_as_uint(fmaxf(fabsf(qre), fabsf(qim)));
  return m - 0x37800000u >= 0x10800000u;
}

// Multiply both products by 2^(127 - e), e the biased exponent of the larger
// part of prod Q, when it is out of range: that part lands in [1, 2), all
// exactly.
__device__ __forceinline__ void rescale(float& nre, float& nim, float& qre, float& qim) {
  if (!out_of_range(qre, qim)) return;
  unsigned e = __float_as_uint(fmaxf(fabsf(qre), fabsf(qim))) >> 23;
  e = e < 1u ? 1u : (e > 253u ? 253u : e);
  const float s = __uint_as_float((254u - e) << 23);
  nre = __fmul_rn(nre, s);
  nim = __fmul_rn(nim, s);
  qre = __fmul_rn(qre, s);
  qim = __fmul_rn(qim, s);
}

// K > 0: the section count, known at compile time (the loop over the
// sections unrolls); K = 0: n_sec sections
template <int K>
__global__ void __launch_bounds__(kThreads)
sos_cascade_kernel(const float* __restrict__ num, const float* __restrict__ den,
                   const float2* __restrict__ w, float2* __restrict__ h, int n_sec,
                   long long n_bins) {
  extern __shared__ float4 coef4[];
  if (K > 0) n_sec = K;
  const int row = blockIdx.y;
  stage(num, den, row, n_sec, coef4);
  __syncthreads();

  const long long base = (long long)blockIdx.x * blockDim.x * kFwdBins + threadIdx.x;
  float zre[kFwdBins], zim[kFwdBins], z2re[kFwdBins], z2im[kFwdBins];
  float nre[kFwdBins], nim[kFwdBins], qre[kFwdBins], qim[kFwdBins];
#pragma unroll
  for (int j = 0; j < kFwdBins; ++j) {
    const long long f = base + (long long)j * blockDim.x;
    powers(f < n_bins ? w[f] : make_float2(0.0f, 0.0f), zre[j], zim[j], z2re[j], z2im[j]);
    nre[j] = 1.0f;
    nim[j] = 0.0f;
    qre[j] = 1.0f;
    qim[j] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < (K > 0 ? K : n_sec); ++k) {
    const float4 c = coef4[2 * k];
    const float4 d = coef4[2 * k + 1];
    bool out = false;
#pragma unroll
    for (int j = 0; j < kFwdBins; ++j) {
      float pre, pim, are, aim;
      poly(c.x, c.y, c.z, zre[j], zim[j], z2re[j], z2im[j], pre, pim);
      poly(c.w, d.x, d.y, zre[j], zim[j], z2re[j], z2im[j], are, aim);
      cmul(nre[j], nim[j], pre, pim);
      cmul(qre[j], qim[j], are, aim);
      out |= out_of_range(qre[j], qim[j]);
    }
    if (out) {
#pragma unroll
      for (int j = 0; j < kFwdBins; ++j) rescale(nre[j], nim[j], qre[j], qim[j]);
    }
  }
  float2* h_row = h + (long long)row * n_bins;
#pragma unroll
  for (int j = 0; j < kFwdBins; ++j) {
    const long long f = base + (long long)j * blockDim.x;
    if (f < n_bins) {
      // h = prod P conj(prod Q) / |prod Q|^2
      const float inv = __frcp_rn(__fmaf_rn(qre[j], qre[j], __fmul_rn(qim[j], qim[j])));
      h_row[f] = make_float2(__fmul_rn(__fmaf_rn(nre[j], qre[j], __fmul_rn(nim[j], qim[j])), inv),
                             __fmul_rn(__fmaf_rn(nim[j], qre[j], -__fmul_rn(nre[j], qim[j])), inv));
    }
  }
}

// Backward of the cascade: for a real loss with gradient G (R, F) with
// respect to h (torch's convention, d/dRe + i d/dIm; JAX's cotangent is
// conj(G)), the coefficient gradients
//   dL/dn_kj =  sum_f Re[conj(G) h w^j / P_k],
//   dL/dd_kj = -sum_f Re[conj(G) h w^j / Q_k],
// with |P|^2, |Q|^2 clamped at 1e-30 as in _bwd_kernel (the factored form
// is finite at zeros of P_k, but 0 * inf is not). h is the forward's output,
// saved by the autograd function: the Pallas kernel recomputes it because
// VMEM is scarce on the TPU, while on the card it already lies in device
// memory and reading it (8 B per bin) is far cheaper than K sections of
// arithmetic. Per section and bin, P_k and Q_k are evaluated once (rounded
// as in the forward), with two one-instruction reciprocals (rcp_approx;
// the clamp keeps their inputs normal) and explicit fused
// multiply-adds for the rest. The kernel therefore agrees with its plain
// version within a tolerance (1e-4 of the largest gradient), not bit for bit.
//
// The Pallas kernel carries its sums across a sequential grid; a CUDA grid
// has no order, so this is a deterministic two-pass reduction without
// atomics:
//   1. sos_bwd_partial_kernel: grid (blocks, R) of kThreads threads. Each
//      bin's K sections are split over kSplit warps (warp w takes sections
//      w % kSplit, w % kSplit + kSplit, ...; whole warps, so no lane idles
//      on a missing section), which share its s = conj(G) h and w: the
//      block's warps read the same lines, from memory once. A thread walks
//      its bins strided by the row's blocks, so that every read of G and h
//      is coalesced, and keeps its 6 sums per section in registers. The block reduces them (warp
//      shuffles, then the warps of a section set in order through shared
//      memory) and writes one partial row to partial[block][r][0..6K), laid
//      out as [3K of d num | 3K of d den];
//   2. sos_bwd_reduce_kernel: one thread per (r, v) sums the partials over
//      the blocks in order and writes dnum, dden (R, K, 3) float32.
// Two launches on the same inputs give the same bits. K is a template
// parameter (1..16) so the sums stay in registers.
//
// Bound on an H100: at the SVF-head shape (R = 96, K = 11, F = 65537) the
// kernel reads G and h (2 R F 8 B = 100.7 MB, 30 us at 3.35 TB/s) and w,
// and does (91 K + 11) - (32 K + 3) = 59 K + 8 fp32 operations per (r, f)
// by chip_smoke.py's count (the old count less the recompute of h: 4.1
// GFLOP, 62 us at 67 TFLOP/s outside the tensor cores): bound by
// operations. As written it issues about 44 instructions per section and
// bin. The partials are blocks x R x 6K floats, under 1 MB.

// Thread `t` of block `b` (of n_blocks in a row): its first bin, the stride
// between its bins, and its part (the sections part, part + kSplit, ...).
__device__ __forceinline__ void bwd_thread(int t, int b, int n_blocks, long long& f0,
                                           long long& stride, int& part) {
  constexpr int kBinsPerBlock = kThreads / kSplit;
  const int warp = t >> 5;
  part = warp % kSplit;
  f0 = (long long)b * kBinsPerBlock + (warp / kSplit) * 32 + (t & 31);
  stride = (long long)n_blocks * kBinsPerBlock;
}

// One thread's share of a row: its part's sections at the bins f0,
// f0 + stride, ... < n_bins, added into its 6 KT sums acc[6 i + c]
// (section i kSplit + part; d num for c < 3, d den after).
template <int K>
__device__ __forceinline__ void bwd_accumulate(const float4* coef4,
                                               const float2* __restrict__ w,
                                               const float2* __restrict__ g_row,
                                               const float2* __restrict__ h_row,
                                               long long f0, long long stride,
                                               long long n_bins, int part, float* acc) {
  constexpr int KT = (K + kSplit - 1) / kSplit;
  const float tiny = 1e-30f;
  for (long long f = f0; f < n_bins; f += stride) {
    float zre, zim, z2re, z2im;
    powers(w[f], zre, zim, z2re, z2im);
    // s = conj(G) h
    const float2 gv = g_row[f];
    const float2 hv = h_row[f];
    const float sre = __fmaf_rn(gv.x, hv.x, __fmul_rn(gv.y, hv.y));
    const float sim = __fmaf_rn(gv.x, hv.y, -__fmul_rn(gv.y, hv.x));

    // t = s / P_k and u = s / Q_k, times 1, w, w^2
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int k = i * kSplit + part;
      if (k >= K) break;  // the same for the whole warp
      const float4 c = coef4[2 * k];
      const float4 d = coef4[2 * k + 1];
      float pre, pim, qre, qim;
      poly(c.x, c.y, c.z, zre, zim, z2re, z2im, pre, pim);
      poly(c.w, d.x, d.y, zre, zim, z2re, z2im, qre, qim);
      const float ip = rcp_approx(fmaxf(__fmaf_rn(pre, pre, __fmul_rn(pim, pim)), tiny));
      const float iq = rcp_approx(fmaxf(__fmaf_rn(qre, qre, __fmul_rn(qim, qim)), tiny));
      const float tre = __fmul_rn(__fmaf_rn(sre, pre, __fmul_rn(sim, pim)), ip);
      const float tim = __fmul_rn(__fmaf_rn(sim, pre, -__fmul_rn(sre, pim)), ip);
      const float ure = __fmul_rn(__fmaf_rn(sre, qre, __fmul_rn(sim, qim)), iq);
      const float uim = __fmul_rn(__fmaf_rn(sim, qre, -__fmul_rn(sre, qim)), iq);
      float* a = acc + 6 * i;
      a[0] = __fadd_rn(a[0], tre);
      a[1] = __fmaf_rn(tre, zre, __fmaf_rn(-tim, zim, a[1]));
      a[2] = __fmaf_rn(tre, z2re, __fmaf_rn(-tim, z2im, a[2]));
      a[3] = __fsub_rn(a[3], ure);
      a[4] = __fmaf_rn(-ure, zre, __fmaf_rn(uim, zim, a[4]));
      a[5] = __fmaf_rn(-ure, z2re, __fmaf_rn(uim, z2im, a[5]));
    }
  }
}

// Where sum v of part `part` goes in a partial row [3K of d num | 3K of
// d den], or -1 past the last section.
template <int K>
__device__ __forceinline__ int bwd_slot(int part, int v) {
  const int k = (v / 6) * kSplit + part;
  const int c = v % 6;
  if (k >= K) return -1;
  return c < 3 ? 3 * k + c : 3 * K + 3 * k + c - 3;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
sos_bwd_partial_kernel(const float* __restrict__ num, const float* __restrict__ den,
                       const float2* __restrict__ w, const float2* __restrict__ g,
                       const float2* __restrict__ h, float* __restrict__ partial,
                       int n_rows, long long n_bins) {
  constexpr int KT = (K + kSplit - 1) / kSplit;  // sections per thread, at most
  constexpr int V = 6 * KT;                      // its sums
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 coef4[2 * K];
  __shared__ float warp_sums[kWarps][V];
  const int row = blockIdx.y;
  stage(num, den, row, K, coef4);
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  long long f0, stride;
  int part;
  bwd_thread(threadIdx.x, blockIdx.x, gridDim.x, f0, stride, part);
  bwd_accumulate<K>(coef4, w, g + (long long)row * n_bins, h + (long long)row * n_bins, f0,
                    stride, n_bins, part, acc);

  // block reduction: each warp's lanes by shuffles (lane 0 ends with the
  // warp's sums), then the warps of each part in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float x = acc[v];
    for (int off = 16; off >= 1; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][v] = x;
  }
  __syncthreads();
  float* out = partial + ((long long)blockIdx.x * n_rows + row) * 6 * K;
  for (int idx = threadIdx.x; idx < kSplit * V; idx += blockDim.x) {
    const int p = idx / V;
    const int slot = bwd_slot<K>(p, idx % V);
    if (slot < 0) continue;
    float total = 0.0f;
    for (int i = p; i < kWarps; i += kSplit) total = total + warp_sums[i][idx % V];
    out[slot] = total;
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

#define SOS_FWD_CASE(k)                                                       \
  case k:                                                                     \
    sos_cascade_kernel<k><<<grid, kThreads, smem, st>>>(nu, de, wi, ho, k, n_bins); \
    break;

// num, den (R, K, 3) float32; w (F,) complex64; h (R, F) complex64 device
// pointers; stream: a cudaStream_t. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for R > 65535 or coefficients past 48 KB).
extern "C" int diffgfdn_sos_cascade_c64(const void* num, const void* den, const void* w,
                                        void* h, int n_rows, int n_sec, long long n_bins,
                                        void* stream) {
  if (n_rows <= 0 || n_bins <= 0) return cudaSuccess;
  const size_t smem = sizeof(float) * 8 * (size_t)n_sec;
  if (n_rows > 65535 || smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kFwdBins;
  dim3 grid(static_cast<unsigned>((n_bins + per_block - 1) / per_block),
            static_cast<unsigned>(n_rows));
  const float* nu = static_cast<const float*>(num);
  const float* de = static_cast<const float*>(den);
  const float2* wi = static_cast<const float2*>(w);
  float2* ho = static_cast<float2*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_sec) {
    SOS_FWD_CASE(1) SOS_FWD_CASE(2) SOS_FWD_CASE(3) SOS_FWD_CASE(4) SOS_FWD_CASE(5)
    SOS_FWD_CASE(6) SOS_FWD_CASE(7) SOS_FWD_CASE(8) SOS_FWD_CASE(9) SOS_FWD_CASE(10)
    SOS_FWD_CASE(11) SOS_FWD_CASE(12) SOS_FWD_CASE(13) SOS_FWD_CASE(14) SOS_FWD_CASE(15)
    SOS_FWD_CASE(16)
    default:
      sos_cascade_kernel<0><<<grid, kThreads, smem, st>>>(nu, de, wi, ho, n_sec, n_bins);
  }
  return cudaGetLastError();
}

#define SOS_BWD_CASE(k)                                                                  \
  case k:                                                                                \
    sos_bwd_partial_kernel<k><<<grid, kThreads, 0, st>>>(nu, de, wi, gi, hi, part, n_rows, \
                                                         n_bins);                        \
    break;

// num, den (R, K, 3) float32; w (F,) complex64; g, h (R, F) complex64;
// partial (n_blocks, R, 6K) float32 scratch; dnum, dden (R, K, 3) float32;
// stream: a cudaStream_t. The partial kernel runs kThreads threads per block
// and n_blocks blocks per row. Returns cudaGetLastError() after the two
// launches (cudaErrorInvalidValue for K outside 1..16, R > 65535 or
// n_blocks < 1).
extern "C" int diffgfdn_sos_cascade_bwd_c64(const void* num, const void* den, const void* w,
                                            const void* g, const void* h, void* partial,
                                            void* dnum, void* dden, int n_rows, int n_sec,
                                            long long n_bins, int n_blocks, void* stream) {
  if (n_rows <= 0 || n_bins <= 0) return cudaSuccess;
  if (n_sec < 1 || n_sec > 16 || n_rows > 65535 || n_blocks < 1) return cudaErrorInvalidValue;
  const float* nu = static_cast<const float*>(num);
  const float* de = static_cast<const float*>(den);
  const float2* wi = static_cast<const float2*>(w);
  const float2* gi = static_cast<const float2*>(g);
  const float2* hi = static_cast<const float2*>(h);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
