// The grid trainer's energy-decay losses, forward and backward: the EDC loss
// (B8) and the EDR loss (B9).
//
// Replaces no TPU kernel. The JAX package computes both Schroeder integrals
// with lax.cumsum(reverse=True) inside XLA (losses/gfdn.py edc_loss_from_rir,
// ops/stft.py edr_from_stft); the port's plain versions
// (diffgfdn_torch/kernels/decay.py) flip, cumsum and flip, and autograd adds
// as many passes again. Here each loss is one forward and one backward call,
// with the decibels, the |difference| and the reductions fused into the
// integrals.
//
// EDC (few long rows: 32 rows of 38 720-46 592 samples in the cells). Each
// row of T samples (rows at stride ld: the window of the irfft output, read
// in place) is split into chunks of kThreads * run samples; the wrapper picks run from the rows
// and T it sees, so that the card's SMs fill (some 1000 blocks at the cells'
// shapes). The forward is three kernels: each chunk's energy total; each
// chunk's reverse integral (its carry is the totals of all later chunks,
// combined from the end; inside the chunk each thread sums its run of samples
// from the last to the first in shared memory, warp shuffles and the warps'
// totals combine the runs, again the later first), with
// D = clamp(10 log10(|E| + eps), -200), |target - D| (times the mask) and
// the local derivative h = dloss/dE without the loss's outer factor, written
// only when a gradient is wanted; then one block reduces the chunks' partial
// sums in a fixed order (no atomics) to each slice's loss, and writes the
// normaliser (sum(mask) * items + 1e-9, or items * T). The backward is the
// same chunked scan in the forward direction over g = coef * h
// (coef = the loss's gradient / the normaliser): dloss/dx_u =
// 2 x_u sum_{t <= u} g_t, written to a (rows, T) gradient.
//
// EDR (many short rows: 32 x 2049 bins of 63 frames). One thread a bin (or
// ERB band) runs from the last frame to the first in registers, reading the
// STFT where torch.fft.rfft wrote it ((B, frames, bins) complex, taken by
// strides, so neighbouring threads read neighbouring bins); the target
// (B, bins, frames) is staged through shared memory kSeg frames at a time
// (rows of kSeg + 1 floats, so the column reads are free of bank conflicts).
// Each block sums its bins' weighted errors; one block divides each item's
// sum by its target sum and adds the items. h is stored frame-major
// (B, frames, bins), coalesced for both passes. The backward runs forward in
// frames in registers: gP = sum_{m' <= m} coef h, and writes 2 gP s in the
// input's layout.
//
// Rules shared with PyTorch's autograd through the plain versions: sgn(0) = 0
// (a tie |target - D| = 0 and an energy E = 0 give no gradient), and the
// clamp lets the gradient through where 10 log10(|E| + eps) >= -200, the
// limit included. Every product and sum is rounded on its own (the build's
// --fmad=false). Sums run in another order than PyTorch's scans and
// reductions, so the kernels agree with the plain versions within a
// tolerance (1e-6 of the loss, 1e-5 of the gradient), not bit for bit.
//
// Bound on an H100 (3.35 TB/s): the EDC forward reads the window and the
// target and writes h (12 B a sample: 18 MB at fullband's 32 x 46 592,
// 5.3 us), its backward reads the window and h and writes the gradient
// (12 B a sample: 18 MB, 5.3 us); the EDR forward
// reads 8 B of STFT and 4 B of target and writes 4 B of h a (bin, frame)
// (33 MB at 32 x 2049 x 63, 9.9 us), its backward reads 12 B and writes 8 B
// (41 MB, 12.3 us). A few fp32 operations and one log10 a sample: bound by
// bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // EDC blocks and the final reductions
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 128;  // EDR blocks: a bin (or band) a thread
constexpr int kSeg = 32;    // EDR: frames of the target staged at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 eps, as ops/basic.py db
constexpr float kFloorDb = -200.0f;
constexpr float kLn10 = 2.302585092994046f;

// shared-memory index of sample k of a chunk: one float of padding every 32,
// so that a thread's run (consecutive samples) and its neighbours' fall in
// different banks
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

// D = clamp(10 log10(|e| + eps), -200) as db(e, is_squared=True); y = |e| + eps;
// pass: torch.clamp's backward lets the gradient through (x >= min)
struct Decibel {
  float y, d;
  bool pass;
};

__device__ __forceinline__ Decibel decibel(float e) {
  Decibel r;
  r.y = __fadd_rn(fabsf(e), kEps);
  const float d = __fmul_rn(10.0f, log10f(r.y));
  r.pass = d >= kFloorDb;
  r.d = d < kFloorDb ? kFloorDb : d;
  return r;
}

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// d|t - D(e)| / de = sgn(D - t) [pass] 10 / (y ln 10) sgn(e)
__device__ __forceinline__ float local_derivative(float t, const Decibel& db, float e) {
  if (!db.pass) return 0.0f;
  const float slope = __fdiv_rn(10.0f, __fmul_rn(db.y, kLn10));
  return __fmul_rn(__fmul_rn(-sgn(__fsub_rn(t, db.d)), slope), sgn(e));
}

// the block's sum of v, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, d));
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total = __fadd_rn(total, red[w]);
  return total;
}

// ---------------------------------- EDC ----------------------------------

// each chunk's energy sum_t x_t^2; the blocks of row 0 also sum the mask's
// chunk
__global__ void __launch_bounds__(kThreads) edc_loss_totals_kernel(
    const float* __restrict__ x, long long ld, int t_len, int chunk,
    const float* __restrict__ mask, float* __restrict__ totals,
    float* __restrict__ mask_partial) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, r = blockIdx.y;
  const int lo = c * chunk, hi = min(lo + chunk, t_len);
  const float* xr = x + r * ld;
  float s = 0.0f;
  for (int t = lo + threadIdx.x; t < hi; t += kThreads) s = __fadd_rn(s, __fmul_rn(xr[t], xr[t]));
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) totals[(long long)r * gridDim.x + c] = total;
  if (mask != nullptr && r == 0) {
    float m = 0.0f;
    for (int t = lo + threadIdx.x; t < hi; t += kThreads) m = __fadd_rn(m, mask[t]);
    const float mt = block_sum(m, red);
    if (threadIdx.x == 0) mask_partial[c] = mt;
  }
}

// E over a chunk (its reverse integral plus the later chunks' energy), the
// error against the target, and h
__global__ void __launch_bounds__(kThreads) edc_loss_fwd_kernel(
    const float* __restrict__ x, long long ld, int t_len, int run,
    const float* __restrict__ totals, const float* __restrict__ target,
    const float* __restrict__ mask, float* __restrict__ h, float* __restrict__ partial) {
  extern __shared__ float s[];  // the chunk's x^2, then its E
  __shared__ float warp_sum[kWarps];
  __shared__ float red[kWarps];
  __shared__ float carry_s;
  const int c = blockIdx.x, r = blockIdx.y, chunks = gridDim.x;
  const int chunk = kThreads * run, lo = c * chunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xr = x + r * ld;
  for (int k = threadIdx.x; k < chunk; k += kThreads) {
    const int t = lo + k;
    const float v = t < t_len ? xr[t] : 0.0f;
    s[pad(k)] = __fmul_rn(v, v);
  }
  if (threadIdx.x == 0) {  // the energy of every later chunk, combined from the end
    const float* tr = totals + (long long)r * chunks;
    float carry = 0.0f;
    for (int j = chunks - 1; j > c; --j) carry = __fadd_rn(carry, tr[j]);
    carry_s = carry;
  }
  __syncthreads();
  // the thread's run, summed from its last sample to its first
  const int base = threadIdx.x * run;
  float acc = 0.0f;
  for (int j = run - 1; j >= 0; --j) {
    const int p = pad(base + j);
    acc = __fadd_rn(acc, s[p]);
    s[p] = acc;
  }
  // the later lanes' runs (suffix sums across the warp) ...
  float incl = acc;
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_down_sync(kFull, incl, d);
    if (lane + d < 32) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) excl = 0.0f;
  if (lane == 0) warp_sum[warp] = incl;
  __syncthreads();
  // ... after the later chunks' and the later warps' energy, from the end
  float later = carry_s;
  for (int w = kWarps - 1; w > warp; --w) later = __fadd_rn(later, warp_sum[w]);
  const float off = __fadd_rn(later, excl);
  for (int j = 0; j < run; ++j) {
    const int p = pad(base + j);
    s[p] = __fadd_rn(s[p], off);
  }
  __syncthreads();
  const float* tr = target + (long long)r * t_len;
  float* hr = h != nullptr ? h + (long long)r * t_len : nullptr;
  float err = 0.0f;
  for (int k = threadIdx.x; k < chunk; k += kThreads) {
    const int t = lo + k;
    if (t >= t_len) break;
    const float e = s[pad(k)];
    const Decibel db = decibel(e);
    const float m = mask != nullptr ? mask[t] : 1.0f;
    const float tt = tr[t];
    err = __fadd_rn(err, __fmul_rn(fabsf(__fsub_rn(tt, db.d)), m));
    if (hr != nullptr) hr[t] = __fmul_rn(m, local_derivative(tt, db, e));
  }
  const float total = block_sum(err, red);
  if (threadIdx.x == 0) partial[(long long)r * chunks + c] = total;
}

// the normaliser, and each slice's loss: its rows' chunk sums over it
__global__ void __launch_bounds__(kThreads) edc_loss_final_kernel(
    const float* __restrict__ partial, int chunks, const float* __restrict__ mask_partial,
    int items, int t_len, int slices, float* __restrict__ loss, float* __restrict__ norm) {
  __shared__ float red[kWarps];
  __shared__ float norm_s;
  if (threadIdx.x == 0) {
    float nrm;
    if (mask_partial != nullptr) {
      float msum = 0.0f;
      for (int c = 0; c < chunks; ++c) msum = __fadd_rn(msum, mask_partial[c]);
      nrm = __fadd_rn(__fmul_rn(msum, (float)items), 1e-9f);
    } else {
      nrm = (float)((long long)items * t_len);
    }
    norm_s = nrm;
    norm[0] = nrm;
  }
  const int per_slice = items * chunks;
  for (int sl = 0; sl < slices; ++sl) {
    const float* ps = partial + (long long)sl * per_slice;
    float v = 0.0f;
    for (int k = threadIdx.x; k < per_slice; k += kThreads) v = __fadd_rn(v, ps[k]);
    const float total = block_sum(v, red);
    if (threadIdx.x == 0) loss[sl] = __fdiv_rn(total, norm_s);
  }
}

// each chunk's sum of g = coef h
__global__ void __launch_bounds__(kThreads) edc_loss_bwd_totals_kernel(
    const float* __restrict__ h, const float* __restrict__ g, const float* __restrict__ norm,
    int items, int t_len, int chunk, float* __restrict__ totals) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, r = blockIdx.y, chunks = gridDim.x;
  const float coef = __fdiv_rn(g[r / items], norm[0]);
  const int lo = c * chunk, hi = min(lo + chunk, t_len);
  const float* hr = h + (long long)r * t_len;
  float s = 0.0f;
  for (int t = lo + threadIdx.x; t < hi; t += kThreads) s = __fadd_rn(s, __fmul_rn(coef, hr[t]));
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) totals[(long long)r * chunks + c] = total;
}

// gP over a chunk (its forward integral plus the earlier chunks' sums), then
// dloss/dx = 2 x gP
__global__ void __launch_bounds__(kThreads) edc_loss_bwd_kernel(
    const float* __restrict__ x, long long ld, const float* __restrict__ h,
    const float* __restrict__ g, const float* __restrict__ norm, int items, int t_len, int run,
    const float* __restrict__ totals, float* __restrict__ grad) {
  extern __shared__ float s[];  // the chunk's g, then gP
  __shared__ float warp_sum[kWarps];
  __shared__ float carry_s;
  const int c = blockIdx.x, r = blockIdx.y, chunks = gridDim.x;
  const int chunk = kThreads * run, lo = c * chunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float coef = __fdiv_rn(g[r / items], norm[0]);
  const float* hr = h + (long long)r * t_len;
  for (int k = threadIdx.x; k < chunk; k += kThreads) {
    const int t = lo + k;
    s[pad(k)] = t < t_len ? __fmul_rn(coef, hr[t]) : 0.0f;
  }
  if (threadIdx.x == 0) {  // every earlier chunk's sum, combined from the start
    const float* tr = totals + (long long)r * chunks;
    float carry = 0.0f;
    for (int j = 0; j < c; ++j) carry = __fadd_rn(carry, tr[j]);
    carry_s = carry;
  }
  __syncthreads();
  const int base = threadIdx.x * run;
  float acc = 0.0f;
  for (int j = 0; j < run; ++j) {
    const int p = pad(base + j);
    acc = __fadd_rn(acc, s[p]);
    s[p] = acc;
  }
  float incl = acc;
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  float earlier = carry_s;
  for (int w = 0; w < warp; ++w) earlier = __fadd_rn(earlier, warp_sum[w]);
  const float off = __fadd_rn(earlier, excl);
  for (int j = 0; j < run; ++j) {
    const int p = pad(base + j);
    s[p] = __fadd_rn(s[p], off);
  }
  __syncthreads();
  const float* xr = x + r * ld;
  float* gr = grad + (long long)r * t_len;
  for (int k = threadIdx.x; k < chunk; k += kThreads) {
    const int t = lo + k;
    if (t >= t_len) break;
    gr[t] = __fmul_rn(2.0f, __fmul_rn(s[pad(k)], xr[t]));
  }
}

// ---------------------------------- EDR ----------------------------------

template <bool kComplex>
__device__ __forceinline__ float power_at(const void* x, long long i) {
  if constexpr (kComplex) {
    const float2 v = static_cast<const float2*>(x)[i];
    return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  } else {
    const float v = static_cast<const float*>(x)[i];
    return __fmul_rn(v, v);
  }
}

// a thread a bin: E from the last frame to the first, |target - D| summed and
// weighted; h frame-major
template <bool kComplex>
__global__ void __launch_bounds__(kBins) edr_loss_fwd_kernel(
    const void* __restrict__ x, long long sb, long long sf, long long sm, int bins, int frames,
    const float* __restrict__ target, const float* __restrict__ weights, float* __restrict__ h,
    float* __restrict__ partial) {
  __shared__ float tile[kBins * (kSeg + 1)];
  __shared__ float red[kBins / 32];
  const int b = blockIdx.y, f0 = blockIdx.x * kBins, f = f0 + threadIdx.x;
  const bool live = f < bins;
  const int rows = min(kBins, bins - f0);
  const float* tb = target + ((long long)b * bins + f0) * frames;
  const float w = live && weights != nullptr ? weights[f] : 1.0f;
  const long long at = b * sb + (long long)f * sf;
  float e = 0.0f, err = 0.0f;
  for (int hi = frames; hi > 0; hi -= kSeg) {
    const int lo = max(0, hi - kSeg), len = hi - lo;
    __syncthreads();  // the previous segment has been read
    for (int k = threadIdx.x; k < rows * len; k += kBins) {
      const int row = k / len, col = k - row * len;
      tile[row * (kSeg + 1) + col] = tb[(long long)row * frames + lo + col];
    }
    __syncthreads();
    if (live) {
      const float* trow = tile + threadIdx.x * (kSeg + 1);
#pragma unroll 4
      for (int m = hi - 1; m >= lo; --m) {
        e = __fadd_rn(e, power_at<kComplex>(x, at + m * sm));
        const Decibel db = decibel(e);
        const float t = trow[m - lo];
        err = __fadd_rn(err, fabsf(__fsub_rn(t, db.d)));
        if (h != nullptr)
          h[((long long)b * frames + m) * bins + f] = __fmul_rn(w, local_derivative(t, db, e));
      }
    }
  }
  const float total = block_sum(live ? __fmul_rn(err, w) : 0.0f, red);
  if (threadIdx.x == 0) partial[(long long)b * gridDim.x + blockIdx.x] = total;
}

// each slice's loss: per item the sum of its blocks over its target sum
__global__ void __launch_bounds__(kThreads) edr_loss_final_kernel(
    const float* __restrict__ partial, int tiles, const float* __restrict__ abs_sum, int items,
    int slices, float* __restrict__ loss) {
  __shared__ float red[kWarps];
  for (int sl = 0; sl < slices; ++sl) {
    float v = 0.0f;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const long long b = (long long)sl * items + i;
      float s = 0.0f;
      for (int j = 0; j < tiles; ++j) s = __fadd_rn(s, partial[b * tiles + j]);
      v = __fadd_rn(v, __fdiv_rn(s, abs_sum[b]));
    }
    const float total = block_sum(v, red);
    if (threadIdx.x == 0) loss[sl] = total;
  }
}

// a thread a bin: gP from the first frame on, 2 gP s in the input's layout
template <bool kComplex>
__global__ void __launch_bounds__(kBins) edr_loss_bwd_kernel(
    const void* __restrict__ x, long long sb, long long sf, long long sm, long long gb,
    long long gf, long long gm, int bins, int frames, const float* __restrict__ h,
    const float* __restrict__ g, const float* __restrict__ abs_sum, int items,
    void* __restrict__ grad) {
  const int b = blockIdx.y, f = blockIdx.x * kBins + threadIdx.x;
  if (f >= bins) return;
  const float coef = __fdiv_rn(g[b / items], abs_sum[b]);
  const float* hb = h + (long long)b * frames * bins + f;
  const long long xa = b * sb + (long long)f * sf, ga = b * gb + (long long)f * gf;
  float gp = 0.0f;
#pragma unroll 4
  for (int m = 0; m < frames; ++m) {
    gp = __fadd_rn(gp, __fmul_rn(coef, hb[(long long)m * bins]));
    if constexpr (kComplex) {
      const float2 v = static_cast<const float2*>(x)[xa + m * sm];
      static_cast<float2*>(grad)[ga + m * gm] =
          make_float2(__fmul_rn(2.0f, __fmul_rn(gp, v.x)), __fmul_rn(2.0f, __fmul_rn(gp, v.y)));
    } else {
      const float v = static_cast<const float*>(x)[xa + m * sm];
      static_cast<float*>(grad)[ga + m * gm] = __fmul_rn(2.0f, __fmul_rn(gp, v));
    }
  }
}

}  // namespace

extern "C" {

// B8 forward. x: row 0's first sample (rows at stride ld);
// target (rows, t_len); mask (t_len,) or null; h (rows, t_len) or null;
// scratch (2 rows chunks + chunks); loss (rows / items); norm (1).
int diffgfdn_edc_loss_fwd(const float* x, long long ld, const float* target, const float* mask,
                          float* h, float* scratch, float* loss, float* norm, int rows,
                          int t_len, int items, int chunks, int run, cudaStream_t stream) {
  const dim3 grid(chunks, rows);
  const size_t smem = sizeof(float) * (kThreads * run + (kThreads * run) / 32);
  float* totals = scratch;
  float* partial = scratch + (long long)rows * chunks;
  float* mask_partial = mask != nullptr ? partial + (long long)rows * chunks : nullptr;
  edc_loss_totals_kernel<<<grid, kThreads, 0, stream>>>(x, ld, t_len, kThreads * run, mask,
                                                        totals, mask_partial);
  edc_loss_fwd_kernel<<<grid, kThreads, smem, stream>>>(x, ld, t_len, run, totals, target, mask,
                                                        h, partial);
  edc_loss_final_kernel<<<1, kThreads, 0, stream>>>(partial, chunks, mask_partial, items, t_len,
                                                    rows / items, loss, norm);
  return cudaGetLastError();
}

// B8 backward. x as the forward's; h and norm the forward's; g (rows / items);
// grad (rows, t_len); scratch (rows chunks).
int diffgfdn_edc_loss_bwd(const float* x, long long ld, const float* h, const float* g,
                          const float* norm, float* grad, float* scratch, int rows, int t_len,
                          int items, int chunks, int run, cudaStream_t stream) {
  const dim3 grid(chunks, rows);
  const size_t smem = sizeof(float) * (kThreads * run + (kThreads * run) / 32);
  edc_loss_bwd_totals_kernel<<<grid, kThreads, 0, stream>>>(h, g, norm, items, t_len,
                                                            kThreads * run, scratch);
  edc_loss_bwd_kernel<<<grid, kThreads, smem, stream>>>(x, ld, h, g, norm, items, t_len, run,
                                                        scratch, grad);
  return cudaGetLastError();
}

// B9 forward. x: complex64 (is_complex) or float32 at strides (sb, sf, sm) in
// elements; target (rows, bins, frames); weights (bins) or null; h
// (rows, frames, bins) or null; scratch (rows ceil(bins / 128)); abs_sum
// (rows); loss (rows / items).
int diffgfdn_edr_loss_fwd(const void* x, int is_complex, long long sb, long long sf,
                          long long sm, const float* target, const float* weights, float* h,
                          float* scratch, const float* abs_sum, float* loss, int rows, int bins,
                          int frames, int items, cudaStream_t stream) {
  const int tiles = (bins + kBins - 1) / kBins;
  const dim3 grid(tiles, rows);
  if (is_complex)
    edr_loss_fwd_kernel<true><<<grid, kBins, 0, stream>>>(x, sb, sf, sm, bins, frames, target,
                                                          weights, h, scratch);
  else
    edr_loss_fwd_kernel<false><<<grid, kBins, 0, stream>>>(x, sb, sf, sm, bins, frames, target,
                                                           weights, h, scratch);
  edr_loss_final_kernel<<<1, kThreads, 0, stream>>>(scratch, tiles, abs_sum, items,
                                                    rows / items, loss);
  return cudaGetLastError();
}

// B9 backward. x as the forward's; grad of x's type at strides (gb, gf, gm);
// h the forward's; g (rows / items).
int diffgfdn_edr_loss_bwd(const void* x, int is_complex, long long sb, long long sf,
                          long long sm, void* grad, long long gb, long long gf, long long gm,
                          const float* h, const float* g, const float* abs_sum, int rows,
                          int bins, int frames, int items, cudaStream_t stream) {
  const dim3 grid((bins + kBins - 1) / kBins, rows);
  if (is_complex)
    edr_loss_bwd_kernel<true><<<grid, kBins, 0, stream>>>(x, sb, sf, sm, gb, gf, gm, bins,
                                                          frames, h, g, abs_sum, items, grad);
  else
    edr_loss_bwd_kernel<false><<<grid, kBins, 0, stream>>>(x, sb, sf, sm, gb, gf, gm, bins,
                                                           frames, h, g, abs_sum, items, grad);
  return cudaGetLastError();
}

}  // extern "C"
