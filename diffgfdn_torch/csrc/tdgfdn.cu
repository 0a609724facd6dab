// Time-domain GFDN delay-line outputs by the exact block-feedforward recursion.
//
// Replaces: diffgfdn_tpu/kernels/tdgfdn.py::_tdgfdn_kernel (tdgfdn.py:167,
// called through delay_line_outputs_pallas), reached by time-domain RIR
// synthesis with broadband (scalar) absorption.
//
// Computes, for an input u (T,), per-line gains g (N,), feedback matrix A
// (N, N), input gains b (N,) and integer delays m (N,), the delay-line outputs
//     y_i[t] = g_i * x_i[t - m_i],   x_j[t] = sum_i A[j][i] y_i[t] + b_j u[t]
// with x = 0 before t = 0, written as y (T, N) float32. Sample t's step
// reads only x at t - m_i <= t - m_min, so within a block of L <= m_min
// consecutive samples no read depends on a write of the same block: the
// block's L samples are independent and the result is exact, whatever L is.
// Each sum over i runs in ascending order from A[j][0] y_0, then b_j u[t] is
// added: the order of delay_line_outputs_plain in
// diffgfdn_torch/kernels/tdgfdn.py, so with --fmad=false every variant below
// agrees with it bit for bit.
//
// Bound on an H100: at the served shape (T = 131072, N = 12) the function
// reads u and writes y, (T + T N) x 4 B = 6.8 MB, 2.0 us at 3.35 TB/s, and
// does (2 N^2 + 2 N) T = 41 MFLOP, 0.6 us at 67 TFLOP/s. Neither sets the
// time: the T / L steps run one after another. On ONE SM the 2 N^2 + 2 N =
// 312 separately rounded fp32 instructions of a sample issue at 128 lanes a
// cycle, T 312 / (128 x 1.98 GHz) = 0.161 ms, before any other instruction
// (1.98 GHz: the SXM part's boost clock, at which 132 SMs give 67 TFLOP/s).
//
// Design. One SM issues every instruction of the recursion, so the design
// cuts what it issues besides those 312 a sample:
// * A, g and b are read once from device memory into each thread's
//   registers (Coef), every loop over lines unrolled for the template N: the
//   mix reads its coefficients as register operands, with no load per
//   product (from the constant bank, the compiler reloaded them into
//   uniform registers for every group of samples).
// * A thread takes kGroup = 2 consecutive samples at once (L and the ring
//   are multiples of 2): it loads u and stores x and each line's y as 8-byte
//   vectors, and computes each line's ring index once for both.
// * Steps of L = 512 samples where the delays allow (a multiple of 256):
//   256 groups on 8 full warps, two for each of the SM's 4 schedulers.
// * The delays and sizes travel by value in the kernel's parameters
//   (TdArgs): no copy between host and card per launch; the wrapper pads T
//   to a multiple of 2 (u with zeros, y with rows nobody reads).
// Three variants, picked by the wrapper from the sizes (ring and hist up to
// N = 12, lines above):
// * ring (tdgfdn_ring_kernel): ONE block of threads walks the steps of L
//   samples in order (the loop inside the block replaces the TPU's
//   sequential grid). Each line's last R >= m_max + L samples of x live in
//   a ring in dynamic shared memory, x_i[t] at ring[i (R + 2) + t mod R],
//   zeroed by the kernel; R is a power of two, so t mod R is a mask, and
//   slot R repeats slot 0, so a group's two reads never wrap (its first
//   index is at most R - 1); slot R + 1 only keeps rows 8-byte aligned. A
//   step's delayed reads and its writes never touch the same slot, so one
//   __syncthreads() per step is the only barrier. A thread takes groups
//   tid, tid + blockDim, ... of the step, and loads u of its first group one
//   step ahead. (A thread-block cluster sharing each step's mix over 2 or 4
//   SMs, x pushed to every block's ring through distributed shared memory
//   and one cluster barrier a step, was slower on the H100: PERF.md.)
// * hist (tdgfdn_hist_kernel): the ring does not fit in the shared memory
//   the card grants (a 50000-sample delay spread), or min(delay) < 2: the
//   history is a line-major (N, T + m_max) float32 scratch in device
//   memory, hist[i][m_max + t] = x_i[t], that the wrapper allocates and this
//   kernel zeroes up to m_max; one sample at a time. Any delay set runs.
// * lines (tdgfdn_lines_kernel), for N > 12 (the directional presets' 27
//   lines): N^2 + 2N coefficients do not fit a thread's registers (Coef<27>
//   spilled 2.8 KB a thread, so each of a sample's 729 products waited on a
//   local load). The coefficients live in shared memory instead, A's rows
//   padded to a multiple of 4 floats (LinesCoef), and each thread reads row
//   j of A as 16-byte broadcasts (every lane of a warp reads the same
//   address), about one shared-memory load per 4 products and no local
//   memory. One sample a thread: the thread keeps its sample's N outputs
//   y_i in registers (every loop over i unrolled) and takes the lines j
//   three at a time (the loop over j unrolled by 3, not fully: N^2 unrolled
//   terms would outgrow the instruction cache). The history stays in device
//   memory as hist's (the 50 MB L2 holds its 14 MB at T = 131072, N = 27),
//   so steps take L = min(delay) samples, capped at kLinesThreads; a ring of
//   m_max + L slots a line in shared memory would fit the card's 227 KB only
//   at L <= 512 (27 lines of 1601-sample delays), with more steps and so
//   more barriers. Two to four samples a thread (each load of A serving
//   each of them, at 384 to 192 threads) were not faster on the H100, nor
//   was the loop over j unrolled by 9 (PERF.md).
//
// History reads and writes and y writes of one line are consecutive across
// threads, so each warp access is conflict-free (shared) or coalesced
// (device). Written sample-major, (T, N), as 16-byte vectors of a group's
// rows, y made the ring kernel slower on the H100 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLines = 32;
constexpr int kGroup = 2;  // consecutive samples a thread of the ring variant takes

// Everything but the coefficients, by value.
struct TdArgs {
  const float* coef;   // A (N x N, row-major), then g (N), then b (N)
  const float* u;      // (T,), 8-byte aligned
  float* y;            // (N, T), 8-byte aligned
  float* hist;         // (N, T + m_max): the hist variant's scratch, else unused
  long long t_len;     // T: a multiple of kGroup for the ring variant
  int delay[kMaxLines];
  int m_max;
  int block;           // L: samples per step, 1 <= L <= min(delay); ring: a
                       // multiple of kGroup
  int ring;            // ring variant: R >= m_max + L, a power of two, slots per
                       // line
};

// The most lines whose coefficients the ring and hist variants hold in
// registers; larger N take the lines variant.
constexpr int kRegisterLines = 12;

// The loop's coefficients, read once from device memory into registers
// (every index below is a compile-time constant for the template N, so the
// array stays in registers while N^2 + 2N plus the step's working set fit
// the 255 registers a thread has: N <= kRegisterLines).
template <int N>
struct Coef {
  static_assert(N <= kRegisterLines, "larger N take the lines variant");
  float v[N * N + 2 * N];
  __device__ __forceinline__ void load(const float* __restrict__ src) {
#pragma unroll
    for (int k = 0; k < N * N + 2 * N; ++k) v[k] = src[k];
  }
  __device__ __forceinline__ float a(int j, int i) const { return v[j * N + i]; }
  __device__ __forceinline__ float g(int i) const { return v[N * N + i]; }
  __device__ __forceinline__ float b(int j) const { return v[N * N + N + j]; }
};

// x_j = sum_i A[j][i] y_i + b_j u for every line j and each of the S
// samples of yv / ut, each sum in ascending i from A[j][0] y_0, then b_j u
// added; store(j, x) with x the S samples of line j.
template <int N, int S, class Store>
__device__ __forceinline__ void mix_lines(const Coef<N>& c, const float (&yv)[S][N],
                                          const float (&ut)[S], Store store) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      float acc = c.a(j, 0) * yv[k][0];
#pragma unroll
      for (int i = 1; i < N; ++i) {
        acc = acc + c.a(j, i) * yv[k][i];
      }
      x[k] = acc + c.b(j) * ut[k];
    }
    store(j, x);
  }
}

// A group's two floats from (to) 8-byte-aligned memory.
__device__ __forceinline__ void load_group(const float* src, float (&v)[kGroup]) {
  const float2 w = *reinterpret_cast<const float2*>(src);
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void store_group(float* dst, const float (&v)[kGroup]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

// Floats per ring row: R slots, slot R repeating slot 0, one of padding.
__device__ __forceinline__ int ring_row(const TdArgs& p) { return p.ring + kGroup; }

// u of the group whose first sample is t0 (zeros past T).
__device__ __forceinline__ void group_input(const TdArgs& p, long long t0, float (&ut)[kGroup]) {
  if (t0 < p.t_len) {
    load_group(p.u + t0, ut);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) ut[k] = 0.0f;
  }
}

// y of every line for the group whose first sample has ring slot pos:
// line i reads x_i at slots pos - m_i .. + kGroup - 1 (mod R), in one piece
// thanks to the repeated slot R.
template <int N>
__device__ __forceinline__ void group_outputs(const TdArgs& p, const Coef<N>& c,
                                              const float* ring, int pos,
                                              float (&yv)[kGroup][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* src = ring + i * ring_row(p) + ((pos - p.delay[i]) & (p.ring - 1));
#pragma unroll
    for (int k = 0; k < kGroup; ++k) yv[k][i] = c.g(i) * src[k];
  }
}

// x of line j for the group at slot pos into a ring, and into the repeated
// slot R when pos is 0 (pos is a multiple of kGroup).
__device__ __forceinline__ void ring_store(const TdArgs& p, float* ring, int j, int pos,
                                           const float (&x)[kGroup]) {
  float* row = ring + j * ring_row(p);
  store_group(row + pos, x);
  if (pos == 0) row[p.ring] = x[0];
}

// Ring slot of the first sample of the next step: base + L mod R.
__device__ __forceinline__ int ring_advance(int base, const TdArgs& p) {
  return (base + p.block) & (p.ring - 1);
}

// Zero the first `count` floats, thread tid of nthreads.
__device__ __forceinline__ void zero_floats(float* buf, long long count, int tid, int nthreads) {
  for (long long k = tid; k < count; k += nthreads) buf[k] = 0.0f;
}

// One step of the ring variant for thread tid of nthreads: groups gi = tid,
// tid + nthreads, .. of the step's L / kGroup, the step's first sample start
// at ring slot base, u_first the input of group tid.
template <int N>
__device__ __forceinline__ void ring_step(const TdArgs& p, const Coef<N>& c, float* ring,
                                          long long start, int base, int tid, int nthreads,
                                          const float (&u_first)[kGroup]) {
  for (int gi = tid; gi * kGroup < p.block; gi += nthreads) {
    const long long t0 = start + gi * kGroup;
    if (t0 >= p.t_len) return;
    const int pos = (base + gi * kGroup) & (p.ring - 1);
    float ut[kGroup];
    if (gi == tid) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) ut[k] = u_first[k];
    } else {
      group_input(p, t0, ut);
    }
    float yv[kGroup][N];
    group_outputs<N>(p, c, ring, pos, yv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float out[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) out[k] = yv[k][i];
      store_group(p.y + i * p.t_len + t0, out);
    }
    mix_lines<N, kGroup>(c, yv, ut, [&](int j, const float (&x)[kGroup]) {
      ring_store(p, ring, j, pos, x);
    });
  }
}

// One step of the hist variant for thread tid of nthreads (one sample at a
// time).
template <int N>
__device__ __forceinline__ void hist_step(const TdArgs& p, const Coef<N>& c, long long start,
                                          int tid, int nthreads) {
  const long long h_len = p.t_len + p.m_max;
  for (int s = tid; s < p.block; s += nthreads) {
    const long long t = start + s;
    if (t >= p.t_len) return;
    float yv[1][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      yv[0][i] = c.g(i) * p.hist[i * h_len + (t + p.m_max - p.delay[i])];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) p.y[i * p.t_len + t] = yv[0][i];
    const float ut[1] = {p.u[t]};
    mix_lines<N, 1>(c, yv, ut, [&](int j, const float (&x)[1]) {
      p.hist[j * h_len + t + p.m_max] = x[0];
    });
  }
}

// The lines variant's coefficients in shared memory: A's N rows, then g,
// then b, each padded to kRow floats (a multiple of 4, zeros in the padding)
// so that a row loads as 16-byte vectors.
template <int N>
struct LinesCoef {
  static constexpr int kRow = (N + 3) / 4 * 4;
  static constexpr int kFloats = (N + 2) * kRow;
};

// Thread tid of nthreads copies its share of coef (A, g, b) into the padded
// rows.
template <int N>
__device__ __forceinline__ void lines_stage(const float* __restrict__ coef, float* rows, int tid,
                                            int nthreads) {
  constexpr int R = LinesCoef<N>::kRow;
  for (int k = tid; k < LinesCoef<N>::kFloats; k += nthreads) {
    const int r = k / R, c = k % R;
    rows[k] = c < N ? coef[r * N + c] : 0.0f;  // g and b follow A in coef, N apart
  }
}

// sum_i row[i] y[i] over ascending i from row[0] y[0], row 16-byte aligned.
template <int N>
__device__ __forceinline__ float lines_dot(const float* row, const float (&y)[N]) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < LinesCoef<N>::kRow / 4; ++q) {
    const float4 w = reinterpret_cast<const float4*>(row)[q];
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * q + c;
      if (i == 0) {
        acc = wv[0] * y[0];
      } else if (i < N) {
        acc = acc + wv[c] * y[i];
      }
    }
  }
  return acc;
}

// One step of the lines variant for thread tid of nthreads (one sample at a
// time): y_i = g_i x_i[t - m_i] from the history, written out and kept in
// registers; then x_j[t] = sum_i A[j][i] y_i + b_j u[t] into the history,
// three lines at a time (their sums interleave).
template <int N>
__device__ __forceinline__ void lines_step(const TdArgs& p, const float* rows, long long start,
                                           int tid, int nthreads) {
  constexpr int R = LinesCoef<N>::kRow;
  const long long h_len = p.t_len + p.m_max;
  for (int s = tid; s < p.block; s += nthreads) {
    const long long t = start + s;
    if (t >= p.t_len) return;
    float yv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      yv[i] = rows[N * R + i] * p.hist[i * h_len + (t + p.m_max - p.delay[i])];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) p.y[i * p.t_len + t] = yv[i];
    const float u = p.u[t];
#pragma unroll 3
    for (int j = 0; j < N; ++j) {
      const float acc = lines_dot<N>(rows + j * R, yv);
      p.hist[j * h_len + t + p.m_max] = acc + rows[(N + 1) * R + j] * u;
    }
  }
}

// Zero the hist variant's history before t = 0 (its first m_max columns).
__device__ __forceinline__ void hist_zero(const TdArgs& p, int n, int tid, int nthreads) {
  const long long h_len = p.t_len + p.m_max;
  for (long long k = tid; k < (long long)n * p.m_max; k += nthreads) {
    p.hist[(k / p.m_max) * h_len + k % p.m_max] = 0.0f;
  }
}

#ifdef __CUDACC__
// The kernels and their launches (nvcc only; the host build of the tests
// drives the step functions above).

constexpr int kMaxThreads = 256;  // up to 255 registers a thread

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
tdgfdn_ring_kernel(__grid_constant__ const TdArgs p) {
  extern __shared__ float4 ring4[];  // N rows of R + kGroup floats
  float* ring = reinterpret_cast<float*>(ring4);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  zero_floats(ring, (long long)N * ring_row(p), tid, nthreads);
  Coef<N> c;
  c.load(p.coef);
  float u_cur[kGroup];
  group_input(p, (long long)tid * kGroup, u_cur);
  __syncthreads();
  int base = 0;
  for (long long start = 0; start < p.t_len; start += p.block) {
    // u of the next step's first group, loaded while this step runs
    float u_next[kGroup];
    group_input(p, start + p.block + (long long)tid * kGroup, u_next);
    ring_step<N>(p, c, ring, start, base, tid, nthreads, u_cur);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) u_cur[k] = u_next[k];
    base = ring_advance(base, p);
    __syncthreads();
  }
}

template <int N>
__global__ void __launch_bounds__(kMaxThreads) tdgfdn_hist_kernel(__grid_constant__ const TdArgs p) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  hist_zero(p, N, tid, nthreads);
  Coef<N> c;
  c.load(p.coef);
  __syncthreads();
  for (long long start = 0; start < p.t_len; start += p.block) {
    hist_step<N>(p, c, start, tid, nthreads);
    __syncthreads();
  }
}

constexpr int kLinesThreads = 768;  // up to 85 registers a thread

template <int N>
__global__ void __launch_bounds__(kLinesThreads)
tdgfdn_lines_kernel(__grid_constant__ const TdArgs p) {
  __shared__ __align__(16) float rows[LinesCoef<N>::kFloats];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  hist_zero(p, N, tid, nthreads);
  lines_stage<N>(p.coef, rows, tid, nthreads);
  __syncthreads();
  for (long long start = 0; start < p.t_len; start += p.block) {
    lines_step<N>(p, rows, start, tid, nthreads);
    __syncthreads();
  }
}

enum Variant { kHist = 0, kRing = 1, kLines = 2 };

template <int N>
cudaError_t launch_n(const TdArgs& p, int variant, int threads, cudaStream_t st) {
  if constexpr (N > kRegisterLines) {
    if (variant != kLines || threads > kLinesThreads) return cudaErrorInvalidValue;
    tdgfdn_lines_kernel<N><<<1, threads, 0, st>>>(p);
    return cudaGetLastError();
  } else {
    if (threads > kMaxThreads) return cudaErrorInvalidValue;
    if (variant == kHist) {
      tdgfdn_hist_kernel<N><<<1, threads, 0, st>>>(p);
      return cudaGetLastError();
    }
    if (variant != kRing || p.block % kGroup || p.t_len % kGroup) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * N * static_cast<size_t>(p.ring + kGroup);
    const cudaError_t err = cudaFuncSetAttribute(
        tdgfdn_ring_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    tdgfdn_ring_kernel<N><<<1, threads, smem, st>>>(p);
    return cudaGetLastError();
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

#define TD_CASE(n)                                   \
  case n:                                            \
    err = launch_n<n>(p, variant, threads, st);      \
    break;

// coef: A (N x N row-major), g (N), b (N) as N^2 + 2N contiguous float32 on
// the device; u (T,) and y (N, T) float32 device pointers, 8-byte aligned;
// hist: (N, T + m_max) float32 device scratch for variants 0 and 2, else
// unused; delays (N,) int32 in HOST memory (copied into the kernel's
// parameters); block: samples per step, 1 <= block <= min(delays); threads:
// 1..256 (variant 2: 1..768); ring: for variant 1, slots per line, a power
// of two >= m_max + block, with block and T multiples of kGroup = 2 and
// N (ring + 2) floats of shared memory a block; variant: 0 hist or 1 ring
// for N <= 12, 2 lines for N > 12; stream: a cudaStream_t.
// Returns the launch's CUDA error (cudaErrorInvalidValue for an
// unsupported N, variant or size).
extern "C" int diffgfdn_tdgfdn_f32(const void* coef, const void* u, void* y, void* hist,
                                   const int* delays, long long t_len, int n, int block,
                                   int threads, int ring, int variant, void* stream) {
  if (t_len <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxLines || threads < 1 || block < 1) {
    return cudaErrorInvalidValue;
  }
  TdArgs p = {};
  p.coef = static_cast<const float*>(coef);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<float*>(y);
  p.hist = static_cast<float*>(hist);
  p.t_len = t_len;
  p.block = block;
  p.ring = ring;
  for (int i = 0; i < n; ++i) {
    if (delays[i] < block) return cudaErrorInvalidValue;
    p.delay[i] = delays[i];
    p.m_max = delays[i] > p.m_max ? delays[i] : p.m_max;
  }
  if (variant == kRing && (ring < p.m_max + block || (ring & (ring - 1)))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (n) {
    TD_CASE(1) TD_CASE(2) TD_CASE(3) TD_CASE(4) TD_CASE(5) TD_CASE(6) TD_CASE(7)
    TD_CASE(8) TD_CASE(9) TD_CASE(10) TD_CASE(11) TD_CASE(12) TD_CASE(13) TD_CASE(14)
    TD_CASE(15) TD_CASE(16) TD_CASE(17) TD_CASE(18) TD_CASE(19) TD_CASE(20) TD_CASE(21)
    TD_CASE(22) TD_CASE(23) TD_CASE(24) TD_CASE(25) TD_CASE(26) TD_CASE(27) TD_CASE(28)
    TD_CASE(29) TD_CASE(30) TD_CASE(31) TD_CASE(32)
    default:
      err = cudaErrorInvalidValue;
  }
  return err;
}

// The shared memory one block may take on `device` (the opt-in limit), in
// bytes, or -1 on error.
extern "C" int diffgfdn_tdgfdn_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

#endif  // __CUDACC__
