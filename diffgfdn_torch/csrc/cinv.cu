// Batched complex inverse by Gauss-Jordan elimination with partial pivoting,
// and its vector-Jacobian product -P^H G P^H.
//
// Replaces: diffgfdn_tpu/kernels/pallas_cinv.py::_gj_kernel (cinv_pallas),
// which FeedbackLoop._inv calls for the per-bin loop matrices, and
// ::_ptgpt_kernel (neg_ptgpt_pallas), the inverse's backward (second part of
// this file).
//
// Computes, for each of K independent systems, inv(M) of an N x N complex64
// matrix: row-reduce [M | I] with the pivot of step k taken as the FIRST row
// r >= k that maximises |M[r][k]|^2, rows k and p swapped, the pivot row
// scaled by 1/pivot (as conj(pivot) / |pivot|^2) and column k eliminated from
// every other row. The order of operations is that of _gj_kernel and of the
// plain version in diffgfdn_torch/kernels/cinv.py; built with --fmad=false
// they round alike, so pivots and results agree bit for bit.
//
// Layout: input and output (K, N, N) complex64, contiguous, 8-byte aligned
// (float2 per element). Any 1 <= N <= 32 (a switch over template
// instantiations).
//
// Bound on an H100: at the serving shape (K = 3 x 65537, N = 4) the kernel
// must read and write 2 x K x N^2 x 8 B = 50 MB, 15 us at 3.35 TB/s, against
// about 16 N^3 = 1 kFLOP of fp32 work per system (0.2 GFLOP, 3 us at
// 67 TFLOP/s): memory bound.
//
// Design. Each thread solves one system in registers, but for N <= 8 (the
// served and trained shapes) the block stages its tile of T consecutive
// systems through shared memory with asynchronous copies, so that device
// memory sees whole coalesced lines: copy step c of thread t moves element
// c * T + t of the tile,
// neighbouring threads on neighbouring 8-byte elements (an 8-byte-aligned
// base is enough: a view with an odd storage offset takes the same path).
// In shared memory a system's slot is N^2 | 1 float2 long, an odd stride, so
// the 16 threads of a half warp reading element j of their own systems hit
// 16 different bank pairs. The thread inverts its slot in place, the block
// synchronises and writes the tile back the same way. The last tile is
// partial: the copies mask by element, the solves by system. For N > 8 the
// register arrays spill and a tile of N = 27 systems does not fit in shared
// memory, so each thread reads and writes its own system directly (the L1
// merges its contiguous 8 N^2 bytes into lines). On an H100 80GB HBM3 at
// 700 W (chip_smoke.py --kernel-times) the serving shape takes 0.025 ms,
// against 0.118 ms with each thread reading its own system (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiledN = 8;
constexpr int kThreads = 128;  // threads per block of the untiled kernels (N > 8)

// Systems per tile (also the block's thread count) and the shared-memory
// layout of the tiled kernels (N <= kMaxTiledN).
template <int N>
struct Tile {
  static constexpr int kElems = N * N;        // complex elements of one system
  static constexpr int kStride = kElems | 1;  // float2 per system slot: odd
  static constexpr int kSystems = N <= 4 ? 128 : (N <= 6 ? 64 : 32);
};

template <int N>
constexpr int block_threads() {
  if constexpr (N <= kMaxTiledN) {
    return Tile<N>::kSystems;
  } else {
    return kThreads;
  }
}

// Copy step c of this thread moves element c * T + threadIdx.x of the tile.
template <int N>
__device__ __forceinline__ int copy_element(int c) {
  return c * Tile<N>::kSystems + static_cast<int>(threadIdx.x);
}

// Element e of the tile (element e % N^2 of system e / N^2) lives in this
// slot of shared memory.
template <int N>
__device__ __forceinline__ int tile_slot(int e) {
  return (e / Tile<N>::kElems) * Tile<N>::kStride + e % Tile<N>::kElems;
}

// One 8-byte copy from device memory into shared memory: on the card an
// asynchronous copy (cp.async, no registers held while it is in flight),
// complete after copy_wait(); elsewhere a plain assignment.
__device__ __forceinline__ void copy_to_shared(float2* dst, const float2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// Waits for this thread's copies into shared memory.
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Starts the copies of the first `count` elements of src (the tile's
// systems, contiguous) into their slots: each thread takes N^2 copy steps,
// all in flight at once; copy_wait() and a barrier make them visible.
template <int N>
__device__ __forceinline__ void tile_load(const float2* __restrict__ src, float2* tile,
                                          int count) {
#pragma unroll
  for (int c = 0; c < Tile<N>::kElems; ++c) {
    const int e = copy_element<N>(c);
    if (e < count) copy_to_shared(tile + tile_slot<N>(e), src + e);
  }
}

// The slots of the first `count` elements back to dst, as tile_load read them.
template <int N>
__device__ __forceinline__ void tile_store(const float2* tile, float2* __restrict__ dst,
                                           int count) {
#pragma unroll
  for (int c = 0; c < Tile<N>::kElems; ++c) {
    const int e = copy_element<N>(c);
    if (e < count) dst[e] = tile[tile_slot<N>(e)];
  }
}

// The inverse of one system: a_in and a_out hold N x N float2, row-major;
// they may be the same slot (every input is read before the first output is
// written). For N <= 8 the loops unroll completely, so every array index is
// a constant and ar / ai stay in registers; larger N keep them in local
// memory.
template <int N>
__device__ __forceinline__ void gj_inverse(const float2* a_in, float2* a_out) {
  constexpr bool kUnrolled = N <= 8;
  constexpr int U = kUnrolled ? N : 1;
  constexpr int U2 = kUnrolled ? 2 * N : 1;
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
    // swap rows k and p (columns < k of both rows are never read again);
    // unrolled, by selects: a branch per candidate row would let the
    // compiler merge the branches' stores into one store at a run-time row
    // index, which puts the arrays in local memory
    if constexpr (kUnrolled) {
#pragma unroll
      for (int r = k + 1; r < N; ++r) {
        const bool swap = r == p;
#pragma unroll
        for (int c = k; c < 2 * N; ++c) {
          const float kr = ar[k][c], ki = ai[k][c], rr = ar[r][c], ri = ai[r][c];
          ar[k][c] = swap ? rr : kr;
          ai[k][c] = swap ? ri : ki;
          ar[r][c] = swap ? kr : rr;
          ai[r][c] = swap ? ki : ri;
        }
      }
    } else if (p != k) {
      for (int c = k; c < 2 * N; ++c) {
        const float tr = ar[k][c], ti = ai[k][c];
        ar[k][c] = ar[p][c];
        ai[k][c] = ai[p][c];
        ar[p][c] = tr;
        ai[p][c] = ti;
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

#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      a_out[r * N + c] = make_float2(ar[r][N + c], ai[r][N + c]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(block_threads<N>())
cinv_kernel(const float2* __restrict__ m, float2* __restrict__ out, long long k_sys) {
  if constexpr (N <= kMaxTiledN) {
    constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems;
    __shared__ float2 tile[T * Tile<N>::kStride];
    const long long first = blockIdx.x * static_cast<long long>(T);
    const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
    tile_load<N>(m + first * E, tile, systems * E);
    copy_wait();
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < systems) {
      float2* slot = tile + threadIdx.x * Tile<N>::kStride;
      gj_inverse<N>(slot, slot);
    }
    __syncthreads();
    tile_store<N>(tile, out + first * E, systems * E);
  } else {
    const long long s = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
    if (s >= k_sys) return;
    gj_inverse<N>(m + s * N * N, out + s * N * N);
  }
}

// Backward of the inverse: out = -(P^H G P^H) per system, torch's complex
// gradient convention (G is the gradient of a real loss with respect to P,
// d/dRe + i d/dIm; the Pallas kernel computes -(P^T g P^T) for JAX's
// cotangent g = conj(G)). Order of operations as in neg_ptgpt_plain in
// diffgfdn_torch/kernels/cinv.py: T = G P^H row by row, each entry summed
// over m = 0..N-1 from zero; out accumulated over l = 0..N-1 as
// out[i][j] -= conj(P[l][i]) T[l][j]. With --fmad=false the two agree bit for
// bit.
//
// Layout: p, g, out (K, N, N) complex64, contiguous, 8-byte aligned. Any
// 1 <= N <= 32.
//
// Bound on an H100: at the training shape (K = 3 x 65537, N = 4) the kernel
// reads P and G and writes the output, 3 x K x N^2 x 8 B = 75.5 MB (22.5 us at
// 3.35 TB/s), against 16 N^3 = 1 kFLOP per system (0.2 GFLOP, 3 us at
// 67 TFLOP/s): memory bound. Design: as the inverse's. For N <= 8 the block
// stages the tiles of P and G through shared memory with coalesced 8-byte
// copies; each thread takes P into registers, reads G a row at a time from
// its slot, and writes the output over its P slot, which the block then
// stores coalesced. For N > 8 each thread works on device memory directly.
// Conjugation is applied on load, as a sign. On an H100 80GB HBM3 at 700 W
// the training shape takes 0.035 ms, against 0.079 ms untiled (PERF.md).

// One system: p_in, g_in and out hold N x N float2, row-major; out may be
// p_in's slot (P is read whole before the first output is written).
template <int N>
__device__ __forceinline__ void neg_ptgpt_system(const float2* p_in, const float2* g_in,
                                                 float2* o) {
  constexpr int U = N <= 8 ? N : 1;
  float pr[N][N], pi[N][N], our[N][N], oui[N][N];
#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      const float2 v = p_in[r * N + c];
      pr[r][c] = v.x;
      pi[r][c] = v.y;
      our[r][c] = 0.0f;
      oui[r][c] = 0.0f;
    }
  }

#pragma unroll U
  for (int l = 0; l < N; ++l) {
    float gr[N], gi[N];
#pragma unroll U
    for (int m = 0; m < N; ++m) {
      const float2 v = g_in[l * N + m];
      gr[m] = v.x;
      gi[m] = v.y;
    }
    // row l of T = G P^H: t[j] = sum_m G[l][m] conj(P[j][m])
    float tr[N], ti[N];
#pragma unroll U
    for (int j = 0; j < N; ++j) {
      float ar = 0.0f, ai = 0.0f;
#pragma unroll U
      for (int m = 0; m < N; ++m) {
        ar = ar + (gr[m] * pr[j][m] + gi[m] * pi[j][m]);
        ai = ai + (gi[m] * pr[j][m] - gr[m] * pi[j][m]);
      }
      tr[j] = ar;
      ti[j] = ai;
    }
    // out[i][j] -= conj(P[l][i]) t[j]
#pragma unroll U
    for (int i = 0; i < N; ++i) {
#pragma unroll U
      for (int j = 0; j < N; ++j) {
        our[i][j] = our[i][j] - (pr[l][i] * tr[j] + pi[l][i] * ti[j]);
        oui[i][j] = oui[i][j] - (pr[l][i] * ti[j] - pi[l][i] * tr[j]);
      }
    }
  }

#pragma unroll U
  for (int r = 0; r < N; ++r) {
#pragma unroll U
    for (int c = 0; c < N; ++c) {
      o[r * N + c] = make_float2(our[r][c], oui[r][c]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(block_threads<N>())
neg_ptgpt_kernel(const float2* __restrict__ p, const float2* __restrict__ g,
                 float2* __restrict__ out, long long k_sys) {
  if constexpr (N <= kMaxTiledN) {
    constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems;
    __shared__ float2 tile_p[T * Tile<N>::kStride];
    __shared__ float2 tile_g[T * Tile<N>::kStride];
    const long long first = blockIdx.x * static_cast<long long>(T);
    const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
    tile_load<N>(p + first * E, tile_p, systems * E);
    tile_load<N>(g + first * E, tile_g, systems * E);
    copy_wait();
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < systems) {
      float2* slot = tile_p + threadIdx.x * Tile<N>::kStride;
      neg_ptgpt_system<N>(slot, tile_g + threadIdx.x * Tile<N>::kStride, slot);
    }
    __syncthreads();
    tile_store<N>(tile_p, out + first * E, systems * E);
  } else {
    const long long s = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
    if (s >= k_sys) return;
    neg_ptgpt_system<N>(p + s * N * N, g + s * N * N, out + s * N * N);
  }
}

template <int N>
unsigned grid_blocks(long long k_sys) {
  return static_cast<unsigned>((k_sys + block_threads<N>() - 1) / block_threads<N>());
}

}  // namespace

#define CINV_CASE(n)                                                                  \
  case n:                                                                             \
    cinv_kernel<n><<<grid_blocks<n>(k_sys), block_threads<n>(), 0, st>>>(in, o, k_sys); \
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

#define PTGPT_CASE(n)                                                             \
  case n:                                                                         \
    neg_ptgpt_kernel<n><<<grid_blocks<n>(k_sys), block_threads<n>(), 0, st>>>(    \
        pi, gi, o, k_sys);                                                        \
    break;

// p, g, out: (K, N, N) complex64 device pointers; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported N).
extern "C" int diffgfdn_neg_ptgpt_c64(const void* p, const void* g, void* out,
                                      long long k_sys, int n, void* stream) {
  if (k_sys <= 0) return cudaSuccess;
  const float2* pi = static_cast<const float2*>(p);
  const float2* gi = static_cast<const float2*>(g);
  float2* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    PTGPT_CASE(1) PTGPT_CASE(2) PTGPT_CASE(3) PTGPT_CASE(4) PTGPT_CASE(5) PTGPT_CASE(6)
    PTGPT_CASE(7) PTGPT_CASE(8) PTGPT_CASE(9) PTGPT_CASE(10) PTGPT_CASE(11) PTGPT_CASE(12)
    PTGPT_CASE(13) PTGPT_CASE(14) PTGPT_CASE(15) PTGPT_CASE(16) PTGPT_CASE(17) PTGPT_CASE(18)
    PTGPT_CASE(19) PTGPT_CASE(20) PTGPT_CASE(21) PTGPT_CASE(22) PTGPT_CASE(23) PTGPT_CASE(24)
    PTGPT_CASE(25) PTGPT_CASE(26) PTGPT_CASE(27) PTGPT_CASE(28) PTGPT_CASE(29) PTGPT_CASE(30)
    PTGPT_CASE(31) PTGPT_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
