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
// 67 TFLOP/s): memory bound. So is the directional shape (K = 3 x 65536,
// N = 9): 255 MB, 76 us, against 1.8 GFLOP, 26 us.
//
// Design. For N <= 8 (the served and trained shapes) each thread solves one
// system in registers, and the block stages its tile of T consecutive
// systems through shared memory with asynchronous copies, so that device
// memory sees whole coalesced lines: copy step c of thread t moves element
// c * T + t of the tile,
// neighbouring threads on neighbouring 8-byte elements (an 8-byte-aligned
// base is enough: a view with an odd storage offset takes the same path).
// In shared memory a system's slot is N^2 | 1 float2 long, an odd stride, so
// the 16 threads of a half warp reading element j of their own systems hit
// 16 different bank pairs. The thread inverts its slot in place, the block
// synchronises and writes the tile back the same way. The last tile is
// partial: the copies mask by element, the solves by system. On an H100
// 80GB HBM3 at 700 W (chip_smoke.py --kernel-times) the serving shape takes
// 0.025 ms, against 0.118 ms with each thread reading its own system
// (PERF.md).
//
// For N > 8 (the directional presets' 9 x 9 blocks, learned coupling at
// N = 12, coupled directional blocks at N = 27) a thread's registers cannot
// hold a system, so each lane holds one ROW of [M | I]: floor(32 / N)
// systems a warp (3 at N = 9), every loop over a row's entries unrolled,
// so no system sits in local memory. The block stages its systems through
// shared memory with the same coalesced copies (rows_load / rows_store;
// rows N | 1 float2 apart, so the lanes reading their rows hit distinct
// banks). Step k runs in two phases between __syncwarp()s: every lane
// publishes |a[row][k]|^2 in shared memory; every lane then takes the same
// pivot from the published values, in the serial order; rows k and p swap
// their labels, not their data, and the lane now holding row k normalizes
// it and publishes it; every other lane eliminates with it. The lanes end
// by writing their rows of the inverse to their logical places in the
// tile. Each element sees the operations of the serial order above, so the
// results are bit for bit those of the plain version. On an H100 80GB HBM3
// at 700 W (chip_smoke.py --kernel-times) the directional presets' 196608
// systems of 9 x 9 take 0.228 ms, against 2.84 ms with one thread a system
// working in local memory (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiledN = 8;
constexpr int kWarp = 32;

// Systems per tile (also the block's thread count) and the shared-memory
// layout of the tiled kernels (N <= kMaxTiledN).
template <int N>
struct Tile {
  static constexpr int kElems = N * N;        // complex elements of one system
  static constexpr int kStride = kElems | 1;  // float2 per system slot: odd
  static constexpr int kSystems = N <= 4 ? 128 : (N <= 6 ? 64 : 32);
};

// The row kernels (N > kMaxTiledN): lane l of a warp holds row l % N of the
// warp's system l / N (lanes from kPerWarp * N on idle). A system's slot in
// shared memory is kStride float2 long, its rows kRowStride apart.
template <int N>
struct Rows {
  static constexpr int kPerWarp = kWarp / N;                // systems a warp
  static constexpr int kWarps = N <= 16 ? 4 : 2;            // static shared memory < 48 KB
  static constexpr int kSystems = kWarps * kPerWarp;        // systems a block
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kElems = N * N;
  static constexpr int kRowStride = N | 1;                  // odd
  static constexpr int kStride = (N * kRowStride) | 1;      // odd
  static constexpr int kCopies = (kSystems * kElems + kThreads - 1) / kThreads;  // a thread's
};

template <int N>
constexpr int block_threads() {
  if constexpr (N <= kMaxTiledN) {
    return Tile<N>::kSystems;
  } else {
    return Rows<N>::kThreads;
  }
}

template <int N>
constexpr int block_systems() {
  if constexpr (N <= kMaxTiledN) {
    return Tile<N>::kSystems;
  } else {
    return Rows<N>::kSystems;
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

// Copy step c of this thread (of a row kernel's block) moves element
// c * threads + threadIdx.x of the block's systems.
template <int N>
__device__ __forceinline__ int rows_element(int c) {
  return c * Rows<N>::kThreads + static_cast<int>(threadIdx.x);
}

// Element e of a row kernel's block (element j = e % N^2 of system e / N^2,
// row j / N, column j % N) lives in this slot of shared memory.
template <int N>
__device__ __forceinline__ int rows_slot(int e) {
  const int j = e % Rows<N>::kElems;
  return (e / Rows<N>::kElems) * Rows<N>::kStride + (j / N) * Rows<N>::kRowStride + j % N;
}

// tile_load and tile_store for the row kernels: each thread takes kCopies
// copy steps, neighbouring threads on neighbouring elements.
template <int N>
__device__ __forceinline__ void rows_load(const float2* __restrict__ src, float2* tile,
                                          int count) {
#pragma unroll
  for (int c = 0; c < Rows<N>::kCopies; ++c) {
    const int e = rows_element<N>(c);
    if (e < count) copy_to_shared(tile + rows_slot<N>(e), src + e);
  }
}

template <int N>
__device__ __forceinline__ void rows_store(const float2* tile, float2* __restrict__ dst,
                                           int count) {
#pragma unroll
  for (int c = 0; c < Rows<N>::kCopies; ++c) {
    const int e = rows_element<N>(c);
    if (e < count) dst[e] = tile[rows_slot<N>(e)];
  }
}

// What thread t of a row kernel's block works on: row `row` of the block's
// system `system`; idle if that system is past the `systems` of the block
// or the lane past the warp's last system.
struct RowLane {
  int system, row;
  bool active;
};

template <int N>
__device__ __forceinline__ RowLane row_lane(int t, int systems) {
  const int lane = t % kWarp;
  const int system = (t / kWarp) * Rows<N>::kPerWarp + lane / N;
  return {system, lane % N, lane < Rows<N>::kPerWarp * N && system < systems};
}

// The inverse of one system (N <= kMaxTiledN): a_in and a_out hold N x N
// float2, row-major; they may be the same slot (every input is read before
// the first output is written). The loops unroll completely, so every array
// index is a constant and ar / ai stay in registers.
template <int N>
__device__ __forceinline__ void gj_inverse(const float2* a_in, float2* a_out) {
  static_assert(N <= kMaxTiledN, "larger systems take the row kernels");
  float ar[N][2 * N];
  float ai[N][2 * N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float2 v = a_in[r * N + c];
      ar[r][c] = v.x;
      ai[r][c] = v.y;
      ar[r][N + c] = (r == c) ? 1.0f : 0.0f;
      ai[r][N + c] = 0.0f;
    }
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    // pivot: the first row r >= k with the largest |a[r][k]|^2
    int p = k;
    float best = ar[k][k] * ar[k][k] + ai[k][k] * ai[k][k];
#pragma unroll
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
    // normalize the pivot row: row_k * conj(pivot) / |pivot|^2
    const float pr = ar[k][k], pi = ai[k][k];
    const float inv_den = 1.0f / (pr * pr + pi * pi);
#pragma unroll
    for (int c = k; c < 2 * N; ++c) {
      const float xr = ar[k][c], xi = ai[k][c];
      ar[k][c] = (xr * pr + xi * pi) * inv_den;
      ai[k][c] = (xi * pr - xr * pi) * inv_den;
    }
    // eliminate column k from every other row
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == k) continue;
      const float fr = ar[r][k], fi = ai[r][k];
#pragma unroll
      for (int c = k; c < 2 * N; ++c) {
        ar[r][c] = ar[r][c] - (fr * ar[k][c] - fi * ai[k][c]);
        ai[r][c] = ai[r][c] - (fr * ai[k][c] + fi * ar[k][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      a_out[r * N + c] = make_float2(ar[r][N + c], ai[r][N + c]);
    }
  }
}

// One lane's row of [M | I] in the row kernel (N > kMaxTiledN). Rows are
// never moved: a pivot swap exchanges the logical indices `row` of two lanes.
template <int N>
struct GjRow {
  float re[2 * N], im[2 * N];
  int row;
};

// Publishes |a[row][k]|^2 at mag[row].
template <int N, int K>
__device__ __forceinline__ void gj_row_publish(const GjRow<N>& a, float* mag) {
  mag[a.row] = a.re[K] * a.re[K] + a.im[K] * a.im[K];
}

// Phase 0: this lane takes row r of its system's [M | I] from the system's
// slot and publishes it for step 0.
template <int N>
__device__ __forceinline__ void gj_row_start(const float2* sys, int r, float* mag, GjRow<N>& a) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float2 v = sys[r * Rows<N>::kRowStride + c];
    a.re[c] = v.x;
    a.im[c] = v.y;
    a.re[N + c] = (r == c) ? 1.0f : 0.0f;
    a.im[N + c] = 0.0f;
  }
  a.row = r;
  gj_row_publish<N, 0>(a, mag);
}

// Step K, first phase (every row's |a[.][K]|^2 published): the pivot is the
// first row p >= K with the largest, compared in the serial order; rows K
// and p swap labels; the lane now holding row K normalizes it
// (row * conj(pivot) / |pivot|^2) and publishes columns K.. at piv.
template <int N, int K>
__device__ __forceinline__ void gj_row_pivot(const float* mag, float2* piv, GjRow<N>& a) {
  int p = K;
  float best = mag[K];
#pragma unroll
  for (int r = K + 1; r < N; ++r) {
    const float m = mag[r];
    if (m > best) {
      best = m;
      p = r;
    }
  }
  if (a.row == p) {
    a.row = K;
  } else if (a.row == K) {
    a.row = p;
  }
  if (a.row == K) {
    const float pr = a.re[K], pi = a.im[K];
    const float inv_den = 1.0f / (pr * pr + pi * pi);
#pragma unroll
    for (int c = K; c < 2 * N; ++c) {
      const float xr = a.re[c], xi = a.im[c];
      a.re[c] = (xr * pr + xi * pi) * inv_den;
      a.im[c] = (xi * pr - xr * pi) * inv_den;
      piv[c] = make_float2(a.re[c], a.im[c]);
    }
  }
}

// Step K, second phase (the pivot row published): every other row
// eliminates column K; then the row publishes itself for step K + 1 or,
// after the last step, writes its half of [I | inv(M)] to its logical row of
// the system's slot.
template <int N, int K>
__device__ __forceinline__ void gj_row_eliminate(const float2* piv, float* mag, float2* sys,
                                                 GjRow<N>& a) {
  if (a.row != K) {
    const float fr = a.re[K], fi = a.im[K];
#pragma unroll
    for (int c = K; c < 2 * N; ++c) {
      const float2 q = piv[c];
      a.re[c] = a.re[c] - (fr * q.x - fi * q.y);
      a.im[c] = a.im[c] - (fr * q.y + fi * q.x);
    }
  }
  if constexpr (K + 1 < N) {
    gj_row_publish<N, K + 1>(a, mag);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      sys[a.row * Rows<N>::kRowStride + c] = make_float2(a.re[N + c], a.im[N + c]);
    }
  }
}

// Steps K.. of the row kernel, each phase ended by __syncwarp(): a lane's
// row is read by no other lane, the shared mag and piv only after the
// barrier that follows their writes.
template <int N, int K>
__device__ __forceinline__ void gj_row_steps(const RowLane& l, float* mag, float2* piv,
                                             float2* sys, GjRow<N>& a) {
  if (l.active) gj_row_pivot<N, K>(mag, piv, a);
  __syncwarp();
  if (l.active) gj_row_eliminate<N, K>(piv, mag, sys, a);
  __syncwarp();
  if constexpr (K + 1 < N) gj_row_steps<N, K + 1>(l, mag, piv, sys, a);
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
    constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems;
    __shared__ float2 tile[T * Rows<N>::kStride];
    __shared__ float2 piv[T * 2 * N];
    __shared__ float mag[T * N];
    const long long first = blockIdx.x * static_cast<long long>(T);
    const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
    rows_load<N>(m + first * E, tile, systems * E);
    copy_wait();
    __syncthreads();
    const RowLane l = row_lane<N>(threadIdx.x, systems);
    float2* sys = tile + l.system * Rows<N>::kStride;
    float* sys_mag = mag + l.system * N;
    GjRow<N> a;
    if (l.active) gj_row_start<N>(sys, l.row, sys_mag, a);
    __syncwarp();
    gj_row_steps<N, 0>(l, sys_mag, piv + l.system * 2 * N, sys, a);
    __syncthreads();
    rows_store<N>(tile, out + first * E, systems * E);
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
// stores coalesced. Conjugation is applied on load, as a sign. On an H100
// 80GB HBM3 at 700 W the training shape takes 0.035 ms, against 0.079 ms
// untiled (PERF.md). For N > 8 the block stages P and G as the row
// inverse does, and lane l of a system forms row l of T over row l of G
// (P[j][m] read by all the system's lanes at once: a broadcast); after a
// __syncwarp lane i accumulates row i of the output in registers from
// column i of P and the rows of T, and after another writes it over row i
// of P, which the block stores coalesced. The directional shape (196608
// systems of 9 x 9) takes 0.154 ms on the same card, against 2.69 ms with
// one thread a system.

// One system (N <= kMaxTiledN): p_in, g_in and out hold N x N float2,
// row-major; out may be p_in's slot (P is read whole before the first
// output is written).
template <int N>
__device__ __forceinline__ void neg_ptgpt_system(const float2* p_in, const float2* g_in,
                                                 float2* o) {
  static_assert(N <= kMaxTiledN, "larger systems take the row kernels");
  float pr[N][N], pi[N][N], our[N][N], oui[N][N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float2 v = p_in[r * N + c];
      pr[r][c] = v.x;
      pi[r][c] = v.y;
      our[r][c] = 0.0f;
      oui[r][c] = 0.0f;
    }
  }

#pragma unroll
  for (int l = 0; l < N; ++l) {
    float gr[N], gi[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float2 v = g_in[l * N + m];
      gr[m] = v.x;
      gi[m] = v.y;
    }
    // row l of T = G P^H: t[j] = sum_m G[l][m] conj(P[j][m])
    float tr[N], ti[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float ar = 0.0f, ai = 0.0f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        ar = ar + (gr[m] * pr[j][m] + gi[m] * pi[j][m]);
        ai = ai + (gi[m] * pr[j][m] - gr[m] * pi[j][m]);
      }
      tr[j] = ar;
      ti[j] = ai;
    }
    // out[i][j] -= conj(P[l][i]) t[j]
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        our[i][j] = our[i][j] - (pr[l][i] * tr[j] + pi[l][i] * ti[j]);
        oui[i][j] = oui[i][j] - (pr[l][i] * ti[j] - pi[l][i] * tr[j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      o[r * N + c] = make_float2(our[r][c], oui[r][c]);
    }
  }
}

// The row kernel's phases (N > kMaxTiledN); p and g are a system's slots.
// Only the inner loops unroll completely (the row arrays need constant
// indices); the outer ones, over shared-memory rows, by kOuterUnroll: the
// code of N^2 unrolled terms outgrows the instruction cache at large N
// (PERF.md).
constexpr int kOuterUnroll = 3;

// Phase 1: lane l forms row l of T = G P^H, t[j] = sum_m G[l][m] conj(P[j][m])
// summed over m from zero, and writes it over row l of G (which no other
// lane reads).
template <int N>
__device__ __forceinline__ void ptgpt_row_t(const float2* p, float2* g, int l) {
  constexpr int RS = Rows<N>::kRowStride;
  float gr[N], gi[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float2 v = g[l * RS + m];
    gr[m] = v.x;
    gi[m] = v.y;
  }
#pragma unroll kOuterUnroll
  for (int j = 0; j < N; ++j) {
    float ar = 0.0f, ai = 0.0f;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float2 q = p[j * RS + m];
      ar = ar + (gr[m] * q.x + gi[m] * q.y);
      ai = ai + (gi[m] * q.x - gr[m] * q.y);
    }
    g[l * RS + j] = make_float2(ar, ai);
  }
}

// Row i of the output, kept in registers between phases 2 and 3.
template <int N>
struct PtgptRow {
  float re[N], im[N];
};

// Phase 2 (every row of T written): out[i][j] = -sum_l conj(P[l][i]) T[l][j],
// accumulated over l in order.
template <int N>
__device__ __forceinline__ void ptgpt_row_out(const float2* p, const float2* t, int i,
                                              PtgptRow<N>& o) {
  constexpr int RS = Rows<N>::kRowStride;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o.re[j] = 0.0f;
    o.im[j] = 0.0f;
  }
#pragma unroll kOuterUnroll
  for (int l = 0; l < N; ++l) {
    const float2 q = p[l * RS + i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 v = t[l * RS + j];
      o.re[j] = o.re[j] - (q.x * v.x + q.y * v.y);
      o.im[j] = o.im[j] - (q.x * v.y - q.y * v.x);
    }
  }
}

// Phase 3 (no lane reads P any more): row i of the output over row i of P.
template <int N>
__device__ __forceinline__ void ptgpt_row_store(float2* p, int i, const PtgptRow<N>& o) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[i * Rows<N>::kRowStride + j] = make_float2(o.re[j], o.im[j]);
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
    constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems;
    __shared__ float2 tile_p[T * Rows<N>::kStride];
    __shared__ float2 tile_g[T * Rows<N>::kStride];
    const long long first = blockIdx.x * static_cast<long long>(T);
    const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
    rows_load<N>(p + first * E, tile_p, systems * E);
    rows_load<N>(g + first * E, tile_g, systems * E);
    copy_wait();
    __syncthreads();
    const RowLane l = row_lane<N>(threadIdx.x, systems);
    float2* sys_p = tile_p + l.system * Rows<N>::kStride;
    float2* sys_t = tile_g + l.system * Rows<N>::kStride;
    if (l.active) ptgpt_row_t<N>(sys_p, sys_t, l.row);
    __syncwarp();
    PtgptRow<N> o;
    if (l.active) ptgpt_row_out<N>(sys_p, sys_t, l.row, o);
    __syncwarp();
    if (l.active) ptgpt_row_store<N>(sys_p, l.row, o);
    __syncthreads();
    rows_store<N>(tile_p, out + first * E, systems * E);
  }
}

template <int N>
unsigned grid_blocks(long long k_sys) {
  return static_cast<unsigned>((k_sys + block_systems<N>() - 1) / block_systems<N>());
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
