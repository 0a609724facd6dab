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
// then gives x, each of its sums taken over ascending columns from zero.
// Order of operations as in _lu_solve_kernel and the plain version in
// diffgfdn_torch/kernels/lu.py; with --fmad=false the pivots, the factors and
// x agree bit for bit.
//
// Layout (documented for the transposed-solve kernel of the training slice):
//   m   (K, N, N) complex64, b (K, N) complex64   -- inputs, contiguous,
//                                                    8-byte aligned
//   x   (K, N) complex64                          -- solution
//   lu  (N, N, K) complex64: lu[i][j][s] = U[i][j] for j >= i, the
//       multiplier f_j[i] for j < i, of system s (bins last: coalesced)
//   piv (N, K) int32: piv[k][s] = absolute pivot row p_k >= k of system s
// Any 1 <= N <= 32 (a switch over template instantiations).
//
// Bound on an H100: at the serving shape (K = 3 x 65537, N = 4) the kernel
// reads m and b and writes x, lu and piv: K x (N^2 x 16 + N x 20) B = 66 MB,
// 20 us at 3.35 TB/s, against about 8 N^3 / 3 FLOP per system: memory bound.
// So is the directional shape (K = 3 x 65537 systems of 9 x 9): 290 MB, 87 us,
// against 0.4 GFLOP, 6 us at 67 TFLOP/s.
//
// Design. For N <= 8 (the served and trained N = 4) each thread solves one
// system in registers, and the block stages its tile of T consecutive
// systems, m and b, through shared memory with asynchronous 8-byte copies,
// so that device memory sees whole coalesced lines: copy step c of thread t
// moves element c * T + t of the tile, neighbouring threads on neighbouring
// elements (any 8-byte-aligned base: a view with an odd storage offset takes
// the same path). In shared memory a system's slot is (N^2 + N) | 1 float2
// long, an odd stride, so a half warp's 16 threads reading element j of
// their own systems hit 16 different bank pairs; m fills the slot's first
// N^2 elements, b the next N. The thread factors its slot with every loop
// unrolled and the row swap done by selects (a branch per candidate row
// lets the compiler merge the swaps' stores into one at a run-time row
// index, which puts the arrays in local memory), writes x over b in its
// slot, and the block stores the x tile back coalesced. The factors and
// pivots go straight from registers to device memory bins-last: a warp's
// stores are coalesced without staging. The last tile is partial: the
// copies mask by element, the solves by system. On an H100 80GB HBM3 at
// 700 W (chip_smoke.py --kernel-times) the serving shape takes 0.029 ms,
// against 0.060 ms with each thread reading its own system (PERF.md).
//
// For N > 8 (the directional presets' 9 x 9 blocks) a thread's registers
// cannot hold a system (ptxas: 792 bytes of stack at N = 9 for a system a
// thread), so each lane holds one ROW of [M | b]: floor(32 / N) systems a
// warp (3 at N = 9), every loop over a row's entries unrolled, the steps a
// template recursion, so no row sits in local memory. The block stages its
// systems through shared memory with coalesced asynchronous copies, rows
// N | 1 float2 apart and systems an odd number apart, so the lanes reading
// their rows, and the threads reading one entry of consecutive systems, hit
// distinct banks. Step k runs in two phases between __syncwarp()s: every
// lane has published |a[row][k]|^2; every lane takes the same pivot p from
// the published values in the serial order, rows k and p swap their labels,
// and the lane now holding row k publishes its active part (columns k..,
// U's row k, final) and its right-hand side over the system's slot; then
// every lane below eliminates with it, writes its multiplier f_k[row] into
// the slot at (row, k), where it stays (later swaps move only columns right
// of their step), and publishes |a[row][k + 1]|^2. Relabelling alone is the
// partial swap: the multipliers left of column k are in the slot, not in
// the lanes. Back substitution takes N more phases, x[k] by the lane holding
// row k from its registers and the x[j > k] published before it, each sum in
// ascending j from zero. The block then stores x, and the factors and pivots
// bins-last from the slots: element e of the block's N^2 (N) planes is
// system e % T of plane e / T, so a warp stores runs of the T consecutive
// systems of a plane. Each element sees the operations of the serial order,
// so x, the factors and the pivots are bit for bit those of the plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiledN = 8;
constexpr int kThreads = 128;  // threads per block of the transposed solve
constexpr int kWarp = 32;

// Systems per tile (also the block's thread count) and the shared-memory
// layout of the tiled solve (N <= kMaxTiledN): a slot holds a system's m
// (N^2 elements) and then its b (N), later overwritten by x.
template <int N>
struct Tile {
  static constexpr int kStride = (N * N + N) | 1;  // float2 per system slot: odd
  static constexpr int kSystems = N <= 4 ? 128 : (N <= 6 ? 64 : 32);
};

// The row solve (N > kMaxTiledN): lane l of a warp holds row l % N of the
// warp's system l / N (lanes from kPerWarp * N on idle). A system's matrix
// slot in shared memory is kStride float2 long, its rows kRowStride apart;
// its vector slots (b, x), magnitudes and pivots N apart.
template <int N>
struct Rows {
  static constexpr int kPerWarp = kWarp / N;                 // systems a warp
  static constexpr int kWarps = N <= 24 ? 8 : 4;             // static shared memory < 48 KB
  static constexpr int kSystems = kWarps * kPerWarp;         // systems a block
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kRowStride = N | 1;                   // odd
  static constexpr int kStride = (N * kRowStride) | 1;       // odd
  // a thread's copy steps for the matrices (N^2 a system), the vectors and
  // pivots (N a system)
  static constexpr int kMatCopies = (kSystems * N * N + kThreads - 1) / kThreads;
  static constexpr int kVecCopies = (kSystems * N + kThreads - 1) / kThreads;
};

template <int N>
constexpr int solve_threads() {
  if constexpr (N <= kMaxTiledN) {
    return Tile<N>::kSystems;
  } else {
    return Rows<N>::kThreads;
  }
}

template <int N>
constexpr int solve_systems() {
  if constexpr (N <= kMaxTiledN) {
    return Tile<N>::kSystems;
  } else {
    return Rows<N>::kSystems;
  }
}

// Copy step c of this thread moves element c * T + threadIdx.x of a tile.
template <int N>
__device__ __forceinline__ int copy_element(int c) {
  return c * Tile<N>::kSystems + static_cast<int>(threadIdx.x);
}

// Element e of a tile of E elements per system (element e % E of system
// e / E) lives in this slot of shared memory, O elements into its system's
// slot.
template <int N, int E, int O>
__device__ __forceinline__ int tile_slot(int e) {
  return (e / E) * Tile<N>::kStride + O + e % E;
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

// Starts the copies of the first `count` elements of src (E per system,
// the tile's systems contiguous) into their slots: each thread takes E copy
// steps, all in flight at once; copy_wait() and a barrier make them visible.
template <int N, int E, int O>
__device__ __forceinline__ void tile_load(const float2* __restrict__ src, float2* tile,
                                          int count) {
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const int e = copy_element<N>(c);
    if (e < count) copy_to_shared(tile + tile_slot<N, E, O>(e), src + e);
  }
}

// The slots of the first `count` elements back to dst, as tile_load read them.
template <int N, int E, int O>
__device__ __forceinline__ void tile_store(const float2* tile, float2* __restrict__ dst,
                                           int count) {
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const int e = copy_element<N>(c);
    if (e < count) dst[e] = tile[tile_slot<N, E, O>(e)];
  }
}

// The solve of system s of k_sys (N <= kMaxTiledN): a_in holds its N x N
// float2 matrix row-major, b_in its N right-hand-side entries; writes x_out
// (N float2, which may be b_in: b is read whole first), the factors
// lu[(r N + c) k_sys + s] and the pivots piv[k k_sys + s]. The loops unroll
// completely, so every array index is a constant and the arrays stay in
// registers.
template <int N>
__device__ __forceinline__ void lu_solve_system(const float2* a_in, const float2* b_in,
                                                float2* x_out, float2* __restrict__ lu,
                                                int* __restrict__ piv, long long s,
                                                long long k_sys) {
  static_assert(N <= kMaxTiledN, "larger systems take the row solve");
  float lr[N][N], li[N][N], rr[N], ri[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float2 v = a_in[r * N + c];
      lr[r][c] = v.x;
      li[r][c] = v.y;
    }
    const float2 v = b_in[r];
    rr[r] = v.x;
    ri[r] = v.y;
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    // pivot: the first row r >= k with the largest |a[r][k]|^2
    int p = k;
    float best = lr[k][k] * lr[k][k] + li[k][k] * li[k][k];
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float mag = lr[r][k] * lr[r][k] + li[r][k] * li[r][k];
      if (mag > best) {
        best = mag;
        p = r;
      }
    }
    piv[k * k_sys + s] = p;
    // swap rows k and p over the active columns and the RHS only
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const bool swap = r == p;
#pragma unroll
      for (int c = k; c < N; ++c) {
        const float kr = lr[k][c], ki = li[k][c], xr = lr[r][c], xi = li[r][c];
        lr[k][c] = swap ? xr : kr;
        li[k][c] = swap ? xi : ki;
        lr[r][c] = swap ? kr : xr;
        li[r][c] = swap ? ki : xi;
      }
      const float kr = rr[k], ki = ri[k], xr = rr[r], xi = ri[r];
      rr[k] = swap ? xr : kr;
      ri[k] = swap ? xi : ki;
      rr[r] = swap ? kr : xr;
      ri[r] = swap ? ki : xi;
    }
    if (k == N - 1) break;
    // multipliers f = a[i][k] / pivot, stored below the diagonal
    const float pr = lr[k][k], pi = li[k][k];
    const float inv_den = 1.0f / (pr * pr + pi * pi);
    const float ipr = pr * inv_den;
    const float ipi = -pi * inv_den;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float c1r = lr[i][k], c1i = li[i][k];
      const float fr = c1r * ipr - c1i * ipi;
      const float fi = c1r * ipi + c1i * ipr;
      lr[i][k] = fr;
      li[i][k] = fi;
      // trailing update of row i and of its RHS entry
#pragma unroll
      for (int j = k + 1; j < N; ++j) {
        const float ur = lr[k][j], ui = li[k][j];
        lr[i][j] = lr[i][j] - (fr * ur - fi * ui);
        li[i][j] = li[i][j] - (fr * ui + fi * ur);
      }
      rr[i] = rr[i] - (fr * rr[k] - fi * ri[k]);
      ri[i] = ri[i] - (fr * ri[k] + fi * rr[k]);
    }
  }

  // back substitution: x[k] = (rhs[k] - sum_{j>k} U[k][j] x[j]) / U[k][k],
  // the sum taken over ascending j from zero
  float xr[N], xi[N];
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    float sr = 0.0f, si = 0.0f;
#pragma unroll
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

#pragma unroll
  for (int r = 0; r < N; ++r) {
    x_out[r] = make_float2(xr[r], xi[r]);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      lu[(r * N + c) * k_sys + s] = make_float2(lr[r][c], li[r][c]);
    }
  }
}

// ---- the row solve (N > kMaxTiledN) ----

// Copy step c of this thread (of a row solve's block) moves element
// c * threads + threadIdx.x of the block's elements.
template <int N>
__device__ __forceinline__ int rows_element(int c) {
  return c * Rows<N>::kThreads + static_cast<int>(threadIdx.x);
}

// Element (r, c) of the block's system s lives in this slot of shared
// memory: first the matrix's, then the factor's.
template <int N>
__device__ __forceinline__ int factor_slot(int s, int r, int c) {
  return s * Rows<N>::kStride + r * Rows<N>::kRowStride + c;
}

// Matrix element e of the block: element j = e % N^2 of system e / N^2, row
// j / N, column j % N.
template <int N>
__device__ __forceinline__ int rows_slot(int e) {
  const int j = e % (N * N);
  return factor_slot<N>(e / (N * N), j / N, j % N);
}

// Starts the copies of the first `count` matrix elements of src (the
// block's systems, contiguous) into their slots, and of the first
// `count_b` right-hand-side entries into the vector slots (entry e of the
// block at vec[e]); copy_wait() and a barrier make them visible.
template <int N>
__device__ __forceinline__ void rows_load(const float2* __restrict__ m, const float2* __restrict__ b,
                                          float2* mat, float2* vec, int count, int count_b) {
#pragma unroll
  for (int c = 0; c < Rows<N>::kMatCopies; ++c) {
    const int e = rows_element<N>(c);
    if (e < count) copy_to_shared(mat + rows_slot<N>(e), m + e);
  }
#pragma unroll
  for (int c = 0; c < Rows<N>::kVecCopies; ++c) {
    const int e = rows_element<N>(c);
    if (e < count_b) copy_to_shared(vec + e, b + e);
  }
}

// Plane element e of the block's factors (or pivots): system e % T of
// plane e / T, T the block's systems; its destination is plane * k_sys +
// first + system, so a warp stores runs of consecutive systems.
struct PlaneElement {
  int plane, system;
};

template <int N>
__device__ __forceinline__ PlaneElement plane_element(int e) {
  return {e / Rows<N>::kSystems, e % Rows<N>::kSystems};
}

// After the solve: x from the vector slots (the first `systems` * N
// entries, contiguous), the factors and pivots from the slots to their
// planes, bins-last, for the block's first `systems` systems.
template <int N>
__device__ __forceinline__ void rows_store(const float2* mat, const float2* vec, const int* pv,
                                           float2* __restrict__ x, float2* __restrict__ lu,
                                           int* __restrict__ piv, long long first,
                                           long long k_sys, int systems) {
#pragma unroll
  for (int c = 0; c < Rows<N>::kVecCopies; ++c) {
    const int e = rows_element<N>(c);
    if (e < systems * N) x[first * N + e] = vec[e];
  }
#pragma unroll
  for (int c = 0; c < Rows<N>::kMatCopies; ++c) {
    const PlaneElement q = plane_element<N>(rows_element<N>(c));
    if (q.plane < N * N && q.system < systems) {
      lu[q.plane * k_sys + first + q.system] = mat[factor_slot<N>(q.system, q.plane / N, q.plane % N)];
    }
  }
#pragma unroll
  for (int c = 0; c < Rows<N>::kVecCopies; ++c) {
    const PlaneElement q = plane_element<N>(rows_element<N>(c));
    if (q.plane < N && q.system < systems) {
      piv[q.plane * k_sys + first + q.system] = pv[q.system * N + q.plane];
    }
  }
}

// What thread t of a row solve's block works on: row `row` of the block's
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

// A system's shared slots: its matrix, then factors (a, rows kRowStride
// apart); its vector (v: b, then the pivot rows' right-hand sides, then x);
// the published magnitudes (mag) and its pivots (pv).
struct LuSlot {
  float2* a;
  float2* v;
  float* mag;
  int* pv;
};

template <int N>
__device__ __forceinline__ LuSlot lu_slot(float2* mat, float2* vec, float* mag, int* pv,
                                          int system) {
  return {mat + system * Rows<N>::kStride, vec + system * N, mag + system * N, pv + system * N};
}

// One lane's row of [M | b]. Rows are never moved: a pivot swap exchanges
// the logical indices `row` of two lanes; entries left of the current step
// are no longer read.
template <int N>
struct LuRow {
  float re[N], im[N];
  float rr, ri;
  int row;
};

// Publishes |a[row][K]|^2 at mag[row].
template <int N, int K>
__device__ __forceinline__ void lu_row_publish(const LuRow<N>& a, const LuSlot& q) {
  q.mag[a.row] = a.re[K] * a.re[K] + a.im[K] * a.im[K];
}

// Phase 0: this lane takes row r of its system's [M | b] from the slots
// and publishes it for step 0.
template <int N>
__device__ __forceinline__ void lu_row_start(const LuSlot& q, int r, LuRow<N>& a) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float2 v = q.a[r * Rows<N>::kRowStride + c];
    a.re[c] = v.x;
    a.im[c] = v.y;
  }
  const float2 v = q.v[r];
  a.rr = v.x;
  a.ri = v.y;
  a.row = r;
  lu_row_publish<N, 0>(a, q);
}

// Step K, first phase (every row >= K has published |a[.][K]|^2): the
// pivot p is the first row >= K with the largest, compared in the serial
// order; rows K and p swap labels; the lane now holding row K writes the
// pivot p, its columns K.. (row K of U, final) and its right-hand side
// over the slot.
template <int N, int K>
__device__ __forceinline__ void lu_row_pivot(const LuSlot& q, LuRow<N>& a) {
  int p = K;
  float best = q.mag[K];
#pragma unroll
  for (int r = K + 1; r < N; ++r) {
    const float m = q.mag[r];
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
    q.pv[K] = p;
#pragma unroll
    for (int c = K; c < N; ++c) q.a[K * Rows<N>::kRowStride + c] = make_float2(a.re[c], a.im[c]);
    q.v[K] = make_float2(a.rr, a.ri);
  }
}

// Step K < N - 1, second phase (the pivot row published): every row below
// takes its multiplier f = a[row][K] * conj(pivot) / |pivot|^2, writes it at
// (row, K) of the slot, where it stays, updates its columns K + 1.. and its
// right-hand side, and publishes |a[row][K + 1]|^2.
template <int N, int K>
__device__ __forceinline__ void lu_row_eliminate(const LuSlot& q, LuRow<N>& a) {
  if (a.row <= K) return;
  constexpr int RS = Rows<N>::kRowStride;
  const float2 d = q.a[K * RS + K];
  const float inv_den = 1.0f / (d.x * d.x + d.y * d.y);
  const float ipr = d.x * inv_den;
  const float ipi = -d.y * inv_den;
  const float c1r = a.re[K], c1i = a.im[K];
  const float fr = c1r * ipr - c1i * ipi;
  const float fi = c1r * ipi + c1i * ipr;
  q.a[a.row * RS + K] = make_float2(fr, fi);
#pragma unroll
  for (int j = K + 1; j < N; ++j) {
    const float2 u = q.a[K * RS + j];
    a.re[j] = a.re[j] - (fr * u.x - fi * u.y);
    a.im[j] = a.im[j] - (fr * u.y + fi * u.x);
  }
  const float2 w = q.v[K];
  a.rr = a.rr - (fr * w.x - fi * w.y);
  a.ri = a.ri - (fr * w.y + fi * w.x);
  lu_row_publish<N, K + 1>(a, q);
}

// Back substitution, step K (x[j] published for every j > K): the lane
// holding row K takes x[K] = (rhs[K] - sum_{j>K} U[K][j] x[j]) / U[K][K],
// the sum over ascending j from zero, U from its registers, and publishes it
// at v[K].
template <int N, int K>
__device__ __forceinline__ void lu_row_back(const LuSlot& q, const LuRow<N>& a) {
  if (a.row != K) return;
  float num_r = a.rr, num_i = a.ri;
  if constexpr (K < N - 1) {
    float sr = 0.0f, si = 0.0f;
#pragma unroll
    for (int j = K + 1; j < N; ++j) {
      const float2 x = q.v[j];
      sr = sr + (a.re[j] * x.x - a.im[j] * x.y);
      si = si + (a.re[j] * x.y + a.im[j] * x.x);
    }
    num_r = num_r - sr;
    num_i = num_i - si;
  }
  const float dr = a.re[K], di = a.im[K];
  const float inv_den = 1.0f / (dr * dr + di * di);
  q.v[K] = make_float2((num_r * dr + num_i * di) * inv_den, (num_i * dr - num_r * di) * inv_den);
}

// Steps K.. of the factorization, then the back substitution from step
// N - 1 down, each phase ended by __syncwarp(): a lane's row is read by no
// other lane, the shared slots only after the barrier that follows their
// writes.
template <int N, int K>
__device__ __forceinline__ void lu_row_back_steps(const RowLane& l, const LuSlot& q,
                                                  const LuRow<N>& a) {
  if (l.active) lu_row_back<N, K>(q, a);
  __syncwarp();
  if constexpr (K > 0) lu_row_back_steps<N, K - 1>(l, q, a);
}

template <int N, int K>
__device__ __forceinline__ void lu_row_steps(const RowLane& l, const LuSlot& q, LuRow<N>& a) {
  if (l.active) lu_row_pivot<N, K>(q, a);
  __syncwarp();
  if constexpr (K + 1 < N) {
    if (l.active) lu_row_eliminate<N, K>(q, a);
    __syncwarp();
    lu_row_steps<N, K + 1>(l, q, a);
  } else {
    lu_row_back_steps<N, N - 1>(l, q, a);
  }
}

template <int N>
__global__ void __launch_bounds__(solve_threads<N>())
lu_solve_kernel(const float2* __restrict__ m, const float2* __restrict__ b,
                float2* __restrict__ x, float2* __restrict__ lu, int* __restrict__ piv,
                long long k_sys) {
  constexpr int T = N <= kMaxTiledN ? Tile<N>::kSystems : Rows<N>::kSystems;
  const long long first = blockIdx.x * static_cast<long long>(T);
  const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
  if constexpr (N <= kMaxTiledN) {
    constexpr int E = N * N;
    __shared__ float2 tile[T * Tile<N>::kStride];
    tile_load<N, E, 0>(m + first * E, tile, systems * E);
    tile_load<N, N, E>(b + first * N, tile, systems * N);
    copy_wait();
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < systems) {
      float2* slot = tile + threadIdx.x * Tile<N>::kStride;
      lu_solve_system<N>(slot, slot + E, slot + E, lu, piv, first + threadIdx.x, k_sys);
    }
    __syncthreads();
    tile_store<N, N, E>(tile, x + first * N, systems * N);
  } else {
    __shared__ float2 mat[T * Rows<N>::kStride];
    __shared__ float2 vec[T * N];
    __shared__ float mag[T * N];
    __shared__ int pv[T * N];
    rows_load<N>(m + first * N * N, b + first * N, mat, vec, systems * N * N, systems * N);
    copy_wait();
    __syncthreads();
    const RowLane l = row_lane<N>(threadIdx.x, systems);
    const LuSlot q = lu_slot<N>(mat, vec, mag, pv, l.system);
    LuRow<N> a;
    if (l.active) lu_row_start<N>(q, l.row, a);
    __syncwarp();
    lu_row_steps<N, 0>(l, q, a);
    __syncthreads();
    rows_store<N>(mat, vec, pv, x, lu, piv, first, k_sys, systems);
  }
}

template <int N>
unsigned solve_blocks(long long k_sys) {
  return static_cast<unsigned>((k_sys + solve_systems<N>() - 1) / solve_systems<N>());
}

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
// Bound on an H100: the kernel reads the factors (K N^2 8 B), the pivots
// (K N 4 B) and g (K N 8 B) and writes y (K N 8 B), against about 8 N^2 +
// 11 N FLOP per system: memory bound at every N. At the training shape (K =
// 3 x 65537, N = 4) that is 40.9 MB, 12 us at 3.35 TB/s; at the directional
// step's (K = 3 x 65537, N = 9) 162.8 MB, 48.6 us; at N = 27 (K = 65537)
// 417.6 MB, 124.7 us.
//
// Design for N <= 8: one thread per system keeps w in registers and reads
// each factor entry once; the factor and pivot reads are bins-last, so a
// warp's loads are coalesced.
//
// Design for N > 8 (the directional presets' 9 x 9 blocks and above): still
// one thread a system, T systems a block, but every read is fetched ahead
// of use. Thread t's factor entries are element t of each of the block's
// N^2 plane runs (system s of plane (i, j) sits at (i N + j) K + s), so the
// thread copies its own entries, a warp's copies coalesced, into a ring of
// kRing slots in shared memory with asynchronous copies, one commit group a
// plane, in the order the passes consume them: U's rows k = 0..N-1, then
// the multiplier columns k = N-2..0 (a table of that order is built once a
// block). Before it reads plane q the thread waits until at most kRing - 1
// of its groups are outstanding (plane q has landed), reads it and refills
// the slot with plane q + kRing. So kRing x 8 bytes a thread are always in
// flight: 115 KB an SM at N = 9 (16 slots, 7 blocks of 30 KB), 32 KB at
// N = 27 (8 slots, 8 blocks of 27 KB), where one load a thread at a time,
// each behind a read-modify-write of w in local memory, kept at most 16 KB.
// A slot is written and read by one thread only: no barrier guards the
// ring. g and y, rows a thread would read at a stride of N x 8 bytes, are
// staged through shared memory with coalesced copies (neighbouring threads
// on neighbouring elements), a system's slot N | 1 float2 long, an odd
// stride, so a half warp's threads hit 16 different bank pairs; the pivots
// are copied with g's group. The last block is partial: the copies mask by
// element, the solves by system. w stays out of local memory: up to N =
// kMaxRegLutN every loop is unrolled, the steps a template recursion and
// pass 2's swap done by selects (a branch per candidate row lets the
// compiler merge the stores at a run-time index, which puts w in local
// memory), so w lives in registers; above, unrolled steps would outgrow the
// instruction cache (B2 at N = 27, PERF.md), so the loops stay rolled and w
// is updated in place in its g slot, the swap a read and two stores. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py --kernel-times) the directional
// shape takes 0.071 ms (0.120 before), N = 27 0.169 (0.490). At N = 9, 8
// to 24 slots and 64 or 128 threads a block ran alike; at N = 27 8 slots
// ran 18 % faster than 16, where the threads' chains of shared-memory reads
// and writes of w limit, not the bytes in flight (PERF.md).
constexpr int kMaxRegLutN = 12;

template <int N>
struct Lut {
  static constexpr bool kRegs = N <= kMaxRegLutN;  // w in registers
  static constexpr int kSystems = kRegs ? 128 : 64;  // threads (systems) a block
  static constexpr int kRing = kRegs ? 16 : 8;       // factor planes in flight a thread
  static constexpr int kSlot = N | 1;                // float2 a system's g / y slot: odd
  static constexpr int kPlanes = N * N;
  static constexpr int kPass1 = N * (N + 1) / 2;     // planes of U, consumed first
  static_assert(kPlanes > kRing, "the ring's first planes are copied unconditionally");
};

// The block's shared memory: the ring (slot r of thread t at r * T + t),
// the g / y slots, the pivots (pivot k of thread t at k * T + t) and the
// order in which the planes are consumed.
template <int N>
struct LutSmem {
  float2 ring[Lut<N>::kRing * Lut<N>::kSystems];
  float2 gy[Lut<N>::kSystems * Lut<N>::kSlot];
  int pv[N * Lut<N>::kSystems];
  int order[Lut<N>::kPlanes];
};

template <int N>
constexpr int lut_threads() {
  if constexpr (N <= kMaxTiledN) {
    return kThreads;
  } else {
    return Lut<N>::kSystems;
  }
}

template <int N>
unsigned lut_blocks(long long k_sys) {
  return static_cast<unsigned>((k_sys + lut_threads<N>() - 1) / lut_threads<N>());
}

// A pipeline's 8- and 4-byte asynchronous copies into shared memory, in
// groups: on the card cp.async, cp.async.commit_group and
// cp.async.wait_group (at most `Pending` of this thread's groups still in
// flight); in the host build of the tests a queue per thread that performs
// a group's copies only at the wait that needs them.
__device__ __forceinline__ void copy_async(float2* dst, const float2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
#elif !defined(__CUDACC__)
  host_copy_async(dst, src, sizeof(float2));
#endif
}

__device__ __forceinline__ void copy_async(int* dst, const int* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#elif !defined(__CUDACC__)
  host_copy_async(dst, src, sizeof(int));
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#elif !defined(__CUDACC__)
  host_copy_commit();
#endif
}

template <int Pending>
__device__ __forceinline__ void copy_wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
#elif !defined(__CUDACC__)
  host_copy_wait(Pending);
#endif
}

// The plane i N + j that the passes consume q-th: pass 1 row k of U,
// columns k..N-1; then pass 2 column k = N-2..0 of the multipliers, rows
// k+1..N-1 (the order of pass 2's sums).
template <int N>
__device__ __forceinline__ int lut_plane(int q) {
  if (q < Lut<N>::kPass1) {
    int k = 0;
    while (q >= N - k) {
      q -= N - k;
      ++k;
    }
    return k * N + k + q;
  }
  q -= Lut<N>::kPass1;
  int k = N - 2;
  while (q >= N - 1 - k) {
    q -= N - 1 - k;
    --k;
  }
  return (k + 1 + q) * N + k;
}

// Phase 0: the consumption order, entries t, t + T, ... of this thread.
template <int N>
__device__ __forceinline__ void lut_order(int* order) {
  for (int q = static_cast<int>(threadIdx.x); q < Lut<N>::kPlanes; q += Lut<N>::kSystems) {
    order[q] = lut_plane<N>(q);
  }
}

// Element e of the block's g (or y) rows, element e % N of system e / N,
// lives in this slot.
template <int N>
__device__ __forceinline__ int lut_slot(int e) {
  return (e / N) * Lut<N>::kSlot + e % N;
}

// Copy step c of this thread moves element c * T + threadIdx.x of the
// block's g (and y) rows.
template <int N>
__device__ __forceinline__ int lut_element(int c) {
  return c * Lut<N>::kSystems + static_cast<int>(threadIdx.x);
}

// Phase 1 (the order table built): one commit group of the g rows of the
// block's `systems` systems (coalesced) and this thread's pivots, then one
// group for each of the ring's first kRing planes of this thread's system
// (a thread past the block's systems copies only g and commits empty
// groups); then waits for the first group, so that a barrier makes g
// visible while the planes are still in flight.
template <int N>
__device__ __forceinline__ void lut_load(LutSmem<N>& sm, const float2* __restrict__ lu,
                                         const int* __restrict__ piv,
                                         const float2* __restrict__ g, long long first,
                                         long long k_sys, int systems) {
  constexpr int T = Lut<N>::kSystems;
  const int t = static_cast<int>(threadIdx.x);
  const bool active = t < systems;
  const long long s = first + t;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int e = lut_element<N>(c);
    if (e < systems * N) copy_async(sm.gy + lut_slot<N>(e), g + first * N + e);
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k) copy_async(sm.pv + k * T + t, piv + k * k_sys + s);
  }
  copy_commit();
#pragma unroll
  for (int r = 0; r < Lut<N>::kRing; ++r) {
    if (active) copy_async(sm.ring + r * T + t, lu + sm.order[r] * k_sys + s);
    copy_commit();
  }
  copy_wait_group<Lut<N>::kRing>();
}

// This thread's view of the ring: its system's entry of plane 0 (lu + s),
// its slot 0 (ring + t, slot r T floats2 further) and the order table.
struct LutThread {
  const float2* lu;
  long long k_sys;
  float2* ring;
  const int* order;
};

// Plane q of this thread's system: wait until it has landed (at most
// kRing - 1 groups of this thread outstanding: the groups complete in
// order), read it from its slot and refill the slot with plane q + kRing
// (an empty group past the last plane, so the count stays right).
template <int N>
__device__ __forceinline__ float2 lut_take(const LutThread& th, int q) {
  constexpr int R = Lut<N>::kRing;
  copy_wait_group<R - 1>();
  float2* slot = th.ring + (q % R) * Lut<N>::kSystems;
  const float2 f = *slot;
  if (q + R < Lut<N>::kPlanes) copy_async(slot, th.lu + th.order[q + R] * th.k_sys);
  copy_commit();
  return f;
}

// w in registers (N <= kMaxRegLutN). Pass 1, step K: w[K] /= conj(U[K][K]),
// then w[i] -= conj(U[K][i]) w[K] for i > K; planes K N - K (K - 1) / 2 +
// 0..N-1-K of the consumption order.
template <int N, int K>
__device__ __forceinline__ void lut_forward(const LutThread& th, float (&wr)[N],
                                            float (&wi)[N]) {
  constexpr int Q = K * N - K * (K - 1) / 2;
  const float2 d = lut_take<N>(th, Q);
  const float dr = d.x, di = -d.y;
  const float inv_den = 1.0f / (dr * dr + di * di);
  const float wkr = (wr[K] * dr + wi[K] * di) * inv_den;
  const float wki = (wi[K] * dr - wr[K] * di) * inv_den;
  wr[K] = wkr;
  wi[K] = wki;
#pragma unroll
  for (int i = K + 1; i < N; ++i) {
    const float2 u = lut_take<N>(th, Q + i - K);
    const float ur = u.x, ui = -u.y;
    wr[i] = wr[i] - (ur * wkr - ui * wki);
    wi[i] = wi[i] - (ur * wki + ui * wkr);
  }
  if constexpr (K + 1 < N) lut_forward<N, K + 1>(th, wr, wi);
}

// Pass 2, step K (from N - 1 down): w[K] -= sum_{i>K} conj(f_K[i]) w[i]
// over ascending i from zero (planes kPass1 + (N-2-K)(N-1-K)/2 + 0..N-2-K),
// then w[K] and w[p_K] swap by selects; pv holds this thread's pivot 0,
// pivot k T further.
template <int N, int K>
__device__ __forceinline__ void lut_backward(const LutThread& th, const int* pv,
                                             float (&wr)[N], float (&wi)[N]) {
  if constexpr (K < N - 1) {
    constexpr int Q = Lut<N>::kPass1 + (N - 2 - K) * (N - 1 - K) / 2;
    float sr = 0.0f, si = 0.0f;
#pragma unroll
    for (int i = K + 1; i < N; ++i) {
      const float2 f = lut_take<N>(th, Q + i - K - 1);
      const float fr = f.x, fi = -f.y;
      sr = sr + (fr * wr[i] - fi * wi[i]);
      si = si + (fr * wi[i] + fi * wr[i]);
    }
    wr[K] = wr[K] - sr;
    wi[K] = wi[K] - si;
  }
  const int p = pv[K * Lut<N>::kSystems];
#pragma unroll
  for (int r = K + 1; r < N; ++r) {
    const bool swap = r == p;
    const float kr = wr[K], ki = wi[K], xr = wr[r], xi = wi[r];
    wr[K] = swap ? xr : kr;
    wi[K] = swap ? xi : ki;
    wr[r] = swap ? kr : xr;
    wi[r] = swap ? ki : xi;
  }
  if constexpr (K > 0) lut_backward<N, K - 1>(th, pv, wr, wi);
}

// Phase 2 for one system (thread t of the block, system first + t): w from
// its g slot, the two passes, y over the g slot.
template <int N>
__device__ __forceinline__ void lut_solve(LutSmem<N>& sm, const float2* __restrict__ lu,
                                          long long first, long long k_sys) {
  const int t = static_cast<int>(threadIdx.x);
  const LutThread th{lu + first + t, k_sys, sm.ring + t, sm.order};
  const int* pv = sm.pv + t;
  float2* w = sm.gy + t * Lut<N>::kSlot;
  if constexpr (Lut<N>::kRegs) {
    float wr[N], wi[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float2 v = w[r];
      wr[r] = v.x;
      wi[r] = v.y;
    }
    lut_forward<N, 0>(th, wr, wi);
    lut_backward<N, N - 1>(th, pv, wr, wi);
#pragma unroll
    for (int r = 0; r < N; ++r) w[r] = make_float2(wr[r], wi[r]);
  } else {
    int q = 0;
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const float2 d = lut_take<N>(th, q++);
      const float dr = d.x, di = -d.y;
      const float inv_den = 1.0f / (dr * dr + di * di);
      const float2 wk = w[k];
      const float wkr = (wk.x * dr + wk.y * di) * inv_den;
      const float wki = (wk.y * dr - wk.x * di) * inv_den;
      w[k] = make_float2(wkr, wki);
      for (int i = k + 1; i < N; ++i) {
        const float2 u = lut_take<N>(th, q++);
        const float ur = u.x, ui = -u.y;
        const float2 x = w[i];
        w[i] = make_float2(x.x - (ur * wkr - ui * wki), x.y - (ur * wki + ui * wkr));
      }
    }
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      float2 wk = w[k];
      if (k < N - 1) {
        float sr = 0.0f, si = 0.0f;
        for (int i = k + 1; i < N; ++i) {
          const float2 f = lut_take<N>(th, q++);
          const float fr = f.x, fi = -f.y;
          const float2 x = w[i];
          sr = sr + (fr * x.x - fi * x.y);
          si = si + (fr * x.y + fi * x.x);
        }
        wk = make_float2(wk.x - sr, wk.y - si);
      }
      // swap w[k] and w[p] (p >= k): when p == k both stores write wk
      const int p = pv[k * Lut<N>::kSystems];
      const float2 wp = w[p];
      w[p] = wk;
      w[k] = p == k ? wk : wp;
    }
  }
}

// Phase 3 (every solve done): the y rows of the block's `systems` systems
// from the slots to y, coalesced.
template <int N>
__device__ __forceinline__ void lut_store(const LutSmem<N>& sm, float2* __restrict__ y,
                                          long long first, int systems) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int e = lut_element<N>(c);
    if (e < systems * N) y[first * N + e] = sm.gy[lut_slot<N>(e)];
  }
}

template <int N>
__global__ void lut_apply_kernel(const float2* __restrict__ lu, const int* __restrict__ piv,
                                 const float2* __restrict__ g, float2* __restrict__ y,
                                 long long k_sys) {
  if constexpr (N > kMaxTiledN) {
    constexpr int T = Lut<N>::kSystems;
    __shared__ LutSmem<N> sm;
    const long long first = blockIdx.x * static_cast<long long>(T);
    const int systems = k_sys - first < T ? static_cast<int>(k_sys - first) : T;
    lut_order<N>(sm.order);
    __syncthreads();
    lut_load<N>(sm, lu, piv, g, first, k_sys, systems);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < systems) lut_solve<N>(sm, lu, first, k_sys);
    __syncthreads();
    lut_store<N>(sm, y, first, systems);
  } else {
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
}

}  // namespace

#define LU_CASE(n)                                                                  \
  case n:                                                                           \
    lu_solve_kernel<n><<<solve_blocks<n>(k_sys), solve_threads<n>(), 0, st>>>(      \
        mi, bi, xo, luo, po, k_sys);                                                \
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
    lut_apply_kernel<n><<<lut_blocks<n>(k_sys), lut_threads<n>(), 0, st>>>(      \
        li, pi, gi, yo, k_sys);                                                 \
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
