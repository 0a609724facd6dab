"""The CUDA sources' arithmetic, checked on the CPU.

Each ``diffgfdn_torch/csrc/*.cu`` is compiled with the host C++ compiler
against a small header that stands in for the CUDA built-ins (``float2``,
``blockIdx``/``threadIdx`` as host globals, ``__global__`` and friends as
nothing); launches (``<<<...>>>``) are stripped. A small host harness then runs every
kernel thread by thread, one thread per block, and the results are compared
with the plain PyTorch versions on the same inputs. With no fused
multiply-add on either side the Gauss-Jordan inverse and its backward
-P^H G P^H, the LU factors and pivots and the transposed solve must agree
bit for bit; the LU solution sums its back substitution in another order
(now bit for bit too: the plain version adds its back substitution in the
kernel's order). The cascade kernels fuse their products with
``__fmaf_rn`` (the shim's ``fmaf``, fused and correctly rounded as on the
card) and take one reciprocal per forward output, so the forward agrees
with the plain version's per-section quotients within SOS_SOURCE_TOL of
max |h|, also where the unscaled product of |Q_k|^2 would leave float32;
the backward, given the forward's h, sums over the bins in another order
(bound 1e-5 max |gradient|). The host build takes the rounded reciprocal
where the card takes the one-instruction approximation (relative error
under 2^-22). The cascade backward's threads run one at a time through their
device function, and their sums are added into the block's partial in
thread order.
The inverse and its backward (B1, B2) and the LU solve (B5) stage tiles of
systems through shared memory for small N, with a barrier between the
copies in, the solves and the copies out: the harness runs each of those
phases thread by thread over the tile, through the kernels' own copy and
per-system device functions (the card's asynchronous copy is a plain copy
on the host). Above N = 8, B1, B2 and B5 give each lane of a warp one row
of a system and exchange pivots, rows and (B5) x through shared memory
between __syncwarp()s: the harness runs their copies thread by thread and
each phase between two barriers lane by lane, the lanes in an order
shuffled anew for every phase (on the card a warp's lanes diverge), with
shared memory NaN at the start of each block; with the barrier between
B1's or B5's pivot and elimination phases removed the result must change.
Further tests hold the tile copies, the row kernels' copies and B5's
bins-last factor stores to moving each element once.
Above N = 8 the transposed solve (B6) keeps one thread a system and fetches
each thread's factor entries through a ring of asynchronous copies in shared
memory, g and y through coalesced copies: the harness runs its phases
between barriers thread by thread in shuffled orders, the shim queuing each
thread's copies by commit group and performing them only at the wait that
needs them (in a second run, as they are issued); with the barrier after the
copies removed, or every wait one group short, y must change, and every
element of the factors, pivots and g must be copied once, every element of
y stored once.
The time-domain recursion (B7) cannot run thread by thread through its
kernel: thread 0 would reach the next block of samples before thread 1 had
written this one. Its step is a device function per thread, which the
harness drives step by step, the threads of a step in a shuffled order
(on the card they interleave in any order), for each variant: the ring in
shared memory (including its wrap-around at R slots, and blocks L that are
no power of two), the history in device memory, and above N = 12 the
coefficients in shared memory. It must agree with the plain version bit
for bit.

This checks the kernels' logic and arithmetic only: compilation for the
card, launch configuration and memory behaviour are checked on the card
(chip_smoke.py, test_torch_kernels_cuda.py).
"""

import ctypes
from pathlib import Path
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels.cinv import cinv_plain, neg_ptgpt_plain
from diffgfdn_torch.kernels.lu import lu_solve_plain, lut_apply_plain
from diffgfdn_torch.kernels.sos import sos_cascade_backward_plain, sos_cascade_plain
from diffgfdn_torch.kernels import tdgfdn as td
from diffgfdn_torch.kernels.tdgfdn import delay_line_outputs_plain, kernel_plan
from torch_port_helpers import (cascade, CINV_BLOCK_SYSTEMS, cinv_systems, KERNEL_TOL,
                                LU_BLOCK_SYSTEMS, LUT_BLOCK_SYSTEMS, max_rel, systems)

CSRC = Path(__file__).resolve().parents[1] / "diffgfdn_torch" / "csrc"
SIZES = (1, 4, 9, 12, 27)
TILE_SIZES = (1, 4, 8)  # tile-copy tests: N of the tiled kernels (N <= 8)
ROW_SIZES = (9, 12, 27)  # copy tests of the row kernels (N > 8)
LU_TILE_SIZES = (1, 4, 8)  # the tiled LU solve's N (N <= 8)
TD_SIZES = (4, 9, 12)  # B7 host tests: N of the ring and hist variants
TD_LINES_SIZES = (16, 27)  # and of the lines variant (N > 12)
H100_SMEM = 232448  # the shared memory one block may take on an H100 (opt-in)
BWD_SECTIONS = (1, 11, 16)  # the cascade backward's K in these tests
# the forward source against the plain version's per-section quotients on
# random cascades: max abs error / max |plain| (fused products, one reciprocal)
SOS_SOURCE_TOL = 1e-5
FUSED_POLYNOMIALS = (
    ("re = __fadd_rn(__fadd_rn(c0, __fmul_rn(c1, zre)), __fmul_rn(c2, z2re));",
     "re = __fmaf_rn(c2, z2re, __fmaf_rn(c1, zre, c0));"),
    ("im = __fadd_rn(__fmul_rn(c1, zim), __fmul_rn(c2, z2im));",
     "im = __fmaf_rn(c2, z2im, __fmul_rn(c1, zim));"),
)

SHIM = """
#pragma once
#include <cstddef>
#include <math.h>
#include <cstring>
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
#define __global__
#define __launch_bounds__(...)
#define __device__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __syncthreads()
#define __syncwarp()
inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
// the fp32 intrinsics: fmaf is fused and correctly rounded, as __fmaf_rn;
// __frcp_rn is the IEEE round-to-nearest reciprocal, as 1.0f / x
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
namespace { float4 coef4[1 << 14]; }  // the cascade's dynamic shared memory
// cp.async in a pipeline (csrc/lu.cu's transposed solve above N = 8): each
// thread's copies wait in its queue, grouped by commit, until a wait leaves
// at most `pending` of its groups outstanding (async_slack more: a wait one
// group short), so a read that no wait covers sees what was there before;
// async_eager performs each copy as it is issued instead; async_copy_hook,
// where set, sees every copy as it is issued
#include <deque>
#include <vector>
struct AsyncCopy { void* dst; const void* src; int bytes; };
inline std::vector<AsyncCopy> async_open[1024];
inline std::deque<std::vector<AsyncCopy>> async_groups[1024];
inline int async_slack = 0;
inline bool async_eager = false;
inline void (*async_copy_hook)(void*, const void*, int) = nullptr;
inline void host_copy_async(void* dst, const void* src, int bytes) {
  if (async_copy_hook) async_copy_hook(dst, src, bytes);
  if (async_eager) std::memcpy(dst, src, bytes);
  else async_open[threadIdx.x].push_back({dst, src, bytes});
}
inline void host_copy_commit() {
  async_groups[threadIdx.x].push_back(async_open[threadIdx.x]);
  async_open[threadIdx.x].clear();
}
inline void host_copy_wait(int pending) {
  auto& groups = async_groups[threadIdx.x];
  while ((int)groups.size() > pending + async_slack) {
    for (const AsyncCopy& c : groups.front()) std::memcpy(c.dst, c.src, c.bytes);
    groups.pop_front();
  }
}
// the copies issued and never performed, over every thread; empties the queues
inline long long host_copy_drop() {
  long long n = 0;
  for (int t = 0; t < 1024; ++t) {
    n += (long long)async_open[t].size();
    for (const auto& group : async_groups[t]) n += (long long)group.size();
    async_open[t].clear();
    async_groups[t].clear();
  }
  return n;
}
"""

_CASES = " ".join(f"case {n}: KERNEL<{n}>(ARGS); break;" for n in SIZES)
HARNESSES = {
    "cinv": """
// The lanes of each phase run in an order that a xorshift generator,
// seeded by the caller, shuffles anew for every phase.
static unsigned lane_rng = 1;
void shuffle(int* order, int n) {
  for (int i = 0; i < n; ++i) order[i] = i;
  for (int i = n - 1; i > 0; --i) {
    lane_rng ^= lane_rng << 13;
    lane_rng ^= lane_rng >> 17;
    lane_rng ^= lane_rng << 5;
    const int j = (int)(lane_rng % (unsigned)(i + 1));
    const int t = order[i];
    order[i] = order[j];
    order[j] = t;
  }
}
// the row kernels' steps K.. (N > kMaxTiledN): each phase between two
// __syncwarp()s lane by lane in a shuffled order; `fused` runs each lane's
// pivot and elimination phases back to back, as if the barrier between
// them were missing
template <int N, int K>
void emu_gj_steps(const RowLane* lanes, GjRow<N>* a, float* mag, float2* piv, float2* tile,
                  int* order, bool fused) {
  constexpr int H = Rows<N>::kThreads, S = Rows<N>::kStride;
  shuffle(order, H);
  for (int i = 0; i < H; ++i) {
    const RowLane& l = lanes[order[i]];
    if (!l.active) continue;
    gj_row_pivot<N, K>(mag + l.system * N, piv + l.system * 2 * N, a[order[i]]);
    if (fused)
      gj_row_eliminate<N, K>(piv + l.system * 2 * N, mag + l.system * N, tile + l.system * S,
                             a[order[i]]);
  }
  if (!fused) {
    shuffle(order, H);
    for (int i = 0; i < H; ++i) {
      const RowLane& l = lanes[order[i]];
      if (l.active)
        gj_row_eliminate<N, K>(piv + l.system * 2 * N, mag + l.system * N, tile + l.system * S,
                               a[order[i]]);
    }
  }
  if constexpr (K + 1 < N) emu_gj_steps<N, K + 1>(lanes, a, mag, piv, tile, order, fused);
}
// the tiled kernels (N <= kMaxTiledN) block by block, each phase thread by
// thread as the barriers order them; the row kernels block by block, the
// copies thread by thread, each phase between barriers lane by lane; shared
// memory starts each block as NaN
template <int N>
void emu_cinv_n(const float2* m, float2* o, long long k, bool fused) {
  if constexpr (N <= kMaxTiledN) {
    constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems, S = Tile<N>::kStride;
    static float2 tile[T * S];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_load<N>(m + first * E, tile, systems * E);
      }
      for (int t = 0; t < systems; ++t) gj_inverse<N>(tile + t * S, tile + t * S);
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_store<N>(tile, o + first * E, systems * E);
      }
    }
  } else {
    constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems, S = Rows<N>::kStride;
    constexpr int H = Rows<N>::kThreads;
    static float2 tile[T * S], piv[T * 2 * N];
    static float mag[T * N];
    static GjRow<N> a[H];
    RowLane lanes[H];
    int order[H];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      std::memset(tile, 0xff, sizeof tile);
      std::memset(piv, 0xff, sizeof piv);
      std::memset(mag, 0xff, sizeof mag);
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_load<N>(m + first * E, tile, systems * E);
        lanes[t] = row_lane<N>(t, systems);
      }
      shuffle(order, H);
      for (int i = 0; i < H; ++i) {
        const RowLane& l = lanes[order[i]];
        if (l.active) gj_row_start<N>(tile + l.system * S, l.row, mag + l.system * N, a[order[i]]);
      }
      emu_gj_steps<N, 0>(lanes, a, mag, piv, tile, order, fused);
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_store<N>(tile, o + first * E, systems * E);
      }
    }
  }
}
template <int N>
void emu_ptgpt_n(const float2* p, const float2* g, float2* o, long long k) {
  if constexpr (N <= kMaxTiledN) {
    constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems, S = Tile<N>::kStride;
    static float2 tile_p[T * S], tile_g[T * S];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_load<N>(p + first * E, tile_p, systems * E);
        tile_load<N>(g + first * E, tile_g, systems * E);
      }
      for (int t = 0; t < systems; ++t)
        neg_ptgpt_system<N>(tile_p + t * S, tile_g + t * S, tile_p + t * S);
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_store<N>(tile_p, o + first * E, systems * E);
      }
    }
  } else {
    constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems, S = Rows<N>::kStride;
    constexpr int H = Rows<N>::kThreads;
    static float2 tile_p[T * S], tile_g[T * S];
    static PtgptRow<N> out_rows[H];
    RowLane lanes[H];
    int order[H];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      std::memset(tile_p, 0xff, sizeof tile_p);
      std::memset(tile_g, 0xff, sizeof tile_g);
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_load<N>(p + first * E, tile_p, systems * E);
        rows_load<N>(g + first * E, tile_g, systems * E);
        lanes[t] = row_lane<N>(t, systems);
      }
      for (int phase = 0; phase < 3; ++phase) {
        shuffle(order, H);
        for (int i = 0; i < H; ++i) {
          const RowLane& l = lanes[order[i]];
          if (!l.active) continue;
          float2* sys_p = tile_p + l.system * S;
          float2* sys_t = tile_g + l.system * S;
          if (phase == 0) ptgpt_row_t<N>(sys_p, sys_t, l.row);
          if (phase == 1) ptgpt_row_out<N>(sys_p, sys_t, l.row, out_rows[order[i]]);
          if (phase == 2) ptgpt_row_store<N>(sys_p, l.row, out_rows[order[i]]);
        }
      }
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_store<N>(tile_p, o + first * E, systems * E);
      }
    }
  }
}
// every (block, thread, copy step): hits[e] counts the copies of element e
// of the K x N^2; bad counts copies to a slot outside the tile or to a slot
// another step of the same tile also took
template <int N>
void tile_cover_n(long long k, unsigned char* hits, long long* bad) {
  constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems, S = Tile<N>::kStride;
  static unsigned char slot_hits[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int i = 0; i < T * S; ++i) slot_hits[i] = 0;
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      for (int c = 0; c < E; ++c) {
        const int e = copy_element<N>(c);
        if (e >= systems * E) continue;
        hits[first * E + e] += 1;
        const int slot = tile_slot<N>(e);
        if (slot < 0 || slot >= T * S || slot_hits[slot]++) *bad += 1;
      }
    }
  }
}
// src through tile_load and tile_store into dst, tile by tile; misplaced
// counts elements that are not where the solve of their system reads them
// (element j of the tile's system s in slot s * kStride + j)
template <int N>
void tile_roundtrip_n(const float2* src, float2* dst, long long k, long long* misplaced) {
  constexpr int T = Tile<N>::kSystems, E = Tile<N>::kElems, S = Tile<N>::kStride;
  static float2 tile[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      tile_load<N>(src + first * E, tile, systems * E);
    }
    for (int s = 0; s < systems; ++s)
      for (int j = 0; j < E; ++j) {
        const float2 a = tile[s * S + j], b = src[(first + s) * E + j];
        if (std::memcmp(&a, &b, sizeof a) != 0) *misplaced += 1;
      }
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      tile_store<N>(tile, dst + first * E, systems * E);
    }
  }
}
// the row kernels' copies (N > kMaxTiledN), as tile_cover_n
template <int N>
void rows_cover_n(long long k, unsigned char* hits, long long* bad) {
  constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems, S = Rows<N>::kStride;
  static unsigned char slot_hits[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int i = 0; i < T * S; ++i) slot_hits[i] = 0;
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      for (int c = 0; c < Rows<N>::kCopies; ++c) {
        const int e = rows_element<N>(c);
        if (e >= systems * E) continue;
        hits[first * E + e] += 1;
        const int slot = rows_slot<N>(e);
        if (slot < 0 || slot >= T * S || slot_hits[slot]++) *bad += 1;
      }
    }
  }
}
// src through rows_load and rows_store, as tile_roundtrip_n; element (r, c)
// of the block's system s must be where its lane reads it, at
// s * kStride + r * kRowStride + c
template <int N>
void rows_roundtrip_n(const float2* src, float2* dst, long long k, long long* misplaced) {
  constexpr int T = Rows<N>::kSystems, E = Rows<N>::kElems, S = Rows<N>::kStride;
  static float2 tile[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      rows_load<N>(src + first * E, tile, systems * E);
    }
    for (int s = 0; s < systems; ++s)
      for (int j = 0; j < E; ++j) {
        const float2 a = tile[s * S + (j / N) * Rows<N>::kRowStride + j % N];
        const float2 b = src[(first + s) * E + j];
        if (std::memcmp(&a, &b, sizeof a) != 0) *misplaced += 1;
      }
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      rows_store<N>(tile, dst + first * E, systems * E);
    }
  }
}
extern "C" void emu(const void* m, void* out, long long k, int n, unsigned seed, int fused) {
  auto mi = (const float2*)m; auto o = (float2*)out;
  lane_rng = seed | 1u;
  switch (n) { CASES }
}""".replace("CASES", _CASES.replace("KERNEL", "emu_cinv_n").replace("ARGS", "mi, o, k, fused")) + """
extern "C" void emu_ptgpt(const void* p, const void* g, void* out, long long k, int n,
                          unsigned seed) {
  auto pi = (const float2*)p; auto gi = (const float2*)g; auto o = (float2*)out;
  lane_rng = seed | 1u;
  switch (n) { CASES }
}""".replace("CASES", _CASES.replace("KERNEL", "emu_ptgpt_n").replace("ARGS", "pi, gi, o, k")) + """
extern "C" int tile_systems(int n) {
  switch (n) { TILE_CASES }
  return 0;
}
extern "C" void tile_cover(long long k, int n, void* hits, long long* bad) {
  switch (n) { COVER_CASES }
}
extern "C" void tile_roundtrip(const void* src, void* dst, long long k, int n,
                               long long* misplaced) {
  switch (n) { ROUNDTRIP_CASES }
}""".replace("TILE_CASES", " ".join(
        f"case {n}: return block_systems<{n}>();" for n in sorted(set(TILE_SIZES + SIZES)))).replace(
    "COVER_CASES", " ".join(
        f"case {n}: {'tile' if n <= 8 else 'rows'}_cover_n<{n}>(k, (unsigned char*)hits, bad); "
        "break;" for n in TILE_SIZES + ROW_SIZES)).replace(
    "ROUNDTRIP_CASES", " ".join(
        f"case {n}: {'tile' if n <= 8 else 'rows'}_roundtrip_n<{n}>((const float2*)src, "
        "(float2*)dst, k, misplaced); break;" for n in TILE_SIZES + ROW_SIZES)),
    "lu": """
// The lanes of each phase run in an order that a xorshift generator,
// seeded by the caller, shuffles anew for every phase.
static unsigned lane_rng = 1;
void shuffle(int* order, int n) {
  for (int i = 0; i < n; ++i) order[i] = i;
  for (int i = n - 1; i > 0; --i) {
    lane_rng ^= lane_rng << 13;
    lane_rng ^= lane_rng >> 17;
    lane_rng ^= lane_rng << 5;
    const int j = (int)(lane_rng % (unsigned)(i + 1));
    const int t = order[i];
    order[i] = order[j];
    order[j] = t;
  }
}
// the row solve's back substitution, steps K..0, each phase lane by lane in
// a shuffled order
template <int N, int K>
void emu_lu_back(const RowLane* lanes, const LuSlot* slots, LuRow<N>* a, int* order) {
  constexpr int H = Rows<N>::kThreads;
  shuffle(order, H);
  for (int i = 0; i < H; ++i)
    if (lanes[order[i]].active) lu_row_back<N, K>(slots[order[i]], a[order[i]]);
  if constexpr (K > 0) emu_lu_back<N, K - 1>(lanes, slots, a, order);
}
// the row solve's steps K.. (N > kMaxTiledN): each phase between two
// __syncwarp()s lane by lane in a shuffled order; `fused` runs each lane's
// pivot and elimination phases back to back, as if the barrier after the
// pivot's publication were missing
template <int N, int K>
void emu_lu_steps(const RowLane* lanes, const LuSlot* slots, LuRow<N>* a, int* order,
                  bool fused) {
  constexpr int H = Rows<N>::kThreads;
  shuffle(order, H);
  for (int i = 0; i < H; ++i) {
    const int t = order[i];
    if (!lanes[t].active) continue;
    lu_row_pivot<N, K>(slots[t], a[t]);
    if constexpr (K + 1 < N) {
      if (fused) lu_row_eliminate<N, K>(slots[t], a[t]);
    }
  }
  if constexpr (K + 1 < N) {
    if (!fused) {
      shuffle(order, H);
      for (int i = 0; i < H; ++i)
        if (lanes[order[i]].active) lu_row_eliminate<N, K>(slots[order[i]], a[order[i]]);
    }
    emu_lu_steps<N, K + 1>(lanes, slots, a, order, fused);
  } else {
    emu_lu_back<N, N - 1>(lanes, slots, a, order);
  }
}
// the tiled solve (N <= kMaxTiledN) block by block, each phase thread by
// thread as the barriers order them; the row solve block by block, the
// copies thread by thread, each phase between barriers lane by lane; shared
// memory starts each block as NaN (the pivots as -1)
template <int N>
void emu_lu_n(const float2* m, const float2* b, float2* x, float2* lu, int* piv, long long k,
              bool fused) {
  if constexpr (N <= kMaxTiledN) {
    constexpr int T = Tile<N>::kSystems, S = Tile<N>::kStride, E = N * N;
    static float2 tile[T * S];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_load<N, E, 0>(m + first * E, tile, systems * E);
        tile_load<N, N, E>(b + first * N, tile, systems * N);
      }
      for (int t = 0; t < systems; ++t)
        lu_solve_system<N>(tile + t * S, tile + t * S + E, tile + t * S + E, lu, piv, first + t, k);
      for (int t = 0; t < T; ++t) {
        threadIdx = dim3(t);
        tile_store<N, N, E>(tile, x + first * N, systems * N);
      }
    }
  } else {
    constexpr int T = Rows<N>::kSystems, S = Rows<N>::kStride, H = Rows<N>::kThreads;
    static float2 mat[T * S], vec[T * N];
    static float mag[T * N];
    static int pv[T * N];
    static LuRow<N> a[H];
    static RowLane lanes[H];
    static LuSlot slots[H];
    int order[H];
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      std::memset(mat, 0xff, sizeof mat);
      std::memset(vec, 0xff, sizeof vec);
      std::memset(mag, 0xff, sizeof mag);
      std::memset(pv, 0xff, sizeof pv);
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_load<N>(m + first * N * N, b + first * N, mat, vec, systems * N * N, systems * N);
        lanes[t] = row_lane<N>(t, systems);
        slots[t] = lu_slot<N>(mat, vec, mag, pv, lanes[t].system);
      }
      shuffle(order, H);
      for (int i = 0; i < H; ++i)
        if (lanes[order[i]].active) lu_row_start<N>(slots[order[i]], lanes[order[i]].row, a[order[i]]);
      emu_lu_steps<N, 0>(lanes, slots, a, order, fused);
      for (int t = 0; t < H; ++t) {
        threadIdx = dim3(t);
        rows_store<N>(mat, vec, pv, x, lu, piv, first, k, systems);
      }
    }
  }
}
// the row solve's copies (N > kMaxTiledN) over every block, thread and copy
// step: hits_m / hits_b count the loads of each element of the K x N^2
// matrices and K x N right-hand sides, hits_x / hits_lu / hits_piv the
// stores of each element of x (K, N), the factors (N, N, K) and the pivots
// (N, K); bad counts loads to a slot outside the block's or taken twice, and
// stores from a slot outside or read twice
template <int N>
void lu_rows_cover_n(long long k, unsigned char* hits_m, unsigned char* hits_b,
                     unsigned char* hits_x, unsigned char* hits_lu, unsigned char* hits_piv,
                     long long* bad) {
  constexpr int T = Rows<N>::kSystems, S = Rows<N>::kStride;
  static unsigned char mat_hits[T * S], vec_hits[T * N], mat_reads[T * S], vec_reads[T * N],
      pv_reads[T * N];
  auto take = [&](unsigned char* used, int slot, int size) {
    if (slot < 0 || slot >= size || used[slot]++) *bad += 1;
  };
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    std::memset(mat_hits, 0, sizeof mat_hits);
    std::memset(vec_hits, 0, sizeof vec_hits);
    std::memset(mat_reads, 0, sizeof mat_reads);
    std::memset(vec_reads, 0, sizeof vec_reads);
    std::memset(pv_reads, 0, sizeof pv_reads);
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      for (int c = 0; c < Rows<N>::kMatCopies; ++c) {
        const int e = rows_element<N>(c);
        if (e < systems * N * N) {
          hits_m[first * N * N + e] += 1;
          take(mat_hits, rows_slot<N>(e), T * S);
        }
        const PlaneElement q = plane_element<N>(e);
        if (q.plane < N * N && q.system < systems) {
          hits_lu[q.plane * k + first + q.system] += 1;
          take(mat_reads, factor_slot<N>(q.system, q.plane / N, q.plane % N), T * S);
        }
      }
      for (int c = 0; c < Rows<N>::kVecCopies; ++c) {
        const int e = rows_element<N>(c);
        if (e < systems * N) {
          hits_b[first * N + e] += 1;
          hits_x[first * N + e] += 1;
          take(vec_hits, e, T * N);
          take(vec_reads, e, T * N);
        }
        const PlaneElement q = plane_element<N>(e);
        if (q.plane < N && q.system < systems) {
          hits_piv[q.plane * k + first + q.system] += 1;
          take(pv_reads, q.system * N + q.plane, T * N);
        }
      }
    }
  }
}
// m and b through rows_load, then the slots through rows_store into x, lu
// and piv, block by block, the pivot slots holding (first + s) * N + j;
// misplaced counts elements not where the row solve reads them (element
// (r, c) of the block's system s at factor_slot(s, r, c), entry j of b at
// s * N + j)
template <int N>
void lu_rows_roundtrip_n(const float2* m, const float2* b, float2* x, float2* lu, int* piv,
                         long long k, long long* misplaced) {
  constexpr int T = Rows<N>::kSystems, S = Rows<N>::kStride;
  static float2 mat[T * S], vec[T * N];
  static int pv[T * N];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      rows_load<N>(m + first * N * N, b + first * N, mat, vec, systems * N * N, systems * N);
    }
    for (int s = 0; s < systems; ++s)
      for (int j = 0; j < N; ++j) {
        for (int c = 0; c < N; ++c)
          if (std::memcmp(&mat[factor_slot<N>(s, j, c)], &m[((first + s) * N + j) * N + c],
                          sizeof(float2)) != 0)
            *misplaced += 1;
        if (std::memcmp(&vec[s * N + j], &b[(first + s) * N + j], sizeof(float2)) != 0)
          *misplaced += 1;
        pv[s * N + j] = (int)((first + s) * N + j);
      }
    for (int t = 0; t < Rows<N>::kThreads; ++t) {
      threadIdx = dim3(t);
      rows_store<N>(mat, vec, pv, x, lu, piv, first, k, systems);
    }
  }
}
// every (block, thread, copy step) of the m and b tile loads: hits_m[e]
// (hits_b[e]) counts the copies of element e of the K x N^2 matrices (the
// K x N right-hand sides); bad counts copies to a slot outside the tile or
// to a slot another copy of the same tile also took
template <int N>
void lu_tile_cover_n(long long k, unsigned char* hits_m, unsigned char* hits_b, long long* bad) {
  constexpr int T = Tile<N>::kSystems, S = Tile<N>::kStride, E = N * N;
  static unsigned char slot_hits[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int i = 0; i < T * S; ++i) slot_hits[i] = 0;
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      for (int c = 0; c < E; ++c) {
        const int e = copy_element<N>(c);
        if (e >= systems * E) continue;
        hits_m[first * E + e] += 1;
        const int slot = tile_slot<N, E, 0>(e);
        if (slot < 0 || slot >= T * S || slot_hits[slot]++) *bad += 1;
      }
      for (int c = 0; c < N; ++c) {
        const int e = copy_element<N>(c);
        if (e >= systems * N) continue;
        hits_b[first * N + e] += 1;
        const int slot = tile_slot<N, N, E>(e);
        if (slot < 0 || slot >= T * S || slot_hits[slot]++) *bad += 1;
      }
    }
  }
}
// m and b through tile_load, the b slots through tile_store into dst, tile
// by tile; misplaced counts elements that are not where the solve of their
// system reads them (element j of the tile's system s in slot s * kStride +
// j for m, s * kStride + N^2 + j for b)
template <int N>
void lu_tile_roundtrip_n(const float2* m, const float2* b, float2* dst, long long k,
                         long long* misplaced) {
  constexpr int T = Tile<N>::kSystems, S = Tile<N>::kStride, E = N * N;
  static float2 tile[T * S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      tile_load<N, E, 0>(m + first * E, tile, systems * E);
      tile_load<N, N, E>(b + first * N, tile, systems * N);
    }
    for (int s = 0; s < systems; ++s) {
      for (int j = 0; j < E; ++j)
        if (std::memcmp(&tile[s * S + j], &m[(first + s) * E + j], sizeof(float2)) != 0)
          *misplaced += 1;
      for (int j = 0; j < N; ++j)
        if (std::memcmp(&tile[s * S + E + j], &b[(first + s) * N + j], sizeof(float2)) != 0)
          *misplaced += 1;
    }
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      tile_store<N, N, E>(tile, dst + first * N, systems * N);
    }
  }
}
extern "C" void emu(const void* m, const void* b, void* x, void* lu, void* piv,
                    long long k, int n, unsigned seed, int fused) {
  auto mi = (const float2*)m; auto bi = (const float2*)b; auto xo = (float2*)x;
  auto lo = (float2*)lu; auto po = (int*)piv;
  lane_rng = seed | 1u;
  switch (n) { CASES }
}""".replace("CASES", _CASES.replace("KERNEL", "emu_lu_n")
             .replace("ARGS", "mi, bi, xo, lo, po, k, fused")) + """
// B6: for N <= kMaxTiledN the kernel thread by thread, one a block; above,
// block by block, the order table, the copies in, the solves and the stores
// out each a phase, thread by thread in an order shuffled anew for every
// phase, shared memory NaN (order and pivots -1) at each block's start and
// the copies deferred to the waits that need them (async_eager: performed
// at once). fault 1 runs each thread's copies and its solve back to back,
// as if the barrier after the copies were missing; fault 2 leaves one
// group more in flight at every wait. Returns the copies issued and never
// performed.
template <int N>
long long emu_lut_n(const float2* lu, const int* piv, const float2* g, float2* y, long long k,
                    int fault) {
  if constexpr (N <= kMaxTiledN) {
    threadIdx = dim3(0);
    for (long long s = 0; s < k; ++s) {
      blockIdx = dim3((unsigned)s);
      lut_apply_kernel<N>(lu, piv, g, y, k);
    }
    return 0;
  } else {
    constexpr int T = Lut<N>::kSystems;
    static LutSmem<N> sm;
    int perm[T];
    long long dropped = 0;
    async_slack = fault == 2 ? 1 : 0;
    host_copy_drop();
    for (long long first = 0; first < k; first += T) {
      const int systems = k - first < T ? (int)(k - first) : T;
      std::memset(&sm, 0xff, sizeof sm);
      shuffle(perm, T);
      for (int i = 0; i < T; ++i) {
        threadIdx = dim3(perm[i]);
        lut_order<N>(sm.order);
      }
      shuffle(perm, T);
      for (int i = 0; i < T; ++i) {
        threadIdx = dim3(perm[i]);
        lut_load<N>(sm, lu, piv, g, first, k, systems);
        if (fault == 1 && perm[i] < systems) lut_solve<N>(sm, lu, first, k);
      }
      if (fault != 1) {
        shuffle(perm, T);
        for (int i = 0; i < T; ++i) {
          threadIdx = dim3(perm[i]);
          if (perm[i] < systems) lut_solve<N>(sm, lu, first, k);
        }
      }
      shuffle(perm, T);
      for (int i = 0; i < T; ++i) {
        threadIdx = dim3(perm[i]);
        lut_store<N>(sm, y, first, systems);
      }
      dropped += host_copy_drop();
    }
    async_slack = 0;
    return dropped;
  }
}
extern "C" long long emu_lut(const void* lu, const void* piv, const void* g, void* y,
                             long long k, int n, unsigned seed, int fault, int eager) {
  auto li = (const float2*)lu; auto pi = (const int*)piv; auto gi = (const float2*)g;
  auto yo = (float2*)y;
  lane_rng = seed | 1u;
  async_eager = eager != 0;
  long long dropped = -1;
  switch (n) { CASES }
  async_eager = false;
  return dropped;
}
// B6's copies above N = 8: the sources of every copy the emulation issues
// counted per element of lu, piv and g (cover_bad: a copy of another size,
// off an element, or from outside the three); then, over every block,
// thread and copy step of the g / y mapping, the y element each stores
// counted, and a g / y slot outside the block's or taken twice counted bad
static const char* cover_base[3];
static long long cover_len[3];
static int cover_size[3];
static unsigned char* cover_hits[3];
static long long cover_bad;
static void cover_hook(void*, const void* src, int bytes) {
  const char* p = (const char*)src;
  for (int a = 0; a < 3; ++a) {
    if (p < cover_base[a] || p >= cover_base[a] + cover_len[a]) continue;
    const long long off = p - cover_base[a];
    if (bytes != cover_size[a] || off % cover_size[a] != 0) ++cover_bad;
    else cover_hits[a][off / cover_size[a]] += 1;
    return;
  }
  ++cover_bad;
}
template <int N>
void lut_y_cover_n(long long k, unsigned char* hits_y, long long* bad) {
  constexpr int T = Lut<N>::kSystems, S = T * Lut<N>::kSlot;
  static unsigned char slot_hits[S];
  for (long long first = 0; first < k; first += T) {
    const int systems = k - first < T ? (int)(k - first) : T;
    std::memset(slot_hits, 0, sizeof slot_hits);
    for (int t = 0; t < T; ++t) {
      threadIdx = dim3(t);
      for (int c = 0; c < N; ++c) {
        const int e = lut_element<N>(c);
        if (e >= systems * N) continue;
        hits_y[first * N + e] += 1;
        const int slot = lut_slot<N>(e);
        if (slot < 0 || slot >= S || slot_hits[slot]++) *bad += 1;
      }
    }
  }
}
extern "C" long long lut_cover(const void* lu, const void* piv, const void* g, void* y,
                               long long k, int n, void* hits_lu, void* hits_piv,
                               void* hits_g, void* hits_y, long long* bad) {
  const void* bases[3] = {lu, piv, g};
  const int sizes[3] = {8, 4, 8};
  const long long counts[3] = {(long long)n * n * k, (long long)n * k, (long long)n * k};
  void* hits[3] = {hits_lu, hits_piv, hits_g};
  for (int a = 0; a < 3; ++a) {
    cover_base[a] = (const char*)bases[a];
    cover_len[a] = counts[a] * sizes[a];
    cover_size[a] = sizes[a];
    cover_hits[a] = (unsigned char*)hits[a];
  }
  cover_bad = 0;
  async_copy_hook = cover_hook;
  const long long dropped = emu_lut(lu, piv, g, y, k, n, 1, 0, 0);
  async_copy_hook = nullptr;
  *bad = cover_bad;
  switch (n) { Y_COVER_CASES }
  return dropped;
}
extern "C" int lut_systems(int n) {
  switch (n) { LUT_SYSTEMS_CASES }
  return 0;
}""".replace("Y_COVER_CASES", " ".join(
        f"case {n}: lut_y_cover_n<{n}>(k, (unsigned char*)hits_y, bad); break;" for n in ROW_SIZES)
        ).replace("LUT_SYSTEMS_CASES", " ".join(
        f"case {n}: return lut_threads<{n}>();" for n in SIZES)).replace("CASES", " ".join(
        f"case {n}: dropped = emu_lut_n<{n}>(li, pi, gi, yo, k, fault); break;" for n in SIZES)
        ) + """
extern "C" int tile_systems(int n) {
  switch (n) { TILE_CASES }
  return 0;
}
extern "C" void tile_cover(long long k, int n, void* hits_m, void* hits_b, long long* bad) {
  switch (n) { COVER_CASES }
}
extern "C" void tile_roundtrip(const void* m, const void* b, void* dst, long long k, int n,
                               long long* misplaced) {
  switch (n) { ROUNDTRIP_CASES }
}
extern "C" int rows_per_warp(int n) {
  switch (n) { PER_WARP_CASES }
  return 0;
}
extern "C" void rows_cover(long long k, int n, void* hits_m, void* hits_b, void* hits_x,
                           void* hits_lu, void* hits_piv, long long* bad) {
  switch (n) { ROWS_COVER_CASES }
}
extern "C" void rows_roundtrip(const void* m, const void* b, void* x, void* lu, void* piv,
                               long long k, int n, long long* misplaced) {
  switch (n) { ROWS_ROUNDTRIP_CASES }
}""".replace("TILE_CASES", " ".join(
        f"case {n}: return solve_systems<{n}>();" for n in LU_TILE_SIZES + ROW_SIZES)).replace(
    "PER_WARP_CASES", " ".join(f"case {n}: return Rows<{n}>::kPerWarp;" for n in ROW_SIZES)).replace(
    "ROWS_COVER_CASES", " ".join(
        f"case {n}: lu_rows_cover_n<{n}>(k, (unsigned char*)hits_m, (unsigned char*)hits_b, "
        "(unsigned char*)hits_x, (unsigned char*)hits_lu, (unsigned char*)hits_piv, bad); break;"
        for n in ROW_SIZES)).replace(
    "ROWS_ROUNDTRIP_CASES", " ".join(
        f"case {n}: lu_rows_roundtrip_n<{n}>((const float2*)m, (const float2*)b, (float2*)x, "
        "(float2*)lu, (int*)piv, k, misplaced); break;" for n in ROW_SIZES)).replace(
    "COVER_CASES", " ".join(
        f"case {n}: lu_tile_cover_n<{n}>(k, (unsigned char*)hits_m, (unsigned char*)hits_b, "
        "bad); break;" for n in LU_TILE_SIZES)).replace(
    "ROUNDTRIP_CASES", " ".join(
        f"case {n}: lu_tile_roundtrip_n<{n}>((const float2*)m, (const float2*)b, (float2*)dst, "
        "k, misplaced); break;" for n in LU_TILE_SIZES)),
    "sos": """
// one thread per block, kFwdBins consecutive bins each; the section counts
// of these tests through their own instantiations, as on the card
extern "C" void emu(const void* num, const void* den, const void* w, void* h,
                    int rows, int k, long long f) {
  blockDim = dim3(1);
  auto nu = (const float*)num; auto de = (const float*)den; auto wi = (const float2*)w;
  auto ho = (float2*)h;
  for (int r = 0; r < rows; ++r)
    for (long long b = 0; b * kFwdBins < f; ++b) {
      blockIdx = dim3((unsigned)b, (unsigned)r);
      switch (k) {
        case 1: sos_cascade_kernel<1>(nu, de, wi, ho, k, f); break;
        case 11: sos_cascade_kernel<11>(nu, de, wi, ho, k, f); break;
        case 16: sos_cascade_kernel<16>(nu, de, wi, ho, k, f); break;
        default: sos_cascade_kernel<0>(nu, de, wi, ho, k, f);
      }
    }
}
// every thread of every block, one at a time, through bwd_accumulate; each
// thread's sums are added into its block's partial row in thread order, where
// the card reduces them by shuffles; then the reduction kernel
template <int K>
void emu_bwd_k(const float* nu, const float* de, const float2* wi, const float2* gi,
               const float2* hi, float* part, int rows, long long f, int n_blocks) {
  constexpr int V = 6 * ((K + kSplit - 1) / kSplit);
  static float4 c4[2 * K];
  for (int r = 0; r < rows; ++r) {
    stage(nu, de, r, K, c4);
    for (int b = 0; b < n_blocks; ++b) {
      float* out = part + ((long long)b * rows + r) * 6 * K;
      for (int v = 0; v < 6 * K; ++v) out[v] = 0.0f;
      for (int t = 0; t < kThreads; ++t) {
        float acc[V] = {};
        long long f0, stride;
        int p;
        bwd_thread(t, b, n_blocks, f0, stride, p);
        bwd_accumulate<K>(c4, wi, gi + r * f, hi + r * f, f0, stride, f, p, acc);
        for (int v = 0; v < V; ++v) {
          const int slot = bwd_slot<K>(p, v);
          if (slot >= 0) out[slot] += acc[v];
        }
      }
    }
  }
}
extern "C" void emu_bwd(const void* num, const void* den, const void* w, const void* g,
                        const void* h, void* partial, void* dnum, void* dden, int rows,
                        int k, long long f, int n_blocks) {
  blockDim = dim3(1);
  auto nu = (const float*)num; auto de = (const float*)den; auto wi = (const float2*)w;
  auto gi = (const float2*)g; auto hi = (const float2*)h; auto part = (float*)partial;
  switch (k) { BWD_CASES }
  for (long long i = 0; i < (long long)rows * 6 * k; ++i) {
    blockIdx = dim3((unsigned)i);
    sos_bwd_reduce_kernel(part, (float*)dnum, (float*)dden, n_blocks, rows, 3 * k);
  }
}""".replace("BWD_CASES", " ".join(
        f"case {n}: emu_bwd_k<{n}>(nu, de, wi, gi, hi, part, rows, f, n_blocks); break;"
        for n in BWD_SECTIONS)),
    "tdgfdn": """
// each variant step by step; within a step the threads run one after
// another in the order `order` (a permutation of the block's threads)
TdArgs make_args(const float* coef, const float* u, float* y, float* hist, long long t_len,
                 const int* d, int n, int block, int ring) {
  TdArgs p = {};
  p.coef = coef; p.u = u; p.y = y; p.hist = hist; p.t_len = t_len; p.block = block; p.ring = ring;
  for (int i = 0; i < n; ++i) {
    p.delay[i] = d[i];
    p.m_max = d[i] > p.m_max ? d[i] : p.m_max;
  }
  return p;
}
template <int N>
void emu_ring_n(const TdArgs& p, float* ring, int threads, const int* order) {
  Coef<N> c;
  c.load(p.coef);
  for (int k = 0; k < threads; ++k)
    zero_floats(ring, (long long)N * ring_row(p), order[k], threads);
  int base = 0;
  for (long long start = 0; start < p.t_len; start += p.block) {
    for (int k = 0; k < threads; ++k) {
      float u_first[kGroup];
      group_input(p, start + (long long)order[k] * kGroup, u_first);
      ring_step<N>(p, c, ring, start, base, order[k], threads, u_first);
    }
    base = ring_advance(base, p);
  }
}
template <int N>
void emu_hist_n(const TdArgs& p, int threads, const int* order) {
  Coef<N> c;
  c.load(p.coef);
  for (int k = 0; k < threads; ++k) hist_zero(p, N, order[k], threads);
  for (long long start = 0; start < p.t_len; start += p.block)
    for (int k = 0; k < threads; ++k) hist_step<N>(p, c, start, order[k], threads);
}
// the lines variant: its coefficients staged, its history zeroed, then each
// step thread by thread; `fused` runs each thread through two steps back to
// back, as if the barrier between them were missing
template <int N>
void emu_lines_n(const TdArgs& p, int threads, const int* order, bool fused) {
  alignas(16) static float rows[LinesCoef<N>::kFloats];
  std::memset(rows, 0xff, sizeof rows);
  for (int k = 0; k < threads; ++k) lines_stage<N>(p.coef, rows, order[k], threads);
  for (int k = 0; k < threads; ++k) hist_zero(p, N, order[k], threads);
  const long long stride = fused ? 2LL * p.block : p.block;
  for (long long start = 0; start < p.t_len; start += stride)
    for (int k = 0; k < threads; ++k) {
      lines_step<N>(p, rows, start, order[k], threads);
      if (fused) lines_step<N>(p, rows, start + p.block, order[k], threads);
    }
}
extern "C" int register_lines() { return kRegisterLines; }
// variant 0 hist and 2 lines (buf: the (N, T + m_max) history), 1 ring (buf:
// N rows of ring + kGroup)
extern "C" void emu(int variant, const void* coef, const void* u, void* y, void* buf,
                    long long t_len, const int* d, int n, int block, int threads, int ring,
                    const int* order, int fused) {
  const TdArgs p = make_args((const float*)coef, (const float*)u, (float*)y,
                             variant != 1 ? (float*)buf : nullptr, t_len, d, n, block, ring);
  float* b = (float*)buf;
  if (variant == 0) {
    switch (n) { HIST_CASES }
  } else if (variant == 1) {
    switch (n) { RING_CASES }
  } else {
    switch (n) { LINES_CASES }
  }
}""".replace("HIST_CASES", " ".join(
        f"case {n}: emu_hist_n<{n}>(p, threads, order); break;" for n in TD_SIZES)).replace(
    "RING_CASES", " ".join(
        f"case {n}: emu_ring_n<{n}>(p, b, threads, order); break;" for n in TD_SIZES)).replace(
    "LINES_CASES", " ".join(
        f"case {n}: emu_lines_n<{n}>(p, threads, order, fused); break;" for n in TD_LINES_SIZES)),
}


def _host_unit(name: str, build: Path, fused_polynomials: bool = False) -> Path:
    """Write csrc/<name>.cu as a host translation unit with its harness;
    ``fused_polynomials`` evaluates the cascade's polynomials with fused
    multiply-adds instead (for the test that shows why they are not)."""
    (build / "shim.h").write_text(SHIM)
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    if fused_polynomials:
        for old, new in FUSED_POLYNOMIALS:
            assert old in src
            src = src.replace(old, new)
    unit = build / f"{name}{'_fused' if fused_polynomials else ''}_host.cpp"
    unit.write_text('#include "shim.h"\n'
                    'dim3 blockIdx, threadIdx(0, 0, 0), blockDim(1, 1, 1), gridDim;\n'
                    + src + HARNESSES[name])
    return unit


def _compile(unit: Path) -> subprocess.Popen:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return subprocess.Popen(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-shared", "-fPIC",
         "-o", str(unit.with_suffix(".so")), str(unit)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _load(unit: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    log, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, log
    return ctypes.CDLL(str(unit.with_suffix(".so")))


def _build_host(name: str, build: Path, fused_polynomials: bool = False) -> ctypes.CDLL:
    unit = _host_unit(name, build, fused_polynomials)
    return _load(unit, _compile(unit))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{name: ctypes library} of the CUDA sources built for the host."""
    build = tmp_path_factory.mktemp("kernel_sources")
    units = {name: _host_unit(name, build) for name in HARNESSES}
    procs = {name: _compile(unit) for name, unit in units.items()}
    return {name: _load(units[name], proc) for name, proc in procs.items()}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _emulate_cinv(lib, m, seed=0, fused=False):
    out = np.empty_like(m)
    lib.emu(_ptr(m), _ptr(out), ctypes.c_longlong(len(m)), ctypes.c_int(m.shape[-1]),
            ctypes.c_uint(seed), ctypes.c_int(fused))
    return out


def _emulate_ptgpt(lib, p, g, seed=0):
    out = np.empty_like(p)
    lib.emu_ptgpt(_ptr(p), _ptr(g), _ptr(out), ctypes.c_longlong(len(p)),
                  ctypes.c_int(p.shape[-1]), ctypes.c_uint(seed))
    return out


@pytest.mark.parametrize("n", SIZES)
def test_cinv_source_matches_plain_bitwise(emulated, n):
    """150 systems; above N = 8 the row kernel's phases lane by lane, the
    lanes of each phase in a shuffled order."""
    m = cinv_systems(150, n, seed=n)
    out = _emulate_cinv(emulated["cinv"], m, seed=n)
    np.testing.assert_array_equal(out, cinv_plain(torch.from_numpy(m)).numpy())


def test_cinv_block_systems_are_those_the_card_tests_take(emulated):
    """tests/test_torch_kernels_cuda.py sets its K around csrc/cinv.cu's
    systems a block; they must be the source's."""
    for n, systems_a_block in CINV_BLOCK_SYSTEMS.items():
        assert emulated["cinv"].tile_systems(ctypes.c_int(n)) == systems_a_block


# the row kernel at N = 9 (12 systems a block, 3 a warp): a single system,
# a last block one short, one past a block, and a last block whose second
# warp holds one system
ROW_PARTIAL_K = {"1": 1, "T-1": 11, "T+1": 13, "T+4": 16}


@pytest.mark.parametrize("k", ROW_PARTIAL_K.values(), ids=ROW_PARTIAL_K.keys())
def test_cinv_row_kernel_partial_last_block_matches_plain_bitwise(emulated, k):
    assert CINV_BLOCK_SYSTEMS[9] == 12
    m = cinv_systems(k, 9, seed=500 + k)
    out = _emulate_cinv(emulated["cinv"], m, seed=k)
    np.testing.assert_array_equal(out, cinv_plain(torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("k", ROW_PARTIAL_K.values(), ids=ROW_PARTIAL_K.keys())
def test_neg_ptgpt_row_kernel_partial_last_block_matches_plain_bitwise(emulated, k):
    p, _ = systems(k, 9, seed=600 + k)
    g, _ = systems(k, 9, seed=700 + k)
    out = _emulate_ptgpt(emulated["cinv"], p, g, seed=k)
    np.testing.assert_array_equal(out, neg_ptgpt_plain(torch.from_numpy(p),
                                                       torch.from_numpy(g)).numpy())


@pytest.mark.parametrize("n", [9, 27])
def test_cinv_row_kernel_needs_its_barriers(emulated, n):
    """Why each step has two phases: with each lane's pivot and elimination
    run back to back (the __syncwarp between them missing), a lane that runs
    before its system's pivot lane eliminates with a pivot row not yet
    published, and the result changes."""
    m = cinv_systems(24, n, seed=n)
    ref = cinv_plain(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(_emulate_cinv(emulated["cinv"], m, seed=3), ref)
    assert not np.array_equal(_emulate_cinv(emulated["cinv"], m, seed=3, fused=True), ref)


@pytest.mark.parametrize("k_of_tile", [lambda t: t - 1, lambda t: t, lambda t: t + 1,
                                       lambda t: 3 * 65537], ids=["T-1", "T", "T+1", "3x65537"])
@pytest.mark.parametrize("n", TILE_SIZES)
def test_cinv_tile_copies_cover_each_element_once(emulated, n, k_of_tile):
    """The tiled kernels' copies between device and shared memory: over every
    block, thread and copy step, each of the K x N^2 elements is moved once
    (the loads and the stores share the mapping), each into its own slot
    of its tile, and the slot is where its system's solve reads it; a
    round trip through tile_load and tile_store from a base 8 bytes past a
    16-byte boundary gives the same bits and touches nothing outside."""
    lib = emulated["cinv"]
    k = k_of_tile(lib.tile_systems(ctypes.c_int(n)))
    count = k * n * n
    hits = np.zeros(count, np.uint8)
    bad, misplaced = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.tile_cover(ctypes.c_longlong(k), ctypes.c_int(n), _ptr(hits), ctypes.byref(bad))
    assert bad.value == 0
    np.testing.assert_array_equal(hits, 1)
    buf = np.arange(2 * count + 4, dtype=np.uint32).view(np.complex64)  # distinct bits
    src = buf[1:-1]  # 8 bytes past the buffer's 16-byte-aligned start
    assert src.ctypes.data % 16 == 8
    out = np.full(count + 2, 7 + 7j, np.complex64)
    lib.tile_roundtrip(_ptr(src), _ptr(out[1:-1]), ctypes.c_longlong(k), ctypes.c_int(n),
                       ctypes.byref(misplaced))
    assert misplaced.value == 0
    np.testing.assert_array_equal(out[1:-1].view(np.uint64), src.view(np.uint64))
    assert out[0] == out[-1] == 7 + 7j


@pytest.mark.parametrize("k_of_block", [lambda t: t - 1, lambda t: t, lambda t: t + 1,
                                        lambda t: 1000], ids=["T-1", "T", "T+1", "1000"])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_cinv_row_copies_cover_each_element_once(emulated, n, k_of_block):
    """The row kernels' copies (N > 8): over every block, thread and copy
    step, each of the K x N^2 elements is moved once, into its own slot of
    the block's tile, where the lane of its row reads it; a round trip
    through rows_load and rows_store from a base 8 bytes past a 16-byte
    boundary gives the same bits and touches nothing outside."""
    lib = emulated["cinv"]
    k = k_of_block(lib.tile_systems(ctypes.c_int(n)))
    count = k * n * n
    hits = np.zeros(count, np.uint8)
    bad, misplaced = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.tile_cover(ctypes.c_longlong(k), ctypes.c_int(n), _ptr(hits), ctypes.byref(bad))
    assert bad.value == 0
    np.testing.assert_array_equal(hits, 1)
    buf = np.arange(2 * count + 4, dtype=np.uint32).view(np.complex64)  # distinct bits
    src = buf[1:-1]  # 8 bytes past the buffer's 16-byte-aligned start
    assert src.ctypes.data % 16 == 8
    out = np.full(count + 2, 7 + 7j, np.complex64)
    lib.tile_roundtrip(_ptr(src), _ptr(out[1:-1]), ctypes.c_longlong(k), ctypes.c_int(n),
                       ctypes.byref(misplaced))
    assert misplaced.value == 0
    np.testing.assert_array_equal(out[1:-1].view(np.uint64), src.view(np.uint64))
    assert out[0] == out[-1] == 7 + 7j


@pytest.mark.parametrize("n", SIZES)
def test_lu_source_matches_plain(emulated, n):
    m, b = systems(150, n, seed=50 + n)
    if n == 1:
        m[:, 0, 0] += 1.0
    k = len(m)
    x = np.empty_like(b)
    lu = np.empty((n, n, k), np.complex64)
    piv = np.empty((n, k), np.int32)
    x, lu, piv = _emulate_lu(emulated["lu"], m, b, seed=n)
    x_ref, lu_ref, piv_ref = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    np.testing.assert_array_equal(piv, piv_ref.numpy())
    np.testing.assert_array_equal(lu, lu_ref.numpy())
    np.testing.assert_array_equal(x, x_ref.numpy())


def _emulate_lu(lib, m, b, seed=0, fused=False):
    """(x, lu, piv) of csrc/lu.cu; above N = 8 the row solve's phases lane
    by lane in shuffled orders (``fused``: each lane's pivot and elimination
    phases back to back)."""
    k, n = m.shape[0], m.shape[1]
    x = np.empty_like(b)
    lu = np.empty((n, n, k), np.complex64)
    piv = np.empty((n, k), np.int32)
    lib.emu(_ptr(m), _ptr(b), _ptr(x), _ptr(lu), _ptr(piv), ctypes.c_longlong(k), ctypes.c_int(n),
            ctypes.c_uint(seed), ctypes.c_int(fused))
    return x, lu, piv


def test_lu_block_systems_are_those_the_card_tests_take(emulated):
    """tests/test_torch_kernels_cuda.py sets its K around csrc/lu.cu's
    systems a block; they must be the source's."""
    for n, systems_a_block in LU_BLOCK_SYSTEMS.items():
        assert emulated["lu"].tile_systems(ctypes.c_int(n)) == systems_a_block


def _lu_row_k(lib, n, rel):
    t, per_warp = lib.tile_systems(ctypes.c_int(n)), lib.rows_per_warp(ctypes.c_int(n))
    return {"1": 1, "T-1": t - 1, "T+1": t + 1, "T+W+1": t + per_warp + 1}[rel]


@pytest.mark.parametrize("rel", ["1", "T-1", "T+1", "T+W+1"])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_lu_row_solve_partial_last_block_matches_plain_bitwise(emulated, n, rel):
    """The row solve (N > 8) block by block, each phase between two
    __syncwarp()s lane by lane in an order shuffled anew for every phase,
    shared memory NaN at each block's start: a single system, a last block
    one short, one past a block, and a last block whose second warp holds
    one system (T + W + 1, W systems a warp). x, the factors and the pivots
    bit for bit."""
    k = _lu_row_k(emulated["lu"], n, rel)
    m, b = systems(k, n, seed=800 + k + n)
    x, lu, piv = _emulate_lu(emulated["lu"], m, b, seed=k)
    x_ref, lu_ref, piv_ref = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    np.testing.assert_array_equal(piv, piv_ref.numpy())
    np.testing.assert_array_equal(lu, lu_ref.numpy())
    np.testing.assert_array_equal(x, x_ref.numpy())


@pytest.mark.parametrize("n", [9, 27])
def test_lu_row_solve_needs_its_barriers(emulated, n):
    """Why each step has two phases: with each lane's pivot and elimination
    run back to back (the __syncwarp after the pivot row's publication
    missing), a lane that runs before its system's pivot lane eliminates with
    a pivot row not yet published, and the result changes."""
    m, b = systems(30, n, seed=n)
    ref = [t.numpy() for t in lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))]
    out = _emulate_lu(emulated["lu"], m, b, seed=3)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    fused = _emulate_lu(emulated["lu"], m, b, seed=3, fused=True)
    assert not all(np.array_equal(o, r) for o, r in zip(fused, ref))


@pytest.mark.parametrize("k_of_block", [lambda t: t - 1, lambda t: t, lambda t: t + 1,
                                        lambda t: 1000], ids=["T-1", "T", "T+1", "1000"])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_lu_row_copies_and_factor_stores_move_each_element_once(emulated, n, k_of_block):
    """The row solve's copies (N > 8): over every block, thread and copy
    step, each element of m and b is loaded once into its own slot, and each
    element of x, the factors (N, N, K) and the pivots (N, K) is stored once
    from its own slot. m and b loaded, and x and the factors stored, at
    bases 8 bytes past a 16-byte boundary: each element lands where the row
    solve reads it, x gives b's bits back, the factors m's bits bins-last,
    the pivots their slots' values, and nothing outside is touched."""
    lib = emulated["lu"]
    k = k_of_block(lib.tile_systems(ctypes.c_int(n)))
    hits = [np.zeros(size, np.uint8) for size in (k * n * n, k * n, k * n, k * n * n, k * n)]
    bad, misplaced = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.rows_cover(ctypes.c_longlong(k), ctypes.c_int(n), *(_ptr(h) for h in hits),
                   ctypes.byref(bad))
    assert bad.value == 0
    for h in hits:
        np.testing.assert_array_equal(h, 1)

    def offset_buffer(count, start=None):
        buf = (np.full(2 * count + 4, 7, np.uint32) if start is None
               else np.arange(start, start + 2 * count + 4, dtype=np.uint32))
        view = buf.view(np.complex64)[1:-1]  # 8 bytes past the buffer's 16-byte-aligned start
        assert view.ctypes.data % 16 == 8
        return buf, view

    _, m = offset_buffer(k * n * n, 0)
    _, b = offset_buffer(k * n, 1 << 30)
    x_buf, x = offset_buffer(k * n)
    lu_buf, lu = offset_buffer(k * n * n)
    piv = np.full(k * n + 2, -7, np.int32)
    lib.rows_roundtrip(_ptr(m), _ptr(b), _ptr(x), _ptr(lu), _ptr(piv[1:-1]), ctypes.c_longlong(k),
                       ctypes.c_int(n), ctypes.byref(misplaced))
    assert misplaced.value == 0
    np.testing.assert_array_equal(x.view(np.uint64), b.view(np.uint64))
    np.testing.assert_array_equal(lu.view(np.uint64).reshape(n, n, k),
                                  m.view(np.uint64).reshape(k, n, n).transpose(1, 2, 0))
    np.testing.assert_array_equal(piv[1:-1].reshape(n, k), np.arange(k * n).reshape(k, n).T)
    for buf in (x_buf, lu_buf):
        assert (buf[:2] == 7).all() and (buf[-2:] == 7).all()
    assert piv[0] == piv[-1] == -7


@pytest.mark.parametrize("k_of_tile", [lambda t: t - 1, lambda t: t, lambda t: t + 1,
                                       lambda t: 3 * 65537], ids=["T-1", "T", "T+1", "3x65537"])
@pytest.mark.parametrize("n", LU_TILE_SIZES)
def test_lu_tile_copies_cover_each_element_once(emulated, n, k_of_tile):
    """The tiled solve's copies: over every block, thread and copy step,
    each of the K x N^2 matrix and K x N right-hand-side elements is moved
    once, each into its own slot of its tile (m and b never share a slot),
    where its system's solve reads it; m and b loaded and the b slots stored
    from bases 8 bytes past a 16-byte boundary give b's bits back and touch
    nothing outside."""
    lib = emulated["lu"]
    k = k_of_tile(lib.tile_systems(ctypes.c_int(n)))
    hits_m, hits_b = np.zeros(k * n * n, np.uint8), np.zeros(k * n, np.uint8)
    bad, misplaced = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.tile_cover(ctypes.c_longlong(k), ctypes.c_int(n), _ptr(hits_m), _ptr(hits_b),
                   ctypes.byref(bad))
    assert bad.value == 0
    np.testing.assert_array_equal(hits_m, 1)
    np.testing.assert_array_equal(hits_b, 1)

    def offset_buffer(count, start):
        buf = np.arange(start, start + 2 * count + 4, dtype=np.uint32).view(np.complex64)
        view = buf[1:-1]  # 8 bytes past the buffer's 16-byte-aligned start
        assert view.ctypes.data % 16 == 8
        return view

    m, b = offset_buffer(k * n * n, 0), offset_buffer(k * n, 1 << 30)
    out = np.full(k * n + 2, 7 + 7j, np.complex64)
    lib.tile_roundtrip(_ptr(m), _ptr(b), _ptr(out[1:-1]), ctypes.c_longlong(k), ctypes.c_int(n),
                       ctypes.byref(misplaced))
    assert misplaced.value == 0
    np.testing.assert_array_equal(out[1:-1].view(np.uint64), b.view(np.uint64))
    assert out[0] == out[-1] == 7 + 7j


def _emulate_sos(lib, num, den, w):
    h = np.empty((num.shape[0], len(w)), np.complex64)
    lib.emu(_ptr(num), _ptr(den), _ptr(w), _ptr(h), ctypes.c_int(num.shape[0]),
            ctypes.c_int(num.shape[1]), ctypes.c_longlong(len(w)))
    return h


def _sos_source_error(lib, r, k, scale=1.0):
    num, den, z = cascade(r, k, 257, seed=r + k)
    num, den = num * np.float32(scale), den * np.float32(scale)
    w = (1.0 / z).astype(np.complex64)
    h = _emulate_sos(lib, num, den, w)
    ref = sos_cascade_plain(torch.from_numpy(num), torch.from_numpy(den), torch.from_numpy(w))
    assert np.isfinite(h).all()
    return num, den, w, max_rel(h, ref.numpy())


# The name is older than the design: the forward now fuses its products and
# takes one reciprocal per output, so it agrees with the plain version's
# per-section quotients to SOS_SOURCE_TOL, not bit for bit. K = 17 takes the
# instantiation with the section count known only at run time.
@pytest.mark.parametrize("r,k", [(3, 11), (2, 1), (2, 16), (2, 17)])
def test_sos_source_matches_plain_bitwise(emulated, r, k, record_property):
    err = _sos_source_error(emulated["sos"], r, k)[3]
    record_property("max_rel", err)
    assert err <= SOS_SOURCE_TOL


@pytest.mark.parametrize("scale", [1e4, 1e-4], ids=["up", "down"])
def test_sos_source_rescales_wide_cascades(emulated, scale, record_property):
    """Every section's numerator and denominator scaled by 1e4 (1e-4): the
    unscaled product of |Q_k|^2 overflows (underflows) float32 at every bin,
    and the kernel's power-of-two rescaling must keep the response finite
    and within SOS_SOURCE_TOL of the plain version."""
    num, den, w, err = _sos_source_error(emulated["sos"], 2, 16, scale)
    q_abs = np.abs(np.polynomial.polynomial.polyval(w.astype(np.complex128),
                                                    den.T.astype(np.float64)))
    log_prod = np.log10(q_abs ** 2).sum(axis=0)  # (R, F) log10 prod_k |Q_k|^2
    assert np.abs(log_prod).min() > 39.0  # outside float32's range at every bin
    record_property("max_rel", err)
    assert err <= SOS_SOURCE_TOL


def _svf_cascades(rows: int, seed: int):
    """SVF-head cascades at 32 kHz (the fullband preset's cutoffs, random
    resonances and gains) and the 65537 bins of nfft 131072."""
    from diffgfdn_torch.models.gain_heads import svf_cutoff_frequencies, svf_filter_types
    from diffgfdn_torch.ops.biquad import svf_to_biquad

    cut = torch.as_tensor(svf_cutoff_frequencies(32000.0), dtype=torch.float32)
    k = len(cut)
    rng = np.random.RandomState(seed)
    res = torch.from_numpy(rng.uniform(0.05, 1.0, (rows, k)).astype(np.float32))
    g_db = torch.from_numpy(rng.uniform(-6.0, 6.0, (rows, k)).astype(np.float32))
    num, den = svf_to_biquad(cut, res, torch.as_tensor(svf_filter_types(k)), g_db, 1.0)
    z = np.exp(1j * np.pi * np.arange(65537) / 65536).astype(np.complex64)
    return num.numpy(), den.numpy(), (1.0 / z).astype(np.complex64)


def test_sos_source_polynomials_round_as_the_plain_version(emulated, tmp_path, record_property):
    """Why the kernels evaluate P_k and Q_k separately rounded: with a fused
    polynomial, the low shelf's near-DC cancellation (a0 + a1 + a2 ~ 4 f^2)
    rounds differently and the response leaves the kernel tolerance
    (KERNEL_TOL of max |h|) against the plain version on the SVF heads' own
    cascades; as written it stays far inside."""
    num, den, w = _svf_cascades(4, seed=5)
    ref = sos_cascade_plain(*(torch.from_numpy(x) for x in (num, den, w))).numpy()
    err = max_rel(_emulate_sos(emulated["sos"], num, den, w), ref)
    fused = _build_host("sos", tmp_path, fused_polynomials=True)
    err_fused = max_rel(_emulate_sos(fused, num, den, w), ref)
    record_property("max_rel", err)
    record_property("max_rel_fused_polynomials", err_fused)
    assert err <= 1e-5 and err_fused > KERNEL_TOL


@pytest.mark.parametrize("n", SIZES)
def test_neg_ptgpt_source_matches_plain_bitwise(emulated, n):
    p, _ = systems(150, n, seed=200 + n)
    g, _ = systems(150, n, seed=300 + n)
    out = _emulate_ptgpt(emulated["cinv"], p, g, seed=n)
    ref = neg_ptgpt_plain(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", SIZES)
def test_lut_apply_source_matches_plain_bitwise(emulated, n):
    m, b = systems(150, n, seed=400 + n)
    if n == 1:
        m[:, 0, 0] += 1.0
    _, lu, piv = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    g = np.ascontiguousarray(b[::-1])
    lu_np, piv_np = np.ascontiguousarray(lu.numpy()), np.ascontiguousarray(piv.numpy())
    y, _ = _emulate_lut(emulated["lu"], lu_np, piv_np, g, seed=n)
    np.testing.assert_array_equal(y, lut_apply_plain(lu, piv, torch.from_numpy(g)).numpy())


def _emulate_lut(lib, lu, piv, g, seed=0, fault=0, eager=False):
    """(y, copies issued and never performed) of csrc/lu.cu's transposed
    solve; above N = 8 block by block, each phase thread by thread in a
    shuffled order, the copies deferred to the waits that need them
    (``eager``: performed as issued); ``fault`` 1 drops the barrier after
    the copies, 2 leaves one group more in flight at every wait."""
    k, n = g.shape
    y = np.empty_like(g)
    lib.emu_lut.restype = ctypes.c_longlong
    dropped = lib.emu_lut(_ptr(lu), _ptr(piv), _ptr(g), _ptr(y), ctypes.c_longlong(k),
                          ctypes.c_int(n), ctypes.c_uint(seed), ctypes.c_int(fault),
                          ctypes.c_int(eager))
    return y, dropped


def _lut_inputs(k, n, seed):
    """B5's plain factors and pivots of K random systems, and a random g."""
    m, b = systems(k, n, seed=seed)
    _, lu, piv = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    g = systems(k, n, seed=seed + 1)[1]
    return np.ascontiguousarray(lu.numpy()), np.ascontiguousarray(piv.numpy()), g


def _lut_plain(lu, piv, g):
    return lut_apply_plain(*map(torch.from_numpy, (lu, piv, g))).numpy()


def test_lut_block_systems_are_those_the_card_tests_take(emulated):
    """tests/test_torch_kernels_cuda.py sets B6's K around csrc/lu.cu's
    systems a block; they must be the source's."""
    for n, systems_a_block in LUT_BLOCK_SYSTEMS.items():
        assert emulated["lu"].lut_systems(ctypes.c_int(n)) == systems_a_block


def _lut_k(n, rel):
    t = LUT_BLOCK_SYSTEMS[n]
    return {"1": 1, "T-1": t - 1, "T+1": t + 1, "2T+5": 2 * t + 5}[rel]


@pytest.mark.parametrize("rel", ["1", "T-1", "T+1", "2T+5"])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_lut_apply_rows_partial_last_block_matches_plain_bitwise(emulated, n, rel):
    """B6 above N = 8 block by block: the order table, the copies in, the
    solves and the stores out each a phase, thread by thread in an order
    shuffled anew for every phase, shared memory NaN at each block's start;
    a single system, a last block one short, one past a block, and a third
    block of 5. y bit for bit, with every copy deferred to the wait that
    needs it and with every copy performed as it is issued, and no copy
    left unperformed."""
    k = _lut_k(n, rel)
    lu, piv, g = _lut_inputs(k, n, seed=900 + k + n)
    ref = _lut_plain(lu, piv, g)
    for eager in (False, True):
        y, dropped = _emulate_lut(emulated["lu"], lu, piv, g, seed=k, eager=eager)
        assert dropped == 0
        np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("fault", [1, 2], ids=["barrier_missing", "wait_one_group_short"])
@pytest.mark.parametrize("n", [9, 27])
def test_lut_apply_rows_needs_its_barrier_and_its_waits(emulated, n, fault):
    """Why the copies of g end in a barrier, and why each plane waits until
    at most kRing - 1 groups are in flight: with each thread's copies and
    solve back to back, a thread reads g entries that threads after it copy;
    with every wait one group short, a thread reads a ring slot before its
    plane has landed. Either way y changes."""
    lu, piv, g = _lut_inputs(2 * LUT_BLOCK_SYSTEMS[n] + 5, n, seed=n)
    ref = _lut_plain(lu, piv, g)
    y, _ = _emulate_lut(emulated["lu"], lu, piv, g, seed=3)
    np.testing.assert_array_equal(y, ref)
    y, _ = _emulate_lut(emulated["lu"], lu, piv, g, seed=3, fault=fault)
    assert not np.array_equal(y, ref)


@pytest.mark.parametrize("k_of_block", [lambda t: t - 1, lambda t: t, lambda t: t + 1,
                                        lambda t: 1000], ids=["T-1", "T", "T+1", "1000"])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_lut_apply_rows_copies_move_each_element_once(emulated, n, k_of_block):
    """B6's staging above N = 8: over the whole emulated run every element
    of the factors (N, N, K), the pivots (N, K) and g (K, N) is copied into
    shared memory once, and nothing else is; over every block, thread and
    copy step each element of y is stored once, from a slot of its own.
    The factors, g and y at bases 8 bytes past a 16-byte boundary: y bit
    for bit, nothing outside it touched."""
    lib = emulated["lu"]
    k = k_of_block(LUT_BLOCK_SYSTEMS[n])
    lu, piv, g = _lut_inputs(k, n, seed=1000 + k + n)
    ref = _lut_plain(lu, piv, g)

    def offset_copy(a):
        buf = np.full(a.size + 2, 7 + 7j, np.complex64)
        view = buf[1:-1]  # 8 bytes past the buffer's 16-byte-aligned start
        assert view.ctypes.data % 16 == 8
        view[:] = a.reshape(-1)
        return buf, view.reshape(a.shape)

    (_, lu_v), (_, g_v), (y_buf, y_v) = offset_copy(lu), offset_copy(g), offset_copy(g * 0)
    hits = [np.zeros(size, np.uint8) for size in (k * n * n, k * n, k * n, k * n)]
    bad = ctypes.c_longlong(0)
    lib.lut_cover.restype = ctypes.c_longlong
    dropped = lib.lut_cover(_ptr(lu_v), _ptr(piv), _ptr(g_v), _ptr(y_v), ctypes.c_longlong(k),
                            ctypes.c_int(n), *(_ptr(h) for h in hits), ctypes.byref(bad))
    assert bad.value == 0 and dropped == 0
    for h in hits:
        np.testing.assert_array_equal(h, 1)
    np.testing.assert_array_equal(y_v, ref)
    assert y_buf[0] == y_buf[-1] == 7 + 7j


def _sos_backward_source_check(lib, k):
    """The backward reads the forward's h (here the plain version's) and sums
    over the bins in another order than the plain version."""
    r, f, n_blocks = 3, 257, 2
    num, den, z = cascade(r, k, f, seed=9 + k)
    w = (1.0 / z).astype(np.complex64)
    rng = np.random.RandomState(9)
    g = (rng.randn(r, f) + 1j * rng.randn(r, f)).astype(np.complex64)
    h = sos_cascade_plain(torch.from_numpy(num), torch.from_numpy(den), torch.from_numpy(w))
    h = np.ascontiguousarray(h.numpy())
    partial = np.empty((n_blocks, r, 6 * k), np.float32)
    dnum, dden = np.empty_like(num), np.empty_like(den)
    lib.emu_bwd(_ptr(num), _ptr(den), _ptr(w), _ptr(g), _ptr(h), _ptr(partial), _ptr(dnum),
                _ptr(dden), ctypes.c_int(r), ctypes.c_int(k), ctypes.c_longlong(f),
                ctypes.c_int(n_blocks))
    ref_n, ref_d = sos_cascade_backward_plain(*(torch.from_numpy(x) for x in (num, den, w, g, h)))
    for out, ref in ((dnum, ref_n.numpy()), (dden, ref_d.numpy())):
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sos_backward_source_matches_plain(emulated):
    _sos_backward_source_check(emulated["sos"], 11)


@pytest.mark.parametrize("k", [k for k in BWD_SECTIONS if k != 11])
def test_sos_backward_source_matches_plain_at_other_section_counts(emulated, k):
    _sos_backward_source_check(emulated["sos"], k)


def _td_inputs(n, t_len, seed):
    rng = np.random.RandomState(seed)
    a = (np.linalg.qr(rng.randn(n, n))[0] * 0.999).astype(np.float32)
    g = rng.uniform(0.9, 0.999, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    u = rng.randn(t_len).astype(np.float32)
    return g, a, b, u


def _emulate_td(lib, delays, g, a, b, u, variant, block, threads, ring, seed=0, fused=False):
    """y (N, T) of csrc/tdgfdn.cu's variant on u zero-padded to a multiple
    of td.GROUP samples, as the wrapper pads it, each step's threads in a
    shuffled order (seed None: in descending order); ``fused``: the lines
    variant with two steps a thread back to back."""
    n, t_len = len(delays), len(u)
    t_pad = -(-t_len // td.GROUP) * td.GROUP
    u_pad = np.zeros(t_pad, np.float32)
    u_pad[:t_len] = u
    coef = np.concatenate([a.reshape(-1), g, b]).astype(np.float32)
    d = np.asarray(delays, np.int32)
    y = np.full((n, t_pad), np.nan, np.float32)  # line-major, as the kernel writes it
    # the kernel zeroes what it reads before t = 0; NaN elsewhere shows stray reads
    if variant in (td.HIST, td.LINES):
        buf = np.full((n, t_pad + max(delays)), np.nan, np.float32)
    else:
        buf = np.full(n * (ring + td.GROUP), np.nan, np.float32)
    order = (np.arange(threads)[::-1] if seed is None
             else np.random.RandomState(seed).permutation(threads)).astype(np.int32)
    lib.emu(ctypes.c_int(variant), _ptr(coef), _ptr(u_pad), _ptr(y), _ptr(buf),
            ctypes.c_longlong(t_pad), _ptr(d), ctypes.c_int(n), ctypes.c_int(block),
            ctypes.c_int(threads), ctypes.c_int(ring), _ptr(order), ctypes.c_int(fused))
    return y[:, :t_len]


@pytest.mark.parametrize(
    "delays,t_len,seed",
    [((37, 41, 43, 53), 1000, 1), ((5, 9, 11, 17, 23, 29, 31, 37, 41), 777, 2),
     (tuple(int(d) for d in np.linspace(100, 50000, 12)), 3000, 3)],
    ids=["n4", "n9_ragged", "n12_wide"],
)
def test_tdgfdn_source_matches_plain_bitwise(emulated, delays, t_len, seed):
    """The variant the wrapper picks on an H100 (the ring; the history in
    device memory for the 50000-sample spread, whose ring does not fit)."""
    g, a, b, u = _td_inputs(len(delays), t_len, seed)
    plan = kernel_plan(delays, H100_SMEM)
    assert plan.variant == (td.HIST if max(delays) > 10000 else td.RING)
    y = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, *plan)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())


def _three_room_delays():
    from diffgfdn_torch.config import preset_config

    return tuple(int(d) for d in preset_config("three_room_example").delay_length_samps)


@pytest.mark.parametrize("variant", ["hist", "ring", "ring_one_warp"])
@pytest.mark.parametrize("case", ["three_room", "long_block", "n4_short"])
def test_tdgfdn_source_variants_match_plain_bitwise(emulated, case, variant):
    """Every variant of csrc/tdgfdn.cu, step by step with shuffled threads:
    at the three-room path's delays (L = 512 for the ring variants, 683 for
    the device-memory history; the ring of R = 2048 slots wraps around 9
    times in 20000 samples), at delays from 1100 (L = 1024:
    512 groups of 2 samples a step, two for each of the 256 threads), and at
    N = 4 (L = 36), with the plan's threads and with one warp (many groups
    a thread)."""
    if case == "three_room":
        delays, t_len = _three_room_delays(), 20000
    elif case == "long_block":
        delays, t_len = tuple(int(d) for d in np.linspace(1100, 2300, 12)), 9000
    else:
        delays, t_len = (37, 41, 43, 53), 1000
    n = len(delays)
    kind = td.HIST if variant == "hist" else td.RING
    # no shared memory sends any delay set to the device-memory history
    plan = kernel_plan(delays, 0 if kind == td.HIST else H100_SMEM)
    assert plan.variant == kind
    if case == "three_room":
        assert (plan.block, plan.threads, plan.ring) == (
            (683, 256, 0) if kind == td.HIST else (512, 256, 2048))
    if case == "long_block":
        assert (plan.block, plan.threads) == ((1100, 256) if kind == td.HIST else (1024, 256))
    threads = td.WARP if variant == "ring_one_warp" else plan.threads
    g, a, b, u = _td_inputs(n, t_len, seed=n)
    y = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, plan.variant, plan.block, threads,
                    plan.ring, seed=1)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())


def test_tdgfdn_ring_needs_its_last_slot(emulated):
    """Why R >= m_max + L: at delays whose m_max + L is one past a power of
    two, the ring of that power of two (one slot short) lets a step's last
    group overwrite history its first group has yet to read when it runs
    first (the threads in descending order, as they may run on the card),
    and the result changes."""
    delays, t_len = (37, 41, 43, 93), 1000
    g, a, b, u = _td_inputs(4, t_len, seed=5)
    plan = kernel_plan(delays, H100_SMEM)
    assert max(delays) + plan.block == plan.ring // 2 + 1
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u))).numpy()
    args = (emulated["tdgfdn"], delays, g, a, b, u, td.RING, plan.block, plan.threads)
    np.testing.assert_array_equal(_emulate_td(*args, plan.ring, seed=None).T, ref)
    short = _emulate_td(*args, plan.ring // 2, seed=None)
    assert not np.array_equal(short.T, ref)


@pytest.mark.parametrize("delays,block,threads", [((683, 1000, 1447), 512, 256),
                                                  ((2000, 2001, 2500), 1792, 256),
                                                  ((4, 9), 4, 32)])
def test_tdgfdn_plan_picks_the_ring_by_size(delays, block, threads):
    """The ring variant exactly while its shared memory fits the card's;
    one byte less and the history goes to device memory. Its steps are a
    multiple of td.BALANCED_BLOCK samples where min(delay) allows, and its
    ring is a power of two."""
    n = len(delays)
    ring = 1 << (max(delays) + block - 1).bit_length()
    need = td.ring_bytes(n, ring)
    assert kernel_plan(delays, need) == (td.RING, block, threads, ring)
    assert kernel_plan(delays, need - 1).variant == td.HIST


def _directional_delays():
    from diffgfdn_torch.config import preset_config

    return tuple(int(d) for d in preset_config("directional_1000Hz_res0.6m").delay_length_samps)


def test_tdgfdn_plan_sends_the_directional_delays_to_device_memory(emulated):
    """The directional presets' 27 delays (691-1601 samples at 32 kHz) take
    the lines variant, whatever the shared memory: 27^2 + 54 coefficients do
    not fit a thread's registers, so they go to shared memory and the
    history to device memory, in steps of min(delay), one sample a thread.
    (A power-of-two ring would need 4096 slots at steps of 512, 442 KB,
    over an H100's 227 KB.) The plan's line count for the switch is the
    source's, which launches the lines variant alone above it."""
    assert emulated["tdgfdn"].register_lines() == td.REGISTER_LINES
    assert kernel_plan((5,) * td.REGISTER_LINES, H100_SMEM).variant == td.RING
    assert kernel_plan((5,) * (td.REGISTER_LINES + 1), H100_SMEM).variant == td.LINES
    delays = _directional_delays()
    assert (min(delays), max(delays), len(delays)) == (691, 1601, 27)
    assert kernel_plan(delays, H100_SMEM) == (td.LINES, 691, 704, 0)
    assert kernel_plan(delays, 1 << 30) == kernel_plan(delays, 0)
    assert td.ring_bytes(27, 2048) <= H100_SMEM < td.ring_bytes(27, 4096)


@pytest.mark.parametrize("u_kind", ["impulse", "random"])
def test_tdgfdn_lines_source_at_the_directional_delays_matches_plain_bitwise(emulated, u_kind):
    """The lines variant (N = 27) step by step at the directional delays,
    the threads of each step in a shuffled order, history and output NaN
    beyond what the kernel zeroes: bit for bit, impulse and random input."""
    delays = _directional_delays()
    plan = kernel_plan(delays, H100_SMEM)
    g, a, b, u = _td_inputs(27, 3000, seed=27)
    if u_kind == "impulse":
        u = np.zeros_like(u)
        u[0] = 1.0
    y = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, *plan, seed=4)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())


@pytest.mark.parametrize("delays,threads", [((37, 41, 43, 53) * 4, td.WARP),
                                            (tuple(range(1600, 1616)), td.LINES_THREADS)],
                         ids=["n16_one_warp", "n16_block_capped"])
def test_tdgfdn_lines_source_matches_plain_bitwise(emulated, delays, threads):
    """The lines variant at N = 16 (rows of A unpadded): with one warp, each
    thread taking many samples of a step, and at delays from 1600, whose
    steps are capped at one sample for each of LINES_THREADS threads."""
    plan = kernel_plan(delays, H100_SMEM)
    assert plan.variant == td.LINES and plan.block == min(min(delays), td.LINES_THREADS)
    g, a, b, u = _td_inputs(16, 2500, seed=16)
    y = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, td.LINES, plan.block, threads, 0,
                    seed=5)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())


def test_tdgfdn_lines_source_needs_its_barrier(emulated):
    """Why the lines variant ends each step with a barrier (it has no ring:
    its history is in device memory): with each thread run through two steps
    back to back, a sample of the second reads history that a thread yet to
    run writes in the first, and the result changes."""
    delays = _directional_delays()
    plan = kernel_plan(delays, H100_SMEM)
    g, a, b, u = _td_inputs(27, 3000, seed=28)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u))).numpy()
    np.testing.assert_array_equal(_emulate_td(emulated["tdgfdn"], delays, g, a, b, u, *plan,
                                              seed=6).T, ref)
    fused = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, *plan, seed=6, fused=True)
    assert not np.array_equal(fused.T, ref)


@pytest.mark.parametrize("past", [False, True], ids=["ring_full", "ring_full_plus_one"])
def test_tdgfdn_source_at_the_ring_boundary_matches_plain_bitwise(emulated, past):
    """At 12 delays from 683 whose ring is the largest that fits an H100's
    shared memory the ring runs; spread to a longest delay one sample more,
    the history goes to device memory. Both bit for bit."""
    delays = td.ring_boundary_delays(12, 683, H100_SMEM, past)
    other = td.ring_boundary_delays(12, 683, H100_SMEM, not past)
    assert delays[-1] == other[-1] + (1 if past else -1)
    plan = kernel_plan(delays, H100_SMEM)
    assert plan.variant == (td.HIST if past else td.RING)
    if not past:
        assert td.ring_bytes(12, plan.ring) <= H100_SMEM < td.ring_bytes(12, 2 * plan.ring)
    g, a, b, u = _td_inputs(12, 9000, seed=6)
    y = _emulate_td(emulated["tdgfdn"], delays, g, a, b, u, *plan, seed=2)
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())


def test_tdgfdn_plan_sends_delays_below_a_group_to_device_memory():
    """min(delay) < GROUP leaves no whole group in a step: HIST, one sample
    a thread, whatever the shared memory."""
    assert kernel_plan((1, 5), 1 << 30) == (td.HIST, 1, 32, 0)
