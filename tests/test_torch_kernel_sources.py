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
on the host), and drives the per-system functions system by system for
larger N. Further tests hold the tile copies to moving each element once.
The time-domain recursion (B7) cannot run thread by thread through its
kernel: thread 0 would reach the next block of samples before thread 1 had
written this one. Its step is a device function per thread, which the
harness drives step by step, the threads of a step in a shuffled order
(on the card they interleave in any order), for each variant: the ring in
shared memory (including its wrap-around at R slots, and blocks L that are
no power of two) and the history in device memory. It must agree with the
plain version bit for bit.

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
from torch_port_helpers import cascade, KERNEL_TOL, max_rel, systems

CSRC = Path(__file__).resolve().parents[1] / "diffgfdn_torch" / "csrc"
SIZES = (1, 4, 9, 12, 27)
TILE_SIZES = (1, 4, 8)  # tile-copy tests: N of the tiled kernels (N <= 8)
LU_TILE_SIZES = (1, 4, 8)  # the tiled LU solve's N (N <= 8)
TD_SIZES = (4, 9, 12)  # B7 host tests: N
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
"""

_CASES = " ".join(f"case {n}: KERNEL<{n}>(ARGS); break;" for n in SIZES)
HARNESSES = {
    "cinv": """
// the tiled kernels (N <= kMaxTiledN) block by block, each phase thread by
// thread as the barriers order them; the others system by system
template <int N>
void emu_cinv_n(const float2* m, float2* o, long long k) {
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
    for (long long s = 0; s < k; ++s) gj_inverse<N>(m + s * N * N, o + s * N * N);
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
    for (long long s = 0; s < k; ++s)
      neg_ptgpt_system<N>(p + s * N * N, g + s * N * N, o + s * N * N);
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
extern "C" void emu(const void* m, void* out, long long k, int n) {
  auto mi = (const float2*)m; auto o = (float2*)out;
  switch (n) { CASES }
}""".replace("CASES", _CASES.replace("KERNEL", "emu_cinv_n").replace("ARGS", "mi, o, k")) + """
extern "C" void emu_ptgpt(const void* p, const void* g, void* out, long long k, int n) {
  auto pi = (const float2*)p; auto gi = (const float2*)g; auto o = (float2*)out;
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
        f"case {n}: return Tile<{n}>::kSystems;" for n in TILE_SIZES)).replace(
    "COVER_CASES", " ".join(
        f"case {n}: tile_cover_n<{n}>(k, (unsigned char*)hits, bad); break;"
        for n in TILE_SIZES)).replace(
    "ROUNDTRIP_CASES", " ".join(
        f"case {n}: tile_roundtrip_n<{n}>((const float2*)src, (float2*)dst, k, misplaced); "
        "break;" for n in TILE_SIZES)),
    "lu": """
// the tiled solve (N <= kMaxTiledN) block by block, each phase thread by
// thread as the barriers order them; larger N system by system
template <int N>
void emu_lu_n(const float2* m, const float2* b, float2* x, float2* lu, int* piv, long long k) {
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
    for (long long s = 0; s < k; ++s)
      lu_solve_system<N>(m + s * N * N, b + s * N, x + s * N, lu, piv, s, k);
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
                    long long k, int n) {
  auto mi = (const float2*)m; auto bi = (const float2*)b; auto xo = (float2*)x;
  auto lo = (float2*)lu; auto po = (int*)piv;
  switch (n) { CASES }
}""".replace("CASES", _CASES.replace("KERNEL", "emu_lu_n")
             .replace("ARGS", "mi, bi, xo, lo, po, k")) + """
extern "C" void emu_lut(const void* lu, const void* piv, const void* g, void* y,
                        long long k, int n) {
  auto li = (const float2*)lu; auto pi = (const int*)piv; auto gi = (const float2*)g;
  auto yo = (float2*)y;
  threadIdx = dim3(0);
  for (long long s = 0; s < k; ++s) {
    blockIdx = dim3((unsigned)s);
    switch (n) { CASES }
  }
}""".replace("CASES", _CASES.replace("KERNEL", "lut_apply_kernel")
             .replace("ARGS", "li, pi, gi, yo, k")) + """
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
}""".replace("TILE_CASES", " ".join(
        f"case {n}: return Tile<{n}>::kSystems;" for n in LU_TILE_SIZES)).replace(
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
// variant 0 hist (buf: the (N, T + m_max) history), 1 ring (buf: N rows of
// ring + kGroup)
extern "C" void emu(int variant, const void* coef, const void* u, void* y, void* buf,
                    long long t_len, const int* d, int n, int block, int threads, int ring,
                    const int* order) {
  const TdArgs p = make_args((const float*)coef, (const float*)u, (float*)y,
                             variant == 0 ? (float*)buf : nullptr, t_len, d, n, block, ring);
  float* b = (float*)buf;
  if (variant == 0) {
    switch (n) { HIST_CASES }
  } else {
    switch (n) { RING_CASES }
  }
}""".replace("HIST_CASES", " ".join(
        f"case {n}: emu_hist_n<{n}>(p, threads, order); break;" for n in TD_SIZES)).replace(
    "RING_CASES", " ".join(
        f"case {n}: emu_ring_n<{n}>(p, b, threads, order); break;" for n in TD_SIZES)),
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


@pytest.mark.parametrize("n", SIZES)
def test_cinv_source_matches_plain_bitwise(emulated, n):
    m, _ = systems(150, n, seed=n)
    if n == 1:
        m[:, 0, 0] += 1.0  # a 1 x 1 system has no row to pivot to
    out = np.empty_like(m)
    emulated["cinv"].emu(_ptr(m), _ptr(out), ctypes.c_longlong(len(m)), ctypes.c_int(n))
    np.testing.assert_array_equal(out, cinv_plain(torch.from_numpy(m)).numpy())


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


@pytest.mark.parametrize("n", SIZES)
def test_lu_source_matches_plain(emulated, n):
    m, b = systems(150, n, seed=50 + n)
    if n == 1:
        m[:, 0, 0] += 1.0
    k = len(m)
    x = np.empty_like(b)
    lu = np.empty((n, n, k), np.complex64)
    piv = np.empty((n, k), np.int32)
    emulated["lu"].emu(_ptr(m), _ptr(b), _ptr(x), _ptr(lu), _ptr(piv),
                       ctypes.c_longlong(k), ctypes.c_int(n))
    x_ref, lu_ref, piv_ref = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    np.testing.assert_array_equal(piv, piv_ref.numpy())
    np.testing.assert_array_equal(lu, lu_ref.numpy())
    np.testing.assert_array_equal(x, x_ref.numpy())


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
    out = np.empty_like(p)
    emulated["cinv"].emu_ptgpt(_ptr(p), _ptr(g), _ptr(out), ctypes.c_longlong(len(p)),
                               ctypes.c_int(n))
    ref = neg_ptgpt_plain(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", SIZES)
def test_lut_apply_source_matches_plain_bitwise(emulated, n):
    m, b = systems(150, n, seed=400 + n)
    if n == 1:
        m[:, 0, 0] += 1.0
    _, lu, piv = lu_solve_plain(torch.from_numpy(m), torch.from_numpy(b))
    g = np.ascontiguousarray(b[::-1])
    y = np.empty_like(g)
    lu_np, piv_np = np.ascontiguousarray(lu.numpy()), np.ascontiguousarray(piv.numpy())
    emulated["lu"].emu_lut(_ptr(lu_np), _ptr(piv_np), _ptr(g), _ptr(y),
                           ctypes.c_longlong(len(g)), ctypes.c_int(n))
    np.testing.assert_array_equal(y, lut_apply_plain(lu, piv, torch.from_numpy(g)).numpy())


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


def _emulate_td(lib, delays, g, a, b, u, variant, block, threads, ring, seed=0):
    """y (N, T) of csrc/tdgfdn.cu's variant on u zero-padded to a multiple
    of td.GROUP samples, as the wrapper pads it, each step's threads in a
    shuffled order (seed None: in descending order)."""
    n, t_len = len(delays), len(u)
    t_pad = -(-t_len // td.GROUP) * td.GROUP
    u_pad = np.zeros(t_pad, np.float32)
    u_pad[:t_len] = u
    coef = np.concatenate([a.reshape(-1), g, b]).astype(np.float32)
    d = np.asarray(delays, np.int32)
    y = np.full((n, t_pad), np.nan, np.float32)  # line-major, as the kernel writes it
    # the kernel zeroes what it reads before t = 0; NaN elsewhere shows stray reads
    if variant == td.HIST:
        buf = np.full((n, t_pad + max(delays)), np.nan, np.float32)
    else:
        buf = np.full(n * (ring + td.GROUP), np.nan, np.float32)
    order = (np.arange(threads)[::-1] if seed is None
             else np.random.RandomState(seed).permutation(threads)).astype(np.int32)
    lib.emu(ctypes.c_int(variant), _ptr(coef), _ptr(u_pad), _ptr(y), _ptr(buf),
            ctypes.c_longlong(t_pad), _ptr(d), ctypes.c_int(n), ctypes.c_int(block),
            ctypes.c_int(threads), ctypes.c_int(ring), _ptr(order))
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
