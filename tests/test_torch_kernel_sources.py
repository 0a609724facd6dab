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
(bound 1e-5 max |x|). The cascade kernels fuse their products with
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
The inverse and its backward (B1, B2) stage tiles of systems through
shared memory for N <= 8, with a barrier between the copies in, the solves
and the copies out: the harness runs each of those phases thread by thread
over the tile, through the kernels' own copy and per-system device
functions (the card's asynchronous copy is a plain copy on the host), and
drives the per-system functions system by system for larger N. A further
test holds the tile copies to moving each element once.
The time-domain recursion (B7) cannot run thread by thread through its
kernel: thread 0 would reach the next block of samples before thread 1 had
written this one. Its per-sample step is a device function, which the
harness drives block by block, then thread by thread; it must agree with
the plain version bit for bit.

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
from diffgfdn_torch.kernels.tdgfdn import _block_size, delay_line_outputs_plain, MAX_THREADS
from torch_port_helpers import cascade, KERNEL_TOL, max_rel, systems

CSRC = Path(__file__).resolve().parents[1] / "diffgfdn_torch" / "csrc"
SIZES = (1, 4, 9, 12, 27)
TILE_SIZES = (1, 4, 8)  # tile-copy tests: N of the tiled kernels (N <= 8)
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
extern "C" void emu(const void* m, const void* b, void* x, void* lu, void* piv,
                    long long k, int n) {
  auto mi = (const float2*)m; auto bi = (const float2*)b; auto xo = (float2*)x;
  auto lo = (float2*)lu; auto po = (int*)piv;
  for (long long s = 0; s < k; ++s) {
    blockIdx = dim3((unsigned)s);
    switch (n) { CASES }
  }
}""".replace("CASES", _CASES.replace("KERNEL", "lu_solve_kernel")
             .replace("ARGS", "mi, bi, xo, lo, po, k")) + """
extern "C" void emu_lut(const void* lu, const void* piv, const void* g, void* y,
                        long long k, int n) {
  auto li = (const float2*)lu; auto pi = (const int*)piv; auto gi = (const float2*)g;
  auto yo = (float2*)y;
  for (long long s = 0; s < k; ++s) {
    blockIdx = dim3((unsigned)s);
    switch (n) { CASES }
  }
}""".replace("CASES", _CASES.replace("KERNEL", "lut_apply_kernel")
             .replace("ARGS", "li, pi, gi, yo, k")),
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
extern "C" void emu(const void* u, const void* g, const void* a, const void* b,
                    const void* d, void* y, void* hist, long long t_len, int n, int m_max,
                    int block) {
  auto ui = (const float*)u; auto gi = (const float*)g; auto ai = (const float*)a;
  auto bi = (const float*)b; auto di = (const int*)d; auto yo = (float*)y;
  auto ho = (float*)hist;
  const long long h_len = t_len + m_max;
  for (long long k = 0; k < (long long)n * m_max; ++k) ho[(k / m_max) * h_len + k % m_max] = 0.0f;
  for (long long start = 0; start < t_len; start += block)
    for (int tid = 0; tid < block; ++tid) {
      const long long t = start + tid;
      if (t >= t_len) continue;
      switch (n) { CASES }
    }
}""".replace("CASES", _CASES.replace("KERNEL", "tdgfdn_step")
             .replace("ARGS", "t, ui, gi, ai, bi, di, yo, t_len, ho, h_len, m_max")),
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
    assert np.abs(x - x_ref.numpy()).max() <= 1e-5 * np.abs(x_ref.numpy()).max()


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


@pytest.mark.parametrize(
    "delays,t_len,seed",
    [((37, 41, 43, 53), 1000, 1), ((5, 9, 11, 17, 23, 29, 31, 37, 41), 777, 2),
     (tuple(int(d) for d in np.linspace(100, 50000, 12)), 3000, 3)],
    ids=["n4", "n9_ragged", "n12_wide"],
)
def test_tdgfdn_source_matches_plain_bitwise(emulated, delays, t_len, seed):
    n = len(delays)
    rng = np.random.RandomState(seed)
    a = (np.linalg.qr(rng.randn(n, n))[0] * 0.999).astype(np.float32)
    g = rng.uniform(0.9, 0.999, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    u = rng.randn(t_len).astype(np.float32)
    d = np.asarray(delays, np.int32)
    y = np.empty((n, t_len), np.float32)  # line-major, as the kernel writes it
    hist = np.full((n, t_len + max(delays)), np.nan, np.float32)  # the kernel zeroes its prefix
    emulated["tdgfdn"].emu(_ptr(u), _ptr(g), _ptr(a), _ptr(b), _ptr(d), _ptr(y), _ptr(hist),
                           ctypes.c_longlong(t_len), ctypes.c_int(n), ctypes.c_int(max(delays)),
                           ctypes.c_int(min(_block_size(delays), MAX_THREADS)))
    ref = delay_line_outputs_plain(delays, *(torch.from_numpy(x) for x in (g, a, b, u)))
    np.testing.assert_array_equal(y.T, ref.numpy())
