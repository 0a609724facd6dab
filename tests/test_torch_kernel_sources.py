"""The CUDA sources' arithmetic, checked on the CPU.

Each ``diffgfdn_torch/csrc/*.cu`` is compiled with the host C++ compiler
against a small header that stands in for the CUDA built-ins (``float2``,
``blockIdx``/``threadIdx`` as host globals, ``__global__`` and friends as
nothing); launches (``<<<...>>>``) are stripped. A small host harness then runs every
kernel thread by thread, one thread per block, and the results are compared
with the plain PyTorch versions on the same inputs. With no fused
multiply-add on either side the Gauss-Jordan inverse and its backward
-P^H G P^H, the cascade response, the LU factors and pivots and the
transposed solve must agree bit for bit; the LU solution sums its back
substitution in another order (bound 1e-5 max |x|), and so do the cascade
backward's sums over the bins (bound 1e-5 max |gradient|). The cascade
backward runs with one thread per block here: its warp shuffles add nothing
(the shim's shuffle returns 0), so each block's partial is one thread's sum.
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
from torch_port_helpers import cascade, systems

CSRC = Path(__file__).resolve().parents[1] / "diffgfdn_torch" / "csrc"
SIZES = (1, 4, 9, 12, 27)

SHIM = """
#pragma once
#include <cstddef>
#include <math.h>
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __syncthreads()
inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
namespace { float coef[1 << 16]; }  // the cascade's dynamic shared memory
"""

_CASES = " ".join(f"case {n}: KERNEL<{n}>(ARGS); break;" for n in SIZES)
HARNESSES = {
    "cinv": """
extern "C" void emu(const void* m, void* out, long long k, int n) {
  auto mi = (const float2*)m; auto o = (float2*)out;
  for (long long s = 0; s < k; ++s) {
    blockIdx = dim3((unsigned)s);
    switch (n) { CASES }
  }
}""".replace("CASES", _CASES.replace("KERNEL", "cinv_kernel").replace("ARGS", "mi, o, k")) + """
extern "C" void emu_ptgpt(const void* p, const void* g, void* out, long long k, int n) {
  auto pi = (const float2*)p; auto gi = (const float2*)g; auto o = (float2*)out;
  for (long long s = 0; s < k; ++s) {
    blockIdx = dim3((unsigned)s);
    switch (n) { CASES }
  }
}""".replace("CASES", _CASES.replace("KERNEL", "neg_ptgpt_kernel").replace("ARGS", "pi, gi, o, k")),
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
extern "C" void emu(const void* num, const void* den, const void* w, void* h,
                    int rows, int k, long long f) {
  for (int r = 0; r < rows; ++r)
    for (long long i = 0; i < f; ++i) {
      blockIdx = dim3((unsigned)i, (unsigned)r);
      sos_cascade_kernel((const float*)num, (const float*)den, (const float2*)w,
                         (float2*)h, k, f);
    }
}
// K = 11 sections, one thread per block covering `per` bins; then the reduction
extern "C" void emu_bwd(const void* num, const void* den, const void* w, const void* g,
                        void* partial, void* dnum, void* dden, int rows, long long f,
                        int per, int n_blocks) {
  blockDim = dim3(1);
  for (int r = 0; r < rows; ++r)
    for (int b = 0; b < n_blocks; ++b) {
      blockIdx = dim3((unsigned)b, (unsigned)r);
      sos_bwd_partial_kernel<11>((const float*)num, (const float*)den, (const float2*)w,
                                 (const float2*)g, (float*)partial, rows, f, per);
    }
  for (long long i = 0; i < (long long)rows * 66; ++i) {
    blockIdx = dim3((unsigned)i);
    sos_bwd_reduce_kernel((const float*)partial, (float*)dnum, (float*)dden, n_blocks,
                          rows, 33);
  }
}""",
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{name: ctypes library} of the CUDA sources built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    build = tmp_path_factory.mktemp("kernel_sources")
    (build / "shim.h").write_text(SHIM)
    procs = {}
    for name, harness in HARNESSES.items():
        src = (CSRC / f"{name}.cu").read_text()
        src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
        src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
        unit = build / f"{name}_host.cpp"
        unit.write_text('#include "shim.h"\ndim3 blockIdx, threadIdx(0, 0, 0), blockDim(1, 1, 1);\n'
                        + src + harness)
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-shared", "-fPIC",
             "-o", str(build / f"{name}.so"), str(unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(build / f"{name}.so"))
    return libs


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


@pytest.mark.parametrize("r,k", [(3, 11), (2, 1)])
def test_sos_source_matches_plain_bitwise(emulated, r, k):
    num, den, z = cascade(r, k, 257, seed=r)
    w = (1.0 / z).astype(np.complex64)
    h = np.empty((r, len(w)), np.complex64)
    emulated["sos"].emu(_ptr(num), _ptr(den), _ptr(w), _ptr(h), ctypes.c_int(r),
                        ctypes.c_int(k), ctypes.c_longlong(len(w)))
    ref = sos_cascade_plain(torch.from_numpy(num), torch.from_numpy(den), torch.from_numpy(w))
    np.testing.assert_array_equal(h, ref.numpy())


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


def test_sos_backward_source_matches_plain(emulated):
    r, k, f, per = 3, 11, 257, 8
    num, den, z = cascade(r, k, f, seed=9)
    w = (1.0 / z).astype(np.complex64)
    rng = np.random.RandomState(9)
    g = (rng.randn(r, f) + 1j * rng.randn(r, f)).astype(np.complex64)
    n_blocks = -(-f // per)
    partial = np.empty((n_blocks, r, 6 * k), np.float32)
    dnum, dden = np.empty_like(num), np.empty_like(den)
    emulated["sos"].emu_bwd(_ptr(num), _ptr(den), _ptr(w), _ptr(g), _ptr(partial), _ptr(dnum),
                            _ptr(dden), ctypes.c_int(r), ctypes.c_longlong(f), ctypes.c_int(per),
                            ctypes.c_int(n_blocks))
    ref_n, ref_d = sos_cascade_backward_plain(*(torch.from_numpy(x) for x in (num, den, w, g)))
    for out, ref in ((dnum, ref_n.numpy()), (dden, ref_d.numpy())):
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


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
