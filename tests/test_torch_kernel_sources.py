"""The CUDA sources' arithmetic, checked on the CPU.

Each ``diffgfdn_torch/csrc/*.cu`` is compiled with the host C++ compiler
against a small header that stands in for the CUDA built-ins (``float2``,
``blockIdx``/``threadIdx`` as host globals, ``__global__`` and friends as
nothing); launches (``<<<...>>>``) are stripped. A small host harness then runs every
kernel thread by thread, one thread per block, and the results are compared
with the plain PyTorch versions on the same inputs. With no fused
multiply-add on either side the Gauss-Jordan inverse, the cascade response,
the LU factors and the pivots must agree bit for bit; the LU solution sums
its back substitution in another order (bound 1e-5 max |x|).

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

from diffgfdn_torch.kernels.cinv import cinv_plain
from diffgfdn_torch.kernels.lu import lu_solve_plain
from diffgfdn_torch.kernels.sos import sos_cascade_plain
from torch_port_helpers import cascade, systems

CSRC = Path(__file__).resolve().parents[1] / "diffgfdn_torch" / "csrc"
SIZES = (1, 4, 9, 12, 27)

SHIM = """
#pragma once
#include <cstddef>
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
#define __shared__
#define __syncthreads()
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
}""".replace("CASES", _CASES.replace("KERNEL", "cinv_kernel").replace("ARGS", "mi, o, k")),
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
             .replace("ARGS", "mi, bi, xo, lo, po, k")),
    "sos": """
extern "C" void emu(const void* num, const void* den, const void* w, void* h,
                    int rows, int k, long long f) {
  for (int r = 0; r < rows; ++r)
    for (long long i = 0; i < f; ++i) {
      blockIdx = dim3((unsigned)i, (unsigned)r);
      sos_cascade_kernel((const float*)num, (const float*)den, (const float2*)w,
                         (float2*)h, k, f);
    }
}""",
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
        unit.write_text('#include "shim.h"\ndim3 blockIdx, threadIdx(0, 0, 0), blockDim;\n'
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
