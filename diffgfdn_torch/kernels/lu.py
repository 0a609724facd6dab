"""Batched single-RHS LU solve and its backward: the kernels and their plain versions.

* :func:`lu_solve` replaces ``diffgfdn_tpu/kernels/pallas_lu.py::_lu_solve_kernel``;
  it and :func:`lu_solve_plain` return ``(x, lu, piv)`` in the layout
  documented in ``csrc/lu.cu``: x (K, N), the packed product-form factors
  lu (N, N, K) and the pivots piv (N, K) int32;
* :func:`lut_apply` replaces ``pallas_lu.py::_lut_apply_kernel``: it solves
  M^H y = g from those factors (the solve's backward in torch's complex
  gradient convention); :func:`lut_apply_plain` is its plain version.

Both kernels are in ``csrc/lu.cu``. The plain versions work in any complex
dtype (complex128 for ``torch.autograd.gradcheck``); the wrappers take
complex64.
"""

import ctypes
from typing import Tuple

import torch

from . import _build
from .dispatch import runs_kernel

MAX_N = 32
_SIGNATURES = {
    "diffgfdn_lu_solve_c64": [ctypes.c_void_p] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "diffgfdn_lut_apply_c64": [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def lu_solve_plain(
    m: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pivoted product-form LU solve.

    At step k the pivot is the first row r >= k maximising |A[r][k]|^2;
    rows k and p swap over the active columns and the RHS only. Every sum
    runs in the kernel's order, so with no fused multiply-add in the kernel
    the two agree bit for bit.
    """
    kb, n, _ = m.shape
    dev = m.device
    lr, li = m.real.clone(), m.imag.clone()  # (K, N, N)
    rr, ri = b.real.clone(), b.imag.clone()  # (K, N)
    piv = torch.empty((n, kb), dtype=torch.int32, device=dev)
    sys_idx = torch.arange(kb, device=dev)
    for k in range(n):
        cr, ci = lr[:, k:, k], li[:, k:, k]
        p = torch.argmax(cr * cr + ci * ci, dim=1) + k  # first maximum
        piv[k] = p.to(torch.int32)
        # swap rows k and p over the active columns k.. and the RHS
        prow_r, prow_i = lr[sys_idx, p, k:].clone(), li[sys_idx, p, k:].clone()
        lr[sys_idx, p, k:] = lr[:, k, k:].clone()
        li[sys_idx, p, k:] = li[:, k, k:].clone()
        lr[:, k, k:] = prow_r
        li[:, k, k:] = prow_i
        prhs_r, prhs_i = rr[sys_idx, p].clone(), ri[sys_idx, p].clone()
        rr[sys_idx, p] = rr[:, k].clone()
        ri[sys_idx, p] = ri[:, k].clone()
        rr[:, k] = prhs_r
        ri[:, k] = prhs_i
        if k == n - 1:
            break
        # multipliers f = a[i][k] * conj(pivot) / |pivot|^2, stored below
        pr, pi = prow_r[:, :1], prow_i[:, :1]
        inv_den = 1.0 / (pr * pr + pi * pi)
        ipr = pr * inv_den
        ipi = -pi * inv_den
        c1r, c1i = lr[:, k + 1:, k], li[:, k + 1:, k]
        fr = c1r * ipr - c1i * ipi  # (K, n-k-1)
        fi = c1r * ipi + c1i * ipr
        lr[:, k + 1:, k] = fr
        li[:, k + 1:, k] = fi
        # trailing update and RHS update
        ur, ui = prow_r[:, None, 1:], prow_i[:, None, 1:]
        fr3, fi3 = fr[:, :, None], fi[:, :, None]
        lr[:, k + 1:, k + 1:] = lr[:, k + 1:, k + 1:] - (fr3 * ur - fi3 * ui)
        li[:, k + 1:, k + 1:] = li[:, k + 1:, k + 1:] - (fr3 * ui + fi3 * ur)
        pbr, pbi = prhs_r[:, None], prhs_i[:, None]
        rr[:, k + 1:] = rr[:, k + 1:] - (fr * pbr - fi * pbi)
        ri[:, k + 1:] = ri[:, k + 1:] - (fr * pbi + fi * pbr)

    # back substitution: x[k] = (rhs[k] - sum_{j>k} U[k][j] x[j]) / U[k][k],
    # the sum over ascending j from zero, as the kernel adds it
    xr = torch.zeros((kb, n), dtype=m.real.dtype, device=dev)
    xi = torch.zeros_like(xr)
    for k in range(n - 1, -1, -1):
        num_r, num_i = rr[:, k], ri[:, k]
        if k < n - 1:
            sr, si = torch.zeros_like(num_r), torch.zeros_like(num_i)
            for j in range(k + 1, n):
                ur, ui = lr[:, k, j], li[:, k, j]
                sr = sr + (ur * xr[:, j] - ui * xi[:, j])
                si = si + (ur * xi[:, j] + ui * xr[:, j])
            num_r = num_r - sr
            num_i = num_i - si
        dr, di = lr[:, k, k], li[:, k, k]
        inv_den = 1.0 / (dr * dr + di * di)
        xr[:, k] = (num_r * dr + num_i * di) * inv_den
        xi[:, k] = (num_i * dr - num_r * di) * inv_den
    lu = torch.complex(lr, li).permute(1, 2, 0).contiguous()
    return torch.complex(xr, xi), lu, piv


def lu_solve(
    m: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x = M^-1 b for K complex64 systems: (K, N, N), (K, N) -> (x, lu, piv).

    CPU tensors take :func:`lu_solve_plain`; CUDA tensors launch
    ``csrc/lu.cu`` (any N <= 32, contiguous inputs; tiles of systems staged
    through shared memory for N <= 8), counted in ``lu_solve.launches``.
    """
    if (m.dim() != 3 or m.shape[1] != m.shape[2] or tuple(b.shape) != tuple(m.shape[:2])
            or m.dtype != torch.complex64 or b.dtype != torch.complex64):
        raise ValueError(
            f"lu_solve takes (K, N, N) and (K, N) complex64, got "
            f"{tuple(m.shape)} {m.dtype} and {tuple(b.shape)} {b.dtype}"
        )
    if not runs_kernel(m, b):
        return lu_solve_plain(m, b)
    kb, n, _ = m.shape
    if n > MAX_N or not (m.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"lu_solve kernel takes contiguous inputs with N <= {MAX_N}")
    x = torch.empty_like(b)
    lu = torch.empty((n, n, kb), dtype=torch.complex64, device=m.device)
    piv = torch.empty((n, kb), dtype=torch.int32, device=m.device)
    lib = _build.load("lu", _SIGNATURES)
    with torch.cuda.device(m.device):
        err = lib.diffgfdn_lu_solve_c64(
            m.data_ptr(), b.data_ptr(), x.data_ptr(), lu.data_ptr(), piv.data_ptr(),
            kb, n, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lu_solve")
    lu_solve.launches += 1
    return x, lu, piv


lu_solve.launches = 0


def lut_apply_plain(lu: torch.Tensor, piv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: y = M^-H g from (lu, piv) of :func:`lu_solve_plain`.

    lu (N, N, K), piv (N, K), g (K, N) -> y (K, N). Every factor is
    conjugated on use: forward substitution with U^H, then the multipliers
    and the swaps undone from the last step to the first.
    """
    n = g.shape[1]
    fr, fi = lu.real, -lu.imag  # conjugated factors, each [i, j] a (K,) row
    wr = [g.real[:, i] for i in range(n)]
    wi = [g.imag[:, i] for i in range(n)]
    # pass 1: U^H w = g
    for k in range(n):
        dr, di = fr[k, k], fi[k, k]
        inv_den = 1.0 / (dr * dr + di * di)
        wkr = (wr[k] * dr + wi[k] * di) * inv_den
        wki = (wi[k] * dr - wr[k] * di) * inv_den
        wr[k], wi[k] = wkr, wki
        for i in range(k + 1, n):
            ur, ui = fr[k, i], fi[k, i]
            wr[i] = wr[i] - (ur * wkr - ui * wki)
            wi[i] = wi[i] - (ur * wki + ui * wkr)
    # pass 2: w[k] -= sum_{i>k} conj(f_k[i]) w[i], then swap w[k] and w[p_k]
    for k in range(n - 1, -1, -1):
        if k < n - 1:
            sr = torch.zeros_like(wr[k])
            si = torch.zeros_like(wi[k])
            for i in range(k + 1, n):
                sr = sr + (fr[i, k] * wr[i] - fi[i, k] * wi[i])
                si = si + (fr[i, k] * wi[i] + fi[i, k] * wr[i])
            wr[k] = wr[k] - sr
            wi[k] = wi[k] - si
        p = piv[k]
        for r in range(k + 1, n):
            sel = p == r
            wr[k], wr[r] = torch.where(sel, wr[r], wr[k]), torch.where(sel, wr[k], wr[r])
            wi[k], wi[r] = torch.where(sel, wi[r], wi[k]), torch.where(sel, wi[k], wi[r])
    return torch.complex(torch.stack(wr, dim=1), torch.stack(wi, dim=1))


def lut_apply(lu: torch.Tensor, piv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """y = M^-H g for K complex64 systems from the factors :func:`lu_solve` returned.

    lu (N, N, K) complex64, piv (N, K) int32, g (K, N) complex64 -> y (K, N).
    CPU tensors take :func:`lut_apply_plain`; CUDA tensors launch
    ``csrc/lu.cu`` (any N <= 32, contiguous inputs), counted in
    ``lut_apply.launches``.
    """
    n = g.shape[-1] if g.dim() == 2 else -1
    kb = g.shape[0]
    if (g.dim() != 2 or tuple(lu.shape) != (n, n, kb) or tuple(piv.shape) != (n, kb)
            or lu.dtype != torch.complex64 or g.dtype != torch.complex64
            or piv.dtype != torch.int32):
        raise ValueError(
            f"lut_apply takes lu (N, N, K) complex64, piv (N, K) int32 and g (K, N) "
            f"complex64, got {tuple(lu.shape)} {lu.dtype}, {tuple(piv.shape)} {piv.dtype}, "
            f"{tuple(g.shape)} {g.dtype}"
        )
    if not runs_kernel(lu, piv, g):
        return lut_apply_plain(lu, piv, g)
    if n > MAX_N or not (lu.is_contiguous() and piv.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"lut_apply kernel takes contiguous inputs with N <= {MAX_N}")
    y = torch.empty_like(g)
    lib = _build.load("lu", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = lib.diffgfdn_lut_apply_c64(
            lu.data_ptr(), piv.data_ptr(), g.data_ptr(), y.data_ptr(), kb, n,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lut_apply")
    lut_apply.launches += 1
    return y


lut_apply.launches = 0
