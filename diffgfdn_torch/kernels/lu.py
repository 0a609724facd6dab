"""Batched single-RHS LU solve: the kernel and its plain version.

Replaces ``diffgfdn_tpu/kernels/pallas_lu.py::_lu_solve_kernel``. The kernel
is ``csrc/lu.cu``; :func:`lu_solve_plain` is the same arithmetic as PyTorch
tensor operations. Both return ``(x, lu, piv)`` in the layout documented in
``csrc/lu.cu``: x (K, N) complex64, the packed product-form factors
lu (N, N, K) complex64 and the pivots piv (N, K) int32.
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
}


def lu_solve_plain(
    m: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pivoted product-form LU solve.

    At step k the pivot is the first row r >= k maximising |A[r][k]|^2;
    rows k and p swap over the active columns and the RHS only.
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

    # back substitution: x[k] = (rhs[k] - sum_{j>k} U[k][j] x[j]) / U[k][k]
    xr = torch.zeros((kb, n), dtype=torch.float32, device=dev)
    xi = torch.zeros_like(xr)
    for k in range(n - 1, -1, -1):
        num_r, num_i = rr[:, k], ri[:, k]
        if k < n - 1:
            ur, ui = lr[:, k, k + 1:], li[:, k, k + 1:]
            num_r = num_r - torch.sum(ur * xr[:, k + 1:] - ui * xi[:, k + 1:], dim=1)
            num_i = num_i - torch.sum(ur * xi[:, k + 1:] + ui * xr[:, k + 1:], dim=1)
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
    ``csrc/lu.cu`` (any N <= 32, contiguous inputs), counted in
    ``lu_solve.launches``.
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
