"""Batched complex inverse and its backward: the kernels and their plain versions.

* :func:`cinv` replaces ``diffgfdn_tpu/kernels/pallas_cinv.py::_gj_kernel``;
  :func:`cinv_plain` is the same arithmetic as PyTorch tensor operations
  (re/im planes, the pivot rule and elimination order of ``_gj_kernel``);
* :func:`neg_ptgpt` replaces ``pallas_cinv.py::_ptgpt_kernel``, the inverse's
  backward -P^H G P^H in torch's complex gradient convention;
  :func:`neg_ptgpt_plain` is its plain version.

Both kernels are in ``csrc/cinv.cu``; each wrapper dispatches on the tensor's
device. The plain versions work in any complex dtype (complex128 for
``torch.autograd.gradcheck``); the wrappers take complex64.
"""

import ctypes

import torch

from . import _build
from .dispatch import runs_kernel

MAX_N = 32
_SIGNATURES = {
    "diffgfdn_cinv_c64": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p],
    "diffgfdn_neg_ptgpt_c64": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def cinv_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (K, N, N) complex64 -> per-system inverse.

    Gauss-Jordan on [M | I]; the pivot of step k is the first row r >= k
    maximising |M[r][k]|^2.
    """
    kb, n, _ = m.shape
    dev = m.device
    eye = torch.eye(n, dtype=m.real.dtype, device=dev).expand(kb, n, n)
    ar = torch.cat([m.real, eye], dim=-1)  # (K, N, 2N)
    ai = torch.cat([m.imag, torch.zeros_like(eye)], dim=-1)
    rows = torch.arange(n, device=dev)
    sys_idx = torch.arange(kb, device=dev)
    for k in range(n):
        cr, ci = ar[:, :, k], ai[:, :, k]
        mag = torch.where(rows < k, -1.0, cr * cr + ci * ci)
        p = torch.argmax(mag, dim=1)  # first maximum
        # swap rows k and p
        row_p_r, row_p_i = ar[sys_idx, p], ai[sys_idx, p]
        row_k_r, row_k_i = ar[:, k].clone(), ai[:, k].clone()
        ar[sys_idx, p] = row_k_r
        ai[sys_idx, p] = row_k_i
        ar[:, k] = row_p_r
        ai[:, k] = row_p_i
        # normalize the pivot row: row_k * conj(pivot) / |pivot|^2
        pr, pi = ar[:, k, k:k + 1], ai[:, k, k:k + 1]
        inv_den = 1.0 / (pr * pr + pi * pi)
        nr = (ar[:, k] * pr + ai[:, k] * pi) * inv_den
        ni = (ai[:, k] * pr - ar[:, k] * pi) * inv_den
        # eliminate column k from every row, then restore row k
        fr, fi = ar[:, :, k:k + 1].clone(), ai[:, :, k:k + 1].clone()
        ar = ar - (fr * nr[:, None] - fi * ni[:, None])
        ai = ai - (fr * ni[:, None] + fi * nr[:, None])
        ar[:, k] = nr
        ai[:, k] = ni
    return torch.complex(ar[:, :, n:], ai[:, :, n:])


def cinv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of each of K complex64 N x N systems, (K, N, N) -> (K, N, N).

    CPU tensors take :func:`cinv_plain`; CUDA tensors launch ``csrc/cinv.cu``
    (any N <= 32, contiguous input), counted in ``cinv.launches``.
    """
    if m.dim() != 3 or m.shape[1] != m.shape[2] or m.dtype != torch.complex64:
        raise ValueError(f"cinv takes (K, N, N) complex64, got {tuple(m.shape)} {m.dtype}")
    if not runs_kernel(m):
        return cinv_plain(m)
    kb, n, _ = m.shape
    if n > MAX_N or not m.is_contiguous():
        raise ValueError(f"cinv kernel takes contiguous input with N <= {MAX_N}")
    out = torch.empty_like(m)
    lib = _build.load("cinv", _SIGNATURES)
    with torch.cuda.device(m.device):
        err = lib.diffgfdn_cinv_c64(
            m.data_ptr(), out.data_ptr(), kb, n, torch.cuda.current_stream().cuda_stream
        )
    _build.check(err, "cinv")
    cinv.launches += 1
    return out


cinv.launches = 0


def neg_ptgpt_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: -(P^H G P^H) per system, (K, N, N) x2 -> (K, N, N).

    T = G P^H, each entry summed over m in order from zero; the output
    accumulated over l in order as out[i][j] -= conj(P[l][i]) T[l][j].
    """
    n = p.shape[-1]
    pr, pi = p.real, p.imag
    gr, gi = g.real, g.imag
    # t[l, j] = sum_m G[l, m] conj(P[j, m])
    tr = torch.zeros_like(pr)
    ti = torch.zeros_like(pr)
    for m in range(n):
        gr_m, gi_m = gr[:, :, m, None], gi[:, :, m, None]
        pr_m, pi_m = pr[:, None, :, m], pi[:, None, :, m]
        tr = tr + (gr_m * pr_m + gi_m * pi_m)
        ti = ti + (gi_m * pr_m - gr_m * pi_m)
    # out[i, j] = -sum_l conj(P[l, i]) t[l, j]
    our = torch.zeros_like(pr)
    oui = torch.zeros_like(pr)
    for l in range(n):
        pr_l, pi_l = pr[:, l, :, None], pi[:, l, :, None]
        tr_l, ti_l = tr[:, l, None, :], ti[:, l, None, :]
        our = our - (pr_l * tr_l + pi_l * ti_l)
        oui = oui - (pr_l * ti_l - pi_l * tr_l)
    return torch.complex(our, oui)


def neg_ptgpt(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward of the inverse, -(P^H G P^H) for K complex64 N x N systems.

    CPU tensors take :func:`neg_ptgpt_plain`; CUDA tensors launch
    ``csrc/cinv.cu`` (any N <= 32, contiguous inputs), counted in
    ``neg_ptgpt.launches``.
    """
    if (p.dim() != 3 or p.shape[1] != p.shape[2] or g.shape != p.shape
            or p.dtype != torch.complex64 or g.dtype != torch.complex64):
        raise ValueError(
            f"neg_ptgpt takes two (K, N, N) complex64, got {tuple(p.shape)} {p.dtype} "
            f"and {tuple(g.shape)} {g.dtype}"
        )
    if not runs_kernel(p, g):
        return neg_ptgpt_plain(p, g)
    kb, n, _ = p.shape
    if n > MAX_N or not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"neg_ptgpt kernel takes contiguous inputs with N <= {MAX_N}")
    out = torch.empty_like(p)
    lib = _build.load("cinv", _SIGNATURES)
    with torch.cuda.device(p.device):
        err = lib.diffgfdn_neg_ptgpt_c64(
            p.data_ptr(), g.data_ptr(), out.data_ptr(), kb, n,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "neg_ptgpt")
    neg_ptgpt.launches += 1
    return out


neg_ptgpt.launches = 0
