"""Orthogonal matrix parametrizations (port of ``diffgfdn_tpu/ops/unitary.py``).

The skew/matrix-exponential orthogonal parametrization and the Givens-angle
rotation used by SCALAR coupling.
"""

import math
from typing import Dict, Tuple

import torch


def skew(x: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric part built from the strict upper triangle of ``x``."""
    a = torch.triu(x, diagonal=1)
    return a - a.transpose(-1, -2)


_TAYLOR_DEGREE = 12  # 1 / 13! < 2e-10: below float32 rounding for |A|_1 <= 1
_MAX_SQUARINGS = 8  # accurate for |A|_1 <= 2^8
# Taylor coefficients 1/j!, grouped for Paterson-Stockmeyer in powers of A^3:
# p(A) = sum_i C_i (A^3)^i with C_i = c_3i I + c_3i+1 A + c_3i+2 A^2
_PS_COEFFS = [[1.0 / math.factorial(3 * i + j) if 3 * i + j <= _TAYLOR_DEGREE else 0.0
               for j in range(3)] for i in range(_TAYLOR_DEGREE // 3 + 1)]


_coeff_tensors: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}


def _ps_coeffs(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_PS_COEFFS`` on ``device``, made once per dtype and device: a training
    step captured in a CUDA graph must copy nothing from the host."""
    key = (dtype, device)
    if key not in _coeff_tensors:
        _coeff_tensors[key] = torch.tensor(_PS_COEFFS, dtype=dtype, device=device)
    return _coeff_tensors[key]


def matrix_exp(a: torch.Tensor) -> torch.Tensor:
    """exp(A) by scaling and squaring, batched, without reading anything back
    to the host (``torch.linalg.matrix_exp`` copies its norms to the host on
    CUDA, a synchronization per call).

    A is scaled by 2^-s with s = ceil(log2 |A|_1) in [0, 8] (computed on the
    device), the degree-12 Taylor polynomial is evaluated by Paterson and
    Stockmeyer's scheme (six matrix products), and the result is squared s
    times: each of the 8 squarings is applied only where its index is below s.
    """
    # s is piecewise constant in A: no gradient flows through it (and none
    # must, since log2 of a zero norm would turn it into 0 * inf)
    norm = torch.amax(torch.sum(torch.abs(a.detach()), dim=-2), dim=-1)
    s = torch.clamp(torch.ceil(torch.log2(norm)), min=0.0, max=float(_MAX_SQUARINGS))
    x = a * torch.pow(2.0, -s)[..., None, None]
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    x2 = torch.matmul(x, x)
    x3 = torch.matmul(x2, x)
    coeffs = _ps_coeffs(a.dtype, a.device)
    c = torch.einsum("ij,j...->i...", coeffs, torch.stack([eye, x, x2]))  # C_i
    e = c[-1]
    for i in range(len(_PS_COEFFS) - 2, -1, -1):
        e = torch.matmul(e, x3) + c[i]
    square = s[..., None] > torch.arange(_MAX_SQUARINGS, device=a.device)
    for i in range(_MAX_SQUARINGS):
        e = torch.where(square[..., i, None, None], torch.matmul(e, e), e)
    return e


def orthogonal_from_skew(x: torch.Tensor) -> torch.Tensor:
    """Orthogonal matrix exp(skew(x)); batched over leading axes."""
    return matrix_exp(skew(x))


def planar_rotation(alpha: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """N x N planar rotation in the (i, n-1) plane by angle alpha."""
    r = torch.eye(n, dtype=alpha.dtype, device=alpha.device)
    c, s = torch.cos(alpha), torch.sin(alpha)
    r[i, i] = c
    r[i, n - 1] = -s
    r[n - 1, i] = s
    r[n - 1, n - 1] = c
    return r


def nd_unitary(alpha: torch.Tensor, n: int) -> torch.Tensor:
    """N x N rotation matrix from N(N-1)/2 Givens angles.

    U_n = R_{n-2} ... R_0 @ blockdiag(U_{n-1}, 1), built iteratively from
    U_1 = [1].
    """
    if alpha.shape[0] != n * (n - 1) // 2:
        raise ValueError(f"need {n * (n - 1) // 2} angles for n={n}, got {alpha.shape[0]}")
    kw = dict(dtype=alpha.dtype, device=alpha.device)
    u = torch.eye(1, **kw)
    for m in range(2, n + 1):
        start = (m - 1) * (m - 2) // 2
        cur = alpha[start : start + (m - 1)]
        rot = torch.eye(m, **kw)
        for i in range(m - 1):
            rot = planar_rotation(cur[i], m, i) @ rot
        big = torch.eye(m, **kw)
        big[: m - 1, : m - 1] = u
        u = rot @ big
    return u
