"""Orthogonal and paraunitary matrix parametrizations (port of ``diffgfdn_tpu/ops/unitary.py``).

The skew/matrix-exponential orthogonal parametrization, the Givens-angle
rotation used by SCALAR coupling, and the FIR paraunitary polynomial
matrices of FILTER coupling (Householder factors, the polynomial algebra and
its checks), the polynomial axis leading: (order, N, N).
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


def householder_pu_factor(unit_vector: torch.Tensor) -> torch.Tensor:
    """Order-1 paraunitary Householder factor I - (1 - z^-1) v v^T, as its two
    polynomial taps stacked (2, N, N): I - v v^T and v v^T."""
    vv = torch.outer(unit_vector, unit_vector)
    eye = torch.eye(unit_vector.shape[0], dtype=vv.dtype, device=vv.device)
    return torch.stack([eye - vv, vv])


def fir_paraunitary(unitary_matrix: torch.Tensor, unit_vectors: torch.Tensor) -> torch.Tensor:
    """FIR paraunitary polynomial matrix (order, N, N), the polynomial axis
    leading: a cascade of ``order - 1`` Householder factors built from the
    unit-norm columns of ``unit_vectors`` (N, order - 1), each step
    C[t] = H0 P[t] + H1 P[t - 1], then times the zeroth-order
    ``unitary_matrix`` (N, N)."""
    n = unitary_matrix.shape[0]
    kw = dict(dtype=unitary_matrix.dtype, device=unitary_matrix.device)
    poly = torch.eye(n, **kw)[None]
    zero = torch.zeros((1, n, n), **kw)
    for k in range(unit_vectors.shape[1]):
        h = householder_pu_factor(unit_vectors[:, k])
        ext = torch.cat([poly, zero])
        shifted = torch.cat([zero, poly])
        poly = torch.einsum("ij,tjk->tik", h[0], ext) + torch.einsum("ij,tjk->tik", h[1], shifted)
    return torch.einsum("tij,jk->tik", poly, unitary_matrix)


def matrix_convolution(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two polynomial matrices, taps leading: (K, M, N) x (R, N, Q)
    -> (K + R - 1, M, Q), C[t] = sum_{u + v = t} A[u] B[v]."""
    k, r = a.shape[0], b.shape[0]
    dtype = torch.promote_types(a.dtype, b.dtype)
    out = torch.zeros((k + r - 1, a.shape[1], b.shape[2]), dtype=dtype, device=a.device)
    for u in range(k):
        out[u:u + r] += torch.einsum("ij,tjk->tik", a[u].to(dtype), b.to(dtype))
    return out


def hermitian_conjugate_polynomial_matrix(a: torch.Tensor) -> torch.Tensor:
    """A(z^-1)^H of a polynomial matrix A(z) (taps leading)."""
    return torch.conj(torch.flip(a, dims=(0,))).transpose(1, 2)


def is_unitary(a: torch.Tensor, max_tol: float = 1e-6) -> Tuple[bool, float]:
    """(A A^H == I within ``max_tol``, the largest deviation)."""
    t = a @ torch.conj(a).T - torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    err = float(torch.max(torch.abs(t)))
    return err < max_tol, err


def is_paraunitary(a: torch.Tensor, max_tol: float = 1e-6) -> Tuple[bool, float]:
    """(A(z) A(z^-1)^H == I within ``max_tol``, the largest deviation), taps leading."""
    t = matrix_convolution(a, hermitian_conjugate_polynomial_matrix(a))
    t[a.shape[0] - 1] -= torch.eye(a.shape[1], dtype=t.dtype, device=t.device)
    err = float(torch.max(torch.abs(t)))
    return err < max_tol, err


def paraunitary_frequency_response(poly: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sum_t P[t] z^-t at each point: ``poly`` (order, N, N), ``z`` (F,) ->
    (F, N, N) complex64, one (F, order) x (order, N^2) product."""
    order, n = poly.shape[0], poly.shape[1]
    zinv_pow = (1.0 / z[:, None]) ** torch.arange(order, device=z.device)[None, :]
    out = torch.matmul(zinv_pow.to(torch.complex64),
                       poly.to(torch.complex64).reshape(order, n * n))
    return out.reshape(z.shape[0], n, n)
