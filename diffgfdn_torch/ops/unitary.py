"""Orthogonal matrix parametrizations (port of ``diffgfdn_tpu/ops/unitary.py``).

Serving subset: the skew/matrix-exponential orthogonal parametrization and
the Givens-angle rotation used by SCALAR coupling.
"""

import torch


def skew(x: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric part built from the strict upper triangle of ``x``."""
    a = torch.triu(x, diagonal=1)
    return a - a.transpose(-1, -2)


def orthogonal_from_skew(x: torch.Tensor) -> torch.Tensor:
    """Orthogonal matrix exp(skew(x)); batched over leading axes."""
    return torch.linalg.matrix_exp(skew(x))


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
