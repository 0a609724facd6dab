"""Batched small complex inverse and single-RHS solve for the feedback loop.

Counterpart of ``diffgfdn_tpu/kernels/linalg.py``: the same public names
over any leading batch shape, differentiable with the analytic rules of the
JAX custom VJPs restated for torch's complex gradient convention (the
gradient G of a real loss is d/dRe + i d/dIm, the conjugate of JAX's
cotangent):

* :func:`cinv` — pivoted Gauss-Jordan inverse P = M^-1 (``kernels/cinv.py``),
  grad_M = -P^H G P^H (``neg_ptgpt``);
* :func:`csolve1` — pivoted product-form LU solve x = M^-1 b
  (``kernels/lu.py``), y = M^-H G from the saved factors (``lut_apply``),
  grad_M = -y x^H, grad_b = y summed over the broadcast of b.

Both go through the kernel wrappers, which take the plain PyTorch version for
CPU tensors and the hand-written kernel for CUDA tensors, forward and
backward alike. :func:`cinv_with` and :func:`csolve1_with` take the
implementations as arguments, so the tests run the same autograd functions
on the plain versions in complex128.
"""

from typing import Callable

import torch

from . import cinv as _cinv
from . import lu as _lu


class _Inverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, inverse: Callable, vjp: Callable):
        p = inverse(m)
        ctx.save_for_backward(p)
        ctx.vjp = vjp
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return ctx.vjp(p, g.contiguous()), None, None


class _Solve1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, b, solve: Callable, transposed_solve: Callable):
        x, lu, piv = solve(m, b)
        ctx.save_for_backward(lu, piv, x)
        ctx.transposed_solve = transposed_solve
        return x

    @staticmethod
    def backward(ctx, g):
        lu, piv, x = ctx.saved_tensors
        y = ctx.transposed_solve(lu, piv, g.contiguous())
        dm = -(y[:, :, None] * x.conj()[:, None, :]) if ctx.needs_input_grad[0] else None
        db = y if ctx.needs_input_grad[1] else None
        return dm, db, None, None


def cinv_with(m: torch.Tensor, inverse: Callable, vjp: Callable) -> torch.Tensor:
    """Differentiable batched inverse (..., N, N) through the given
    forward (K, N, N) -> (K, N, N) and backward (P, G) -> -P^H G P^H."""
    n = m.shape[-1]
    return _Inverse.apply(m.reshape(-1, n, n).contiguous(), inverse, vjp).reshape(m.shape)


def csolve1_with(
    m: torch.Tensor, b: torch.Tensor, solve: Callable, transposed_solve: Callable
) -> torch.Tensor:
    """Differentiable single-RHS solve through the given forward
    (M, b) -> (x, lu, piv) and backward (lu, piv, G) -> M^-H G."""
    n = m.shape[-1]
    bc = torch.broadcast_to(b, m.shape[:-1])
    x = _Solve1.apply(
        m.reshape(-1, n, n).contiguous(), bc.reshape(-1, n).contiguous(), solve,
        transposed_solve,
    )
    return x.reshape(m.shape[:-1])


def cinv(m: torch.Tensor) -> torch.Tensor:
    """Batched complex inverse, (..., N, N) -> (..., N, N) complex64."""
    return cinv_with(m.to(torch.complex64), _cinv.cinv, _cinv.neg_ptgpt)


def csolve1(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-RHS solve x = M^-1 b: (..., N, N), b (N,) or (..., N) -> (..., N)."""
    return csolve1_with(
        m.to(torch.complex64), b.to(torch.complex64), _lu.lu_solve, _lu.lut_apply
    )
