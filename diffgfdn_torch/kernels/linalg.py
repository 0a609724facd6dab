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
backward alike. Under ``torch.func.vmap`` each autograd function folds the
vmap axis into its system axis (the band axis of the band-parallel
trainer), so one launch serves every band, forward and backward.
:func:`cinv_with` and :func:`csolve1_with` take the implementations as
arguments, so the tests run the same autograd functions on the plain
versions in complex128.
"""

from typing import Callable

import torch

from . import cinv as _cinv
from . import lu as _lu
from .dispatch import fold_vmap_axis as _fold


def _unfold(x: torch.Tensor, batch_size: int) -> torch.Tensor:
    return x.reshape(batch_size, -1, *x.shape[1:])


class _Inverse(torch.autograd.Function):
    """P = M^-1 over (K, N, N), backward -P^H G P^H.

    Under ``torch.func.vmap`` the vmap axis is folded into K, so that one
    launch of each kernel serves every vmapped system (the band axis of the
    band-parallel trainer)."""

    @staticmethod
    def forward(m, inverse: Callable, vjp: Callable):
        return inverse(m)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.vjp = inputs[2]

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return ctx.vjp(p, g.contiguous()), None, None

    @staticmethod
    def vmap(info, in_dims, m, inverse, vjp):
        p = _Inverse.apply(_fold(m, in_dims[0], info.batch_size), inverse, vjp)
        return _unfold(p, info.batch_size), 0


class _Solve1(torch.autograd.Function):
    """x = M^-1 b over (K, N, N) x (K, N); vmapped as :class:`_Inverse`."""

    @staticmethod
    def forward(m, b, solve: Callable, transposed_solve: Callable):
        x, lu, piv = solve(m, b)
        return x, lu, piv

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lu, piv = output
        ctx.save_for_backward(lu, piv, x)
        ctx.transposed_solve = inputs[3]
        ctx.mark_non_differentiable(lu, piv)

    @staticmethod
    def backward(ctx, g, _g_lu, _g_piv):
        lu, piv, x = ctx.saved_tensors
        y = ctx.transposed_solve(lu, piv, g.contiguous())
        dm = -(y[:, :, None] * x.conj()[:, None, :]) if ctx.needs_input_grad[0] else None
        db = y if ctx.needs_input_grad[1] else None
        return dm, db, None, None

    @staticmethod
    def vmap(info, in_dims, m, b, solve, transposed_solve):
        n = info.batch_size
        x, lu, piv = _Solve1.apply(
            _fold(m, in_dims[0], n), _fold(b, in_dims[1], n), solve, transposed_solve
        )
        # the factors are bins-last, (N, N, n K) and (N, n K): their vmap axis
        # unfolds in front of the system axis
        return ((_unfold(x, n), lu.reshape(*lu.shape[:-1], n, -1),
                 piv.reshape(*piv.shape[:-1], n, -1)), (0, 2, 1))


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
    x, _, _ = _Solve1.apply(
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
