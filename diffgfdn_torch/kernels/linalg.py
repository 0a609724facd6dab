"""Batched small complex inverse and single-RHS solve for the feedback loop.

Counterpart of ``diffgfdn_tpu/kernels/linalg.py``: the same public names
over any leading batch shape, forward only (the training slice adds the
backward). Both go through the kernel wrappers, which take the plain
PyTorch version for CPU tensors and the hand-written kernel for CUDA tensors:

* :func:`cinv` — pivoted Gauss-Jordan inverse (``kernels/cinv.py``);
* :func:`csolve1` — pivoted product-form LU solve (``kernels/lu.py``).
"""

import torch

from . import cinv as _cinv
from . import lu as _lu


def cinv(m: torch.Tensor) -> torch.Tensor:
    """Batched complex inverse, (..., N, N) -> (..., N, N) complex64."""
    n = m.shape[-1]
    flat = m.to(torch.complex64).reshape(-1, n, n).contiguous()
    return _cinv.cinv(flat).reshape(m.shape)


def csolve1(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-RHS solve x = M^-1 b: (..., N, N), b (N,) or (..., N) -> (..., N)."""
    n = m.shape[-1]
    flat_m = m.to(torch.complex64).reshape(-1, n, n).contiguous()
    bc = torch.broadcast_to(b.to(torch.complex64), m.shape[:-1])
    x, _, _ = _lu.lu_solve(flat_m, bc.reshape(-1, n).contiguous())
    return x.reshape(m.shape[:-1])
