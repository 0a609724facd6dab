"""The port's autograd functions: analytic backward rules checked by gradcheck.

``cinv``, ``csolve1`` (with b broadcast over the systems) and the biquad
cascade run through the same ``torch.autograd.Function`` on the CPU as on
the card; here they run on the plain versions in complex128 / float64, and
``torch.autograd.gradcheck`` compares each analytic backward with finite
differences (its default tolerances). The front ends must also give outputs
with a ``grad_fn`` and leave fixed coefficients without a backward.
"""

import numpy as np
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import linalg, lu as lu_mod, sos as sos_mod


def _systems(k: int, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    m = 2.0 * torch.eye(n, dtype=torch.complex128) + 0.4 * torch.randn(
        (k, n, n), dtype=torch.complex128, generator=g
    )
    m[: k // 3, 0, 0] = 0.0  # elimination must pivot
    return m


def test_cinv_backward_passes_gradcheck():
    m = _systems(6, 4, 0).reshape(2, 3, 4, 4).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: linalg.cinv_with(x, cinv_mod.cinv_plain, cinv_mod.neg_ptgpt_plain), (m,)
    )


def test_csolve1_backward_passes_gradcheck_with_broadcast_b():
    m = _systems(6, 4, 1).reshape(2, 3, 4, 4).requires_grad_()
    b = torch.randn(4, dtype=torch.complex128, generator=torch.Generator().manual_seed(1))
    b.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: linalg.csolve1_with(x, y, lu_mod.lu_solve_plain, lu_mod.lut_apply_plain),
        (m, b),
    )


def test_cascade_backward_passes_gradcheck():
    g = torch.Generator().manual_seed(2)
    num = torch.randn((3, 2, 3), dtype=torch.float64, generator=g)
    den = torch.randn((3, 2, 3), dtype=torch.float64, generator=g)
    den[..., 0] += 4.0
    w = 1.0 / torch.exp(1j * torch.linspace(0.0, np.pi, 17, dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda a, d: sos_mod.cascade_with(
            a, d, w, sos_mod.sos_cascade_plain, sos_mod.sos_cascade_backward_plain
        ),
        (num.requires_grad_(), den.requires_grad_()),
    )


def test_front_ends_are_differentiable_and_skip_fixed_coefficients():
    m = _systems(8, 4, 3).to(torch.complex64).requires_grad_()
    assert linalg.cinv(m).grad_fn is not None
    assert linalg.csolve1(m, torch.ones(4, dtype=torch.complex64)).grad_fn is not None
    num = torch.ones((2, 3, 3))
    z = torch.exp(1j * torch.linspace(0.0, np.pi, 9)).to(torch.complex64)
    assert sos_mod.sos_cascade_response(num.requires_grad_(), num, z).grad_fn is not None
    fixed = sos_mod.sos_cascade_response(torch.ones((2, 3, 3)), torch.ones((2, 3, 3)), z)
    assert fixed.grad_fn is None and not fixed.requires_grad
