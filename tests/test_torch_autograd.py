"""The port's autograd functions: analytic backward rules checked by gradcheck.

``cinv``, ``csolve1`` (with b broadcast over the systems) and the biquad
cascade run through the same ``torch.autograd.Function`` on the CPU as on
the card; here they run on the plain versions in complex128 / float64, and
``torch.autograd.gradcheck`` compares each analytic backward with finite
differences (its default tolerances). The front ends must also give outputs
with a ``grad_fn`` and leave fixed coefficients without a backward. The
cascade's backward reads the response its forward saved: its gradients must
equal those of the clamped recompute (the JAX VJP's) and of autograd through
the plain forward, and writing into the response in place must make the
backward raise rather than read a changed h.
"""

import pytest

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


def _cascade64(r: int, k: int, f: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    num = torch.randn((r, k, 3), dtype=torch.float64, generator=g)
    den = torch.randn((r, k, 3), dtype=torch.float64, generator=g)
    den[..., 0] += 4.0
    w = 1.0 / torch.exp(1j * torch.linspace(0.0, np.pi, f, dtype=torch.float64))
    return num, den, w


def test_cascade_backward_passes_gradcheck():
    num, den, w = _cascade64(3, 2, 17, seed=2)
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


def _recompute_backward(num, den, w, g, h):
    """The backward as the JAX VJP runs it: h recomputed, |Q|^2 clamped."""
    zre, zim = w.real[None], w.imag[None]
    z2re, z2im = zre * zre - zim * zim, 2.0 * zre * zim
    hre, him = torch.ones_like(g.real), torch.zeros_like(g.real)
    for i in range(num.shape[1]):
        pre, pim = sos_mod._poly(num[:, i], zre, zim, z2re, z2im)
        qre, qim = sos_mod._poly(den[:, i], zre, zim, z2re, z2im)
        iq = 1.0 / torch.clamp(qre * qre + qim * qim, min=1e-30)
        sre, sim = (pre * qre + pim * qim) * iq, (pim * qre - pre * qim) * iq
        hre, him = hre * sre - him * sim, hre * sim + him * sre
    return sos_mod.sos_cascade_backward_plain(num, den, w, g, torch.complex(hre, him))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cascade_saved_response_gives_the_recompute_gradients(dtype):
    num, den, w = _cascade64(4, 11, 257, seed=4)
    num, den = num.to(dtype), den.to(dtype)
    w = w.to(torch.complex64 if dtype == torch.float32 else torch.complex128)
    g = torch.randn((4, 257), dtype=w.dtype, generator=torch.Generator().manual_seed(5))
    grads = {}
    for label, backward in (("saved", sos_mod.sos_cascade_backward_plain),
                            ("recompute", _recompute_backward), ("autograd", None)):
        a, d = num.clone().requires_grad_(), den.clone().requires_grad_()
        if backward is None:
            h = sos_mod.sos_cascade_plain(a, d, w)
        else:
            h = sos_mod.cascade_with(a, d, w, sos_mod.sos_cascade_plain, backward)
        h.backward(g)
        grads[label] = (a.grad, d.grad)
    for ours, ref in zip(grads["saved"], grads["recompute"]):
        assert torch.equal(ours, ref)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for ours, ref in zip(grads["saved"], grads["autograd"]):
        assert float((ours - ref).abs().max() / ref.abs().max()) <= tol


def test_cascade_saves_its_response_and_guards_it():
    num, den, w = _cascade64(2, 3, 9, seed=6)
    a, d = num.clone().requires_grad_(), den.clone().requires_grad_()
    h = sos_mod.cascade_with(a, d, w, sos_mod.sos_cascade_plain,
                             sos_mod.sos_cascade_backward_plain)
    fixed = sos_mod.cascade_with(num, den, w, sos_mod.sos_cascade_plain,
                                 sos_mod.sos_cascade_backward_plain)
    assert fixed.grad_fn is None  # nothing kept when no coefficient needs a gradient
    saved = h.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[3].data_ptr() == h.data_ptr()
    h.mul_(2.0)  # a caller writing into the response
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        h.backward(torch.ones_like(h))

