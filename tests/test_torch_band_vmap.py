"""The kernels' autograd functions under ``torch.func.vmap`` (the band axis of
the band-parallel trainer).

Each function folds the vmap axis into its system axis, so a vmapped call
runs its implementation once for every band. Here, on the plain versions in
complex128 / float64: ``torch.autograd.gradcheck`` of each vmapped function
(its default tolerances), its outputs and gradients equal to the unbatched
function's band by band (1e-12), one call of each implementation per
vmapped forward and backward, and inputs without a vmap axis (a right-hand
side or a denominator shared by every band) repeated over it. Also the
scalar heads' chunked sum over the delay lines, vmapped, against the plain
batched product (1e-12).
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import linalg, lu as lu_mod, sos as sos_mod

BANDS = 3


def _systems(shape, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    m = 2.0 * torch.eye(n, dtype=torch.complex128) + 0.4 * torch.randn(
        (*shape, n, n), dtype=torch.complex128, generator=g)
    m[..., 0, 0, 0] = 0.0  # elimination must pivot
    return m


def _counted(fn, calls, name):
    def wrapped(*args):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args)
    return wrapped


def _inverse(calls):
    return lambda x: linalg.cinv_with(x, _counted(cinv_mod.cinv_plain, calls, "fwd"),
                                      _counted(cinv_mod.neg_ptgpt_plain, calls, "bwd"))


def _solve(calls):
    return lambda x, y: linalg.csolve1_with(x, y, _counted(lu_mod.lu_solve_plain, calls, "fwd"),
                                            _counted(lu_mod.lut_apply_plain, calls, "bwd"))


def _cascade(calls, w):
    return lambda a, d: sos_mod.cascade_with(
        a, d, w, _counted(sos_mod.sos_cascade_plain, calls, "fwd"),
        _counted(sos_mod.sos_cascade_backward_plain, calls, "bwd"))


def _cascade_inputs(seed: int):
    g = torch.Generator().manual_seed(seed)
    num = torch.randn((BANDS, 4, 2, 3), dtype=torch.float64, generator=g)
    den = torch.randn((BANDS, 4, 2, 3), dtype=torch.float64, generator=g)
    den[..., 0] += 4.0
    w = 1.0 / torch.exp(1j * torch.linspace(0.0, np.pi, 17, dtype=torch.float64))
    return num, den, w


CASES = {
    "inverse": lambda: (_inverse, (_systems((BANDS, 2), 4, 0),), (0,)),
    "solve": lambda: (_solve, (_systems((BANDS, 2), 4, 1),
                               torch.randn((BANDS, 4), dtype=torch.complex128,
                                           generator=torch.Generator().manual_seed(1))),
                      (0, 0)),
    "solve_shared_b": lambda: (_solve, (_systems((BANDS, 2), 4, 2),
                                        torch.randn(4, dtype=torch.complex128,
                                                    generator=torch.Generator().manual_seed(2))),
                               (0, None)),
    "cascade": lambda: _cascade_case(3, (0, 0)),
    "cascade_shared_den": lambda: _cascade_case(4, (0, None)),
}


def _cascade_case(seed, in_dims):
    num, den, w = _cascade_inputs(seed)
    if in_dims[1] is None:
        den = den[0]
    return (lambda calls: _cascade(calls, w)), (num, den), in_dims


@pytest.mark.parametrize("case", sorted(CASES))
def test_vmapped_function_passes_gradcheck(case):
    make, inputs, in_dims = CASES[case]()
    fn = torch.func.vmap(make({}), in_dims=in_dims)
    assert torch.autograd.gradcheck(fn, tuple(x.requires_grad_() for x in inputs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vmapped_function_equals_the_unbatched_one_band_by_band(case):
    make, inputs, in_dims = CASES[case]()
    calls = {}
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    out = torch.func.vmap(make(calls), in_dims=in_dims)(*xs)
    g = torch.randn(out.shape, dtype=out.dtype, generator=torch.Generator().manual_seed(9))
    (out * g.conj()).real.sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}  # once for every band
    grads = [x.grad for x in xs]
    for b in range(BANDS):
        xb = [(x if d is None else x[b]).detach().clone().requires_grad_()
              for x, d in zip(inputs, in_dims)]
        ob = make({})(*xb)
        (ob * g[b].conj()).real.sum().backward()
        torch.testing.assert_close(out[b].detach(), ob.detach(), rtol=0, atol=1e-12)
        for x, d, gr in zip(xb, in_dims, grads):
            if d is not None:  # a shared input's gradient sums over the bands
                torch.testing.assert_close(gr[b], x.grad, rtol=0, atol=1e-12)


def test_vmapped_cascade_rejects_a_vmapped_w():
    num, den, w = _cascade_inputs(5)
    ws = w.expand(BANDS, *w.shape)
    with pytest.raises(ValueError, match="vmap axis"):
        torch.func.vmap(lambda a, d, x: sos_mod.cascade_with(
            a, d, x, sos_mod.sos_cascade_plain, sos_mod.sos_cascade_backward_plain))(num, den, ws)


def test_vmapped_solve_returns_each_bands_own_factors():
    m = _systems((BANDS, 2), 4, 6)
    b = torch.randn((BANDS, 2, 4), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(6))

    def solve(x, y):
        return linalg._Solve1.apply(x, y, lu_mod.lu_solve_plain, lu_mod.lut_apply_plain)

    outs = torch.func.vmap(solve)(m, b)
    for band in range(BANDS):
        for batched, plain in zip(outs, lu_mod.lu_solve_plain(m[band], b[band])):
            assert torch.equal(batched[band], plain)


@pytest.mark.parametrize("bins", [1, 1024, 1025, 2049])
def test_chunked_line_sum_equals_the_product_under_vmap(bins):
    from diffgfdn_torch.models.gfdn import _sum_over_lines

    g = torch.Generator().manual_seed(bins)
    c = torch.randn((BANDS, 5, 4), dtype=torch.complex128, generator=g)
    q = torch.randn((BANDS, bins, 4), dtype=torch.complex128, generator=g)
    grads = []
    for fn in (torch.func.vmap(_sum_over_lines), lambda x, y: x @ y.transpose(1, 2)):
        xs = [c.clone().requires_grad_(), q.clone().requires_grad_()]
        h = fn(*xs)
        assert h.shape == (BANDS, 5, bins)
        (h.abs() ** 2).sum().backward()
        grads.append([h.detach()] + [x.grad for x in xs])
    for a, b in zip(*grads):  # c's gradient sums over the bins in another order
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
