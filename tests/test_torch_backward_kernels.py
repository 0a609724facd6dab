"""The port's backward kernels: plain versions against the JAX Pallas backward.

On the CPU each backward wrapper runs its plain PyTorch version; these tests
hold them to the Pallas kernels in interpret mode on the same numpy inputs.
A JAX cotangent is the conjugate of torch's gradient G, so:

* B2: neg_ptgpt(P, G) = -P^H G P^H = conj(neg_ptgpt_pallas(P, conj(G)));
* B6: lut_apply(lu, piv, G) = M^-H G = conj(lut_apply_pallas(facs, conj(G))),
  fed the factors and pivots of the JAX forward of the same systems;
* B4: sos_cascade_backward(num, den, 1/z, G, h) = the cotangent conj(G)
  pulled back by ``jax.vjp`` of ``sos_cascade_response_pallas``, with h the
  port's forward response (the Pallas backward recomputes it).

N covers the served blocks (4) and the coupled loop (12), R the absorption
(12) and the SVF heads (96); N = 27 is in test_torch_backward_kernels_n27.py.
Bound: max abs error <= 1e-4 max |ref| (KERNEL_TOL).
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import lu as lu_mod, sos as sos_mod
from diffgfdn_tpu.kernels.pallas_cinv import cinv_pallas, neg_ptgpt_pallas
from diffgfdn_tpu.kernels.pallas_lu import lu_solve_pallas, lut_apply_pallas
from diffgfdn_tpu.kernels.pallas_sos import sos_cascade_response_pallas
from torch_port_helpers import cascade, KERNEL_TOL as TOL, max_rel, systems


def neg_ptgpt_vs_pallas(n: int, k: int) -> float:
    m, _ = systems(k, n, seed=n)
    g, _ = systems(k, n, seed=10 + n)
    p = np.array(cinv_pallas(m, interpret=True))
    out = cinv_mod.neg_ptgpt(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    ref = np.conj(np.asarray(neg_ptgpt_pallas(p, np.conj(g), interpret=True)))
    return max_rel(out, ref)


def lut_apply_vs_pallas(n: int, k: int) -> float:
    m, b = systems(k, n, seed=20 + n)
    rng = np.random.RandomState(n)
    g = (rng.randn(k, n) + 1j * rng.randn(k, n)).astype(np.complex64)
    _, facs = lu_solve_pallas(m, b, interpret=True)
    lu_re, lu_im, piv = (np.asarray(x) for x in facs)
    lu = np.ascontiguousarray((lu_re + 1j * lu_im)[..., :k].astype(np.complex64))
    piv = np.ascontiguousarray(piv[:, :k])
    out = lu_mod.lut_apply(torch.from_numpy(lu), torch.from_numpy(piv), torch.from_numpy(g))
    ref = np.conj(np.asarray(lut_apply_pallas(facs, np.conj(g), interpret=True)))
    return max_rel(out.numpy(), ref)


@pytest.mark.parametrize("n,k", [(4, 200), (12, 130)])
def test_neg_ptgpt_plain_matches_pallas(n, k, record_property):
    err = neg_ptgpt_vs_pallas(n, k)
    record_property("max_rel", err)
    assert err <= TOL


@pytest.mark.parametrize("n,k", [(4, 200), (12, 130)])
def test_lut_apply_plain_matches_pallas(n, k, record_property):
    err = lut_apply_vs_pallas(n, k)
    record_property("max_rel", err)
    assert err <= TOL


@pytest.mark.parametrize("r", [12, 96])
def test_sos_backward_plain_matches_pallas_vjp(r, record_property):
    num, den, z = cascade(r, 11, 600, seed=r)
    rng = np.random.RandomState(r)
    g = (rng.randn(r, 600) + 1j * rng.randn(r, 600)).astype(np.complex64)
    _, vjp = jax.vjp(
        lambda a, d: sos_cascade_response_pallas(a, d, z, interpret=True), num, den
    )
    ref_n, ref_d = (np.asarray(x) for x in vjp(np.conj(g)))
    w = torch.from_numpy((1.0 / z).astype(np.complex64))
    num_t, den_t = torch.from_numpy(num), torch.from_numpy(den)
    h = sos_mod.sos_cascade(num_t, den_t, w)
    dn, dd = sos_mod.sos_cascade_backward(num_t, den_t, w, torch.from_numpy(g), h)
    err = max(max_rel(dn.numpy(), ref_n), max_rel(dd.numpy(), ref_d))
    record_property("max_rel", err)
    assert err <= TOL


def test_backward_wrappers_reject_what_they_do_not_take():
    p = torch.zeros((5, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cinv_mod.neg_ptgpt(p, torch.zeros((5, 4, 3), dtype=torch.complex64))
    with pytest.raises(ValueError):
        lu_mod.lut_apply(torch.zeros((4, 4, 5), dtype=torch.complex64),
                         torch.zeros((4, 5), dtype=torch.int64),
                         torch.zeros((5, 4), dtype=torch.complex64))
    for g_shape, h_shape in (((2, 6), (2, 7)), ((2, 7), (2, 6))):
        with pytest.raises(ValueError):
            sos_mod.sos_cascade_backward(torch.zeros(2, 3, 3), torch.zeros(2, 3, 3),
                                         torch.ones(7, dtype=torch.complex64),
                                         torch.zeros(g_shape, dtype=torch.complex64),
                                         torch.zeros(h_shape, dtype=torch.complex64))
