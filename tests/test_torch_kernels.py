"""The port's kernel modules: plain versions against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold the
plain versions to the Pallas kernels run as tests/test_pallas_*.py run them
(``interpret=True``), on the same numpy inputs. K is not a multiple of the
Pallas block (128 bins) and N covers the served path (4) and the coupled
loop (12); the directional size (27) is in test_torch_kernels_n27.py.
Bound: max abs error <= 1e-4 max |ref|, and identical LU pivots.

The CUDA kernels themselves are held to these plain versions on the card by
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import linalg, lu as lu_mod, sos as sos_mod
from diffgfdn_tpu.kernels import linalg as jax_linalg
from diffgfdn_tpu.kernels.pallas_cinv import cinv_pallas
from diffgfdn_tpu.kernels.pallas_lu import lu_solve_pallas
from diffgfdn_tpu.kernels.pallas_sos import sos_cascade_response_pallas
from torch_port_helpers import cascade, KERNEL_TOL as TOL, max_rel, systems


@pytest.mark.parametrize("n,k", [(4, 200), (12, 130)])
def test_cinv_plain_matches_pallas(n, k):
    m, _ = systems(k, n, seed=n)
    out = cinv_mod.cinv(torch.from_numpy(m)).numpy()
    ref = np.asarray(cinv_pallas(m, interpret=True))
    assert max_rel(out, ref) <= TOL


@pytest.mark.parametrize("n,k", [(4, 200), (12, 130)])
def test_lu_solve_plain_matches_pallas(n, k):
    m, b = systems(k, n, seed=100 + n)
    x, lu, piv = lu_mod.lu_solve(torch.from_numpy(m), torch.from_numpy(b))
    x_ref, (lu_re, lu_im, piv_ref) = lu_solve_pallas(m, b, interpret=True)
    assert max_rel(x.numpy(), x_ref) <= TOL
    lu_ref = np.asarray(lu_re)[..., :k] + 1j * np.asarray(lu_im)[..., :k]
    assert max_rel(lu.numpy(), lu_ref) <= TOL
    np.testing.assert_array_equal(piv.numpy(), np.asarray(piv_ref)[:, :k])


@pytest.mark.parametrize("r,f", [(5, 333), (12, 600)])
def test_sos_plain_matches_pallas(r, f):
    num, den, z = cascade(r, 11, f, seed=r)
    out = sos_mod.sos_cascade_response(
        torch.from_numpy(num), torch.from_numpy(den), torch.from_numpy(z)
    ).numpy()
    ref = np.asarray(sos_cascade_response_pallas(num, den, z, interpret=True))
    assert out.shape == (r, f)
    assert max_rel(out, ref) <= TOL


def test_linalg_front_ends_match_jax():
    """cinv and csolve1 over leading batch axes, against the JAX XLA versions."""
    m, b = systems(3 * 40, 4, seed=7)
    m = m.reshape(3, 40, 4, 4)
    p = linalg.cinv(torch.from_numpy(m)).numpy()
    assert max_rel(p, np.asarray(jax_linalg.cinv(m))) <= TOL
    b_lines = b[:4, 0]  # one (N,) right-hand side broadcast over all systems
    x = linalg.csolve1(torch.from_numpy(m), torch.from_numpy(b_lines)).numpy()
    assert x.shape == (3, 40, 4)
    assert max_rel(x, np.asarray(jax_linalg.csolve1(m, b_lines))) <= TOL


def test_cpu_wrappers_take_the_plain_version_without_counting():
    m, b = systems(20, 4, seed=3)
    num, den, z = cascade(3, 2, 17, seed=3)
    before = (cinv_mod.cinv.launches, lu_mod.lu_solve.launches,
              sos_mod.sos_cascade_response.launches)
    np.testing.assert_array_equal(
        cinv_mod.cinv(torch.from_numpy(m)).numpy(), cinv_mod.cinv_plain(torch.from_numpy(m)).numpy()
    )
    lu_mod.lu_solve(torch.from_numpy(m), torch.from_numpy(b))
    sos_mod.sos_cascade_response(torch.from_numpy(num), torch.from_numpy(den), torch.from_numpy(z))
    after = (cinv_mod.cinv.launches, lu_mod.lu_solve.launches,
             sos_mod.sos_cascade_response.launches)
    assert after == before


def test_wrappers_reject_what_they_do_not_take():
    m, b = systems(8, 4, seed=4)
    with pytest.raises(ValueError):
        cinv_mod.cinv(torch.from_numpy(m).to(torch.complex128))
    with pytest.raises(ValueError):
        lu_mod.lu_solve(torch.from_numpy(m), torch.from_numpy(b[:, :3]))
    with pytest.raises(ValueError):
        sos_mod.sos_cascade_response(torch.zeros(2, 3, 3), torch.zeros(2, 4, 3),
                                     torch.ones(5, dtype=torch.complex64))
    with pytest.raises(ValueError, match="no kernel for device"):
        cinv_mod.cinv(torch.from_numpy(m).to("meta"))
