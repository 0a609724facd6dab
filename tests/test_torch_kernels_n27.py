"""The port's Gauss-Jordan and LU plain versions at the directional size N = 27.

Same inputs and bounds as test_torch_kernels.py (max abs error <= 1e-4
max |ref| against the Pallas kernels in interpret mode, identical LU
pivots); kept apart because interpreting the unrolled N = 27 Pallas kernels
takes most of the time.
"""

import numpy as np
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import lu as lu_mod
from diffgfdn_tpu.kernels.pallas_cinv import cinv_pallas
from diffgfdn_tpu.kernels.pallas_lu import lu_solve_pallas
from torch_port_helpers import KERNEL_TOL as TOL, max_rel, systems

N, K = 27, 70


def test_cinv_plain_matches_pallas_n27():
    m, _ = systems(K, N, seed=N)
    out = cinv_mod.cinv(torch.from_numpy(m)).numpy()
    assert max_rel(out, np.asarray(cinv_pallas(m, interpret=True))) <= TOL


def test_lu_solve_plain_matches_pallas_n27():
    m, b = systems(K, N, seed=100 + N)
    x, lu, piv = lu_mod.lu_solve(torch.from_numpy(m), torch.from_numpy(b))
    x_ref, (lu_re, lu_im, piv_ref) = lu_solve_pallas(m, b, interpret=True)
    assert max_rel(x.numpy(), x_ref) <= TOL
    lu_ref = np.asarray(lu_re)[..., :K] + 1j * np.asarray(lu_im)[..., :K]
    assert max_rel(lu.numpy(), lu_ref) <= TOL
    np.testing.assert_array_equal(piv.numpy(), np.asarray(piv_ref)[:, :K])
