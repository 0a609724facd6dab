"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: on a host without a card every test skips (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Bound: max abs error <= 1e-4 max |plain|; identical LU pivots.
"""

import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import lu as lu_mod, sos as sos_mod
from diffgfdn_torch.kernels.dispatch import plain_versions
from torch_port_helpers import cascade, KERNEL_TOL as TOL, max_rel, systems


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _on_card_and_plain(fn, *args):
    out = fn(*args)
    with plain_versions():
        ref = fn(*args)
    torch.cuda.synchronize()
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 12, 27])
def test_cinv_kernel_matches_plain_on_card(cuda_device, n):
    m, _ = systems(1000, n, seed=n)
    before = cinv_mod.cinv.launches
    out, ref = _on_card_and_plain(cinv_mod.cinv, torch.from_numpy(m).to(cuda_device))
    assert cinv_mod.cinv.launches == before + 1
    assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 12, 27])
def test_lu_kernel_matches_plain_on_card(cuda_device, n):
    m, b = systems(1000, n, seed=n)
    (x, lu, piv), (x_p, lu_p, piv_p) = _on_card_and_plain(
        lu_mod.lu_solve, torch.from_numpy(m).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    )
    assert max_rel(x.cpu().numpy(), x_p.cpu().numpy()) <= TOL
    assert max_rel(lu.cpu().numpy(), lu_p.cpu().numpy()) <= TOL
    assert torch.equal(piv, piv_p)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [12, 96])
def test_sos_kernel_matches_plain_on_card(cuda_device, r):
    num, den, z = cascade(r, 11, 4097, seed=r)
    out, ref = _on_card_and_plain(
        sos_mod.sos_cascade_response,
        *(torch.from_numpy(x).to(cuda_device) for x in (num, den, z)),
    )
    assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL
