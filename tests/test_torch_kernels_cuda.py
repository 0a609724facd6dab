"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: on a host without a card every test skips (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Bound: max abs error <= 1e-4 max |plain|; identical LU pivots. The inverse
(B1 ``cinv``), its backward (B2 ``neg_ptgpt``) and the LU solve (B5
``lu_solve``: x, factors and pivots) must equal their plain versions bit
for bit, at every N of the model family, on ragged K around the systems of
a block, on a contiguous view 8 bytes past a 16-byte boundary, and on two
launches alike. The cascade
forward (B3) also runs with every section scaled by 1e4 and 1e-4, where the
unscaled product of |Q_k|^2 leaves float32, and its backward (B4), given
the forward's response, must give the same bits on two launches. The
backward kernels (B2 ``neg_ptgpt``, B6 ``lut_apply``, B4
``sos_cascade_backward``) are also driven through autograd with a
non-contiguous gradient, which the autograd functions make contiguous.
B7 ``delay_line_outputs`` must equal its plain version bit for bit at the
served path's delays and length (T = 131072), impulse and random input
(the shared-memory ring the wrapper picks there), at a delay spread whose
ring fills the card's shared memory exactly and at one a sample longer
(which takes the device-memory history), at a spread of 50000 samples, and
on two launches alike.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import lu as lu_mod, sos as sos_mod, tdgfdn as td_mod
from diffgfdn_torch.kernels.dispatch import plain_versions
from diffgfdn_torch.kernels import linalg
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


# csrc/cinv.cu runs 128 systems a block at each N below (one tile at N <= 4,
# one system a thread at N > 8); K = 3 x 65537 is the fullband path's
CINV_SIZES = (1, 4, 9, 12, 27)
CINV_BLOCK = 128
CINV_K = (1, CINV_BLOCK - 1, CINV_BLOCK, CINV_BLOCK + 1, 1000, 3 * 65537)


def _cinv_systems(k, n, seed):
    m, _ = systems(k, n, seed=seed)
    if n == 1:
        m[:, 0, 0] += 1.0  # a 1 x 1 system has no row to pivot to
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("k", CINV_K)
@pytest.mark.parametrize("n", CINV_SIZES)
def test_cinv_kernel_matches_plain_on_card(cuda_device, n, k):
    m = torch.from_numpy(_cinv_systems(k, n, seed=n)).to(cuda_device)
    before = cinv_mod.cinv.launches
    out, ref = _on_card_and_plain(cinv_mod.cinv, m)
    assert cinv_mod.cinv.launches == before + 1
    assert torch.equal(out, ref)


def _offset_view(x):
    """A contiguous copy of x whose storage starts 8 bytes past a 16-byte
    boundary (the view a slice m[1:] of odd-N systems gives)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 9])
def test_cinv_kernels_take_a_view_8_bytes_off_alignment(cuda_device, n):
    k = 3 * 65537
    m = torch.from_numpy(_cinv_systems(k, n, seed=70 + n)).to(cuda_device)
    g = torch.from_numpy(systems(k, n, seed=80 + n)[0]).to(cuda_device)
    out, ref = _on_card_and_plain(cinv_mod.cinv, _offset_view(m))
    assert torch.equal(out, ref)
    assert torch.equal(out, cinv_mod.cinv(m))
    p, g_view = _offset_view(ref), _offset_view(g)
    out, ref = _on_card_and_plain(cinv_mod.neg_ptgpt, p, g_view)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cinv_kernels_are_deterministic_on_card(cuda_device):
    k, n = 3 * 65537, 4
    m = torch.from_numpy(_cinv_systems(k, n, seed=3)).to(cuda_device)
    g = torch.from_numpy(systems(k, n, seed=4)[0]).to(cuda_device)
    first, second = cinv_mod.cinv(m), cinv_mod.cinv(m)
    assert torch.equal(first, second)
    assert torch.equal(cinv_mod.neg_ptgpt(first, g), cinv_mod.neg_ptgpt(second, g))


# csrc/lu.cu tiles 128 systems a block at N <= 4 (32 at N = 8) and runs one
# system a thread at N > 8
LU_SIZES = (1, 4, 8, 9, 12, 27)


@pytest.mark.cuda
@pytest.mark.parametrize("k", CINV_K)
@pytest.mark.parametrize("n", LU_SIZES)
def test_lu_kernel_matches_plain_on_card(cuda_device, n, k):
    m, b = systems(k, n, seed=n)
    if n == 1:
        m[:, 0, 0] += 1.0
    before = lu_mod.lu_solve.launches
    (x, lu, piv), (x_p, lu_p, piv_p) = _on_card_and_plain(
        lu_mod.lu_solve, torch.from_numpy(m).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    )
    assert lu_mod.lu_solve.launches == before + 1
    assert torch.equal(x, x_p)
    assert torch.equal(lu, lu_p)
    assert torch.equal(piv, piv_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 9])
def test_lu_kernel_takes_a_view_8_bytes_off_alignment_and_repeats(cuda_device, n):
    k = 3 * 65537
    m, b = (torch.from_numpy(x).to(cuda_device) for x in systems(k, n, seed=90 + n))
    out = lu_mod.lu_solve(_offset_view(m), _offset_view(b))
    again = lu_mod.lu_solve(m, b)
    torch.cuda.synchronize()
    with plain_versions():
        ref = lu_mod.lu_solve(m, b)
    for a, c, r in zip(out, again, ref):
        assert torch.equal(a, r) and torch.equal(c, r)


@pytest.mark.cuda
@pytest.mark.parametrize("r,scale", [(12, 1.0), (96, 1.0), (12, 1e4), (12, 1e-4)],
                         ids=["12", "96", "12_wide_up", "12_wide_down"])
def test_sos_kernel_matches_plain_on_card(cuda_device, r, scale):
    num, den, z = cascade(r, 16 if scale != 1.0 else 11, 4097, seed=r)
    num, den = num * np.float32(scale), den * np.float32(scale)
    out, ref = _on_card_and_plain(
        sos_mod.sos_cascade_response,
        *(torch.from_numpy(x).to(cuda_device) for x in (num, den, z)),
    )
    assert torch.isfinite(out).all()
    assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", CINV_K)
@pytest.mark.parametrize("n", CINV_SIZES)
def test_neg_ptgpt_kernel_matches_plain_on_card(cuda_device, n, k):
    m = _cinv_systems(k, n, seed=n)
    g, _ = systems(k, n, seed=50 + n)
    p = cinv_mod.cinv(torch.from_numpy(m).to(cuda_device))
    before = cinv_mod.neg_ptgpt.launches
    out, ref = _on_card_and_plain(cinv_mod.neg_ptgpt, p, torch.from_numpy(g).to(cuda_device))
    assert cinv_mod.neg_ptgpt.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 12, 27])
def test_lut_apply_kernel_matches_plain_on_card(cuda_device, n):
    m, b = systems(1000, n, seed=n)
    _, lu, piv = lu_mod.lu_solve(torch.from_numpy(m).to(cuda_device),
                                 torch.from_numpy(b).to(cuda_device))
    g = torch.from_numpy(b[::-1].copy()).to(cuda_device)
    before = lu_mod.lut_apply.launches
    out, ref = _on_card_and_plain(lu_mod.lut_apply, lu, piv, g)
    assert lu_mod.lut_apply.launches == before + 1
    assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("r", [12, 96])
def test_sos_backward_kernel_matches_plain_on_card(cuda_device, r):
    args = _backward_inputs(r, cuda_device)
    before = sos_mod.sos_cascade_backward.launches
    (dn, dd), (dn_p, dd_p) = _on_card_and_plain(sos_mod.sos_cascade_backward, *args)
    assert sos_mod.sos_cascade_backward.launches == before + 1
    assert max_rel(dn.cpu().numpy(), dn_p.cpu().numpy()) <= TOL
    assert max_rel(dd.cpu().numpy(), dd_p.cpu().numpy()) <= TOL


def _backward_inputs(r, device):
    """num, den, w, G and the kernel forward's h at K = 11, F = 65537."""
    num, den, z = cascade(r, 11, 65537, seed=r)
    g = torch.randn((r, 65537), dtype=torch.complex64, generator=torch.Generator().manual_seed(r))
    num, den = (torch.from_numpy(x).to(device) for x in (num, den))
    w = (1.0 / torch.from_numpy(z).to(device)).to(torch.complex64)
    return num, den, w, g.to(device), sos_mod.sos_cascade(num, den, w)


@pytest.mark.cuda
def test_sos_backward_kernel_is_deterministic_on_card(cuda_device):
    args = _backward_inputs(96, cuda_device)
    first = sos_mod.sos_cascade_backward(*args)
    second = sos_mod.sos_cascade_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _grads(fn, inputs, g):
    """Gradients of Re<g, fn(inputs)> with respect to inputs, on the kernels
    and on the plain versions; g is handed over non-contiguous."""
    out = []
    for plain in (False, True):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        if plain:
            with plain_versions():
                y = fn(*leaves)
                y.backward(g)
        else:
            y = fn(*leaves)
            y.backward(g)
        out.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_autograd_backward_launches_the_kernels_with_non_contiguous_gradients(cuda_device):
    m, b = systems(3 * 500, 4, seed=1)
    m = torch.from_numpy(m).to(cuda_device).reshape(3, 500, 4, 4)
    b = torch.from_numpy(b[:4, 0]).to(cuda_device)
    g_inv = torch.randn((3, 500, 4, 4, 2), dtype=torch.complex64, device=cuda_device)[..., 0]
    g_x = torch.randn((3, 500, 4, 2), dtype=torch.complex64, device=cuda_device)[..., 0]
    assert not g_inv.is_contiguous() and not g_x.is_contiguous()
    before = (cinv_mod.neg_ptgpt.launches, lu_mod.lut_apply.launches)
    (dm,), (dm_p,) = _grads(linalg.cinv, [m], g_inv)
    (dm2, db), (dm2_p, db_p) = _grads(linalg.csolve1, [m, b], g_x)
    assert (cinv_mod.neg_ptgpt.launches, lu_mod.lut_apply.launches) == (
        before[0] + 1, before[1] + 1)
    for out, ref in ((dm, dm_p), (dm2, dm2_p), (db, db_p)):
        assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL

    num, den, z = cascade(96, 11, 4097, seed=2)
    num, den, z = (torch.from_numpy(x).to(cuda_device) for x in (num, den, z))
    g_h = torch.randn((96, 4097, 2), dtype=torch.complex64, device=cuda_device)[..., 0]
    before = sos_mod.sos_cascade_backward.launches
    (dn, dd), (dn_p, dd_p) = _grads(lambda a, d: sos_mod.sos_cascade_response(a, d, z),
                                    [num, den], g_h)
    assert sos_mod.sos_cascade_backward.launches == before + 1
    for out, ref in ((dn, dn_p), (dd, dd_p)):
        assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


def _td_inputs(delays, t_len, impulse, seed):
    from diffgfdn_torch.ops.absorption import decay_times_to_gain_per_sample

    n = len(delays)
    rng = np.random.RandomState(seed)
    a = (np.linalg.qr(rng.randn(n, n))[0]).astype(np.float32)
    g = decay_times_to_gain_per_sample(1.2, np.asarray(delays), 32000.0).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    u = np.zeros(t_len, np.float32) if impulse else rng.randn(t_len).astype(np.float32)
    if impulse:
        u[0] = 1.0
    return [torch.from_numpy(x) for x in (g, a, b, u)]


def _path_delays():
    from diffgfdn_torch.config import preset_config

    return tuple(int(d) for d in preset_config("three_room_example").delay_length_samps)


def _spread(m_min, m_max, n=12):
    return tuple(int(d) for d in np.linspace(m_min, m_max, n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path_impulse", "path_random", "wide_random", "ring_full",
                                  "ring_full_plus_one"])
def test_tdgfdn_kernel_matches_plain_on_card(cuda_device, case):
    limit = td_mod.shared_memory_limit(cuda_device)
    if case.startswith("path"):
        delays, t_len = _path_delays(), 131072
    elif case == "wide_random":
        delays, t_len = _spread(100, 50000), 8192
    else:  # the largest ring that fits the shared memory, then one sample more
        delays = td_mod.ring_boundary_delays(12, 683, limit, case == "ring_full_plus_one")
        t_len = 32768
    plan = td_mod.kernel_plan(delays, limit)
    if case == "ring_full":
        assert td_mod.ring_bytes(12, plan.ring) <= limit
    expected = td_mod.HIST if case in ("wide_random", "ring_full_plus_one") else td_mod.RING
    assert plan.variant == expected
    args = [x.to(cuda_device) for x in _td_inputs(delays, t_len, case == "path_impulse", seed=7)]
    before = td_mod.delay_line_outputs.launches
    out, ref = _on_card_and_plain(lambda *a: td_mod.delay_line_outputs(delays, *a), *args)
    assert td_mod.delay_line_outputs.launches == before + 1
    assert out.shape == (t_len, len(delays))
    assert torch.equal(out, ref)
    again = td_mod.delay_line_outputs(delays, *args)
    torch.cuda.synchronize()
    assert torch.equal(again, ref)


@pytest.mark.cuda
def test_tdgfdn_kernel_raises_for_mixed_devices(cuda_device):
    delays = (37, 41, 43, 53)
    g, a, b, u = _td_inputs(delays, 256, True, seed=1)
    before = td_mod.delay_line_outputs.launches
    with pytest.raises(ValueError, match="different devices"):
        td_mod.delay_line_outputs(delays, g.to(cuda_device), a, b.to(cuda_device), u)
    assert td_mod.delay_line_outputs.launches == before
