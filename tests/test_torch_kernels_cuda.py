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
a block (csrc/cinv.cu: 128 at N <= 4, 12 at N = 9, 8 at N = 12, 2 at
N = 27; csrc/lu.cu: 128 at N <= 4, 24 at N = 9, 16 at N = 12, 4 at
N = 27), on a contiguous view 8 bytes past a 16-byte boundary, and on two
launches alike; the transposed solve (B6) on B5's factors too, at N = 4,
9, 12 and 27 and K around its own block (128 systems to N = 12, 64
above). The cascade
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
(which takes the device-memory history), at a spread of 50000 samples, at
the directional presets' 27 delays (coefficients in shared memory), and
on two launches alike. The EDC and EDR loss kernels (B8, B9) are held to
their plain versions at the benchmark cells' shapes (the loss within 1e-6
relative, the gradient within 1e-5 of its largest value), B8's tail energy
to float64, both to the same bits on two launches, and a captured loss
step to their planned calls and no PyTorch scan.
"""

import contextlib

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import lu as lu_mod, sos as sos_mod, tdgfdn as td_mod
from diffgfdn_torch.kernels.dispatch import plain_versions
from diffgfdn_torch.kernels import linalg
from torch_port_helpers import (cascade, CINV_BLOCK_SYSTEMS, cinv_systems, KERNEL_TOL as TOL,
                                LU_BLOCK_SYSTEMS, LUT_BLOCK_SYSTEMS, max_rel, systems)


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


# csrc/cinv.cu runs CINV_BLOCK_SYSTEMS[n] systems a block (a tile of 128 at
# N <= 4; floor(32 / N) a warp at N > 8): K around that count, 1000, and
# K = 3 x 65537, the fullband path's
CINV_SIZES = (1, 4, 9, 12, 27)
CINV_CASES = [(n, k) for n in CINV_SIZES
              for t in (CINV_BLOCK_SYSTEMS[n],)
              for k in (1, t - 1, t, t + 1, 1000, 3 * 65537)]
# csrc/lu.cu runs 128 systems a block at each N it is tested at
LU_BLOCK = 128
LU_K = (1, LU_BLOCK - 1, LU_BLOCK, LU_BLOCK + 1, 1000, 3 * 65537)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", CINV_CASES)
def test_cinv_kernel_matches_plain_on_card(cuda_device, n, k):
    m = torch.from_numpy(cinv_systems(k, n, seed=n)).to(cuda_device)
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
    m = torch.from_numpy(cinv_systems(k, n, seed=70 + n)).to(cuda_device)
    g = torch.from_numpy(systems(k, n, seed=80 + n)[0]).to(cuda_device)
    out, ref = _on_card_and_plain(cinv_mod.cinv, _offset_view(m))
    assert torch.equal(out, ref)
    assert torch.equal(out, cinv_mod.cinv(m))
    p, g_view = _offset_view(ref), _offset_view(g)
    out, ref = _on_card_and_plain(cinv_mod.neg_ptgpt, p, g_view)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 9])
def test_cinv_kernels_are_deterministic_on_card(cuda_device, n):
    k = 3 * 65537
    m = torch.from_numpy(cinv_systems(k, n, seed=3)).to(cuda_device)
    g = torch.from_numpy(systems(k, n, seed=4)[0]).to(cuda_device)
    first, second = cinv_mod.cinv(m), cinv_mod.cinv(m)
    assert torch.equal(first, second)
    assert torch.equal(cinv_mod.neg_ptgpt(first, g), cinv_mod.neg_ptgpt(second, g))


# csrc/lu.cu tiles 128 systems a block at N <= 4 (32 at N = 8) and gives
# each lane a row of a system at N > 8 (LU_BLOCK_SYSTEMS a block)
LU_SIZES = (1, 4, 8, 9, 12, 27)
LU_ROW_CASES = [(n, k) for n in (9, 12, 27)
                for t in (LU_BLOCK_SYSTEMS[n],)
                for k in (1, t - 1, t, t + 1, 3 * 65537)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", LU_K)
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
@pytest.mark.parametrize("n,k", LU_ROW_CASES)
def test_lu_row_solve_and_transposed_solve_match_plain_on_card(cuda_device, n, k):
    """The row solve (N > 8) at K around a block's systems and at the
    directional step's 3 x 65537: x, factors and pivots bit for bit, twice
    alike, from views 8 bytes off alignment too; B6 on those factors bit for
    bit."""
    m, b = (torch.from_numpy(x).to(cuda_device) for x in systems(k, n, seed=100 + n + k))
    g = torch.from_numpy(systems(k, n, seed=200 + n + k)[1]).to(cuda_device)
    before = lu_mod.lu_solve.launches
    out, ref = _on_card_and_plain(lu_mod.lu_solve, m, b)
    assert lu_mod.lu_solve.launches == before + 1
    again = lu_mod.lu_solve(_offset_view(m), _offset_view(b))
    torch.cuda.synchronize()
    for a, c, r in zip(out, again, ref):
        assert torch.equal(a, r) and torch.equal(c, r)
    _, lu, piv = out
    before = lu_mod.lut_apply.launches
    y, y_ref = _on_card_and_plain(lu_mod.lut_apply, lu, piv, g)
    assert lu_mod.lut_apply.launches == before + 1
    assert torch.equal(y, y_ref)
    assert torch.equal(lu_mod.lut_apply(lu, piv, _offset_view(g)), y_ref)


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
@pytest.mark.parametrize("n,k", CINV_CASES)
def test_neg_ptgpt_kernel_matches_plain_on_card(cuda_device, n, k):
    m = cinv_systems(k, n, seed=n)
    g, _ = systems(k, n, seed=50 + n)
    p = cinv_mod.cinv(torch.from_numpy(m).to(cuda_device))
    before = cinv_mod.neg_ptgpt.launches
    out, ref = _on_card_and_plain(cinv_mod.neg_ptgpt, p, torch.from_numpy(g).to(cuda_device))
    assert cinv_mod.neg_ptgpt.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k", ["1000", "T+1"])
@pytest.mark.parametrize("n", [4, 9, 12, 27])
def test_lut_apply_kernel_matches_plain_on_card(cuda_device, n, k):
    """B6 on B5's factors bit for bit, at K = 1000 and at one past a block's
    systems (LUT_BLOCK_SYSTEMS: both leave a partial last block), and from a
    g 8 bytes off alignment."""
    k = 1000 if k == "1000" else LUT_BLOCK_SYSTEMS[n] + 1
    m, b = systems(k, n, seed=n)
    _, lu, piv = lu_mod.lu_solve(torch.from_numpy(m).to(cuda_device),
                                 torch.from_numpy(b).to(cuda_device))
    g = torch.from_numpy(b[::-1].copy()).to(cuda_device)
    before = lu_mod.lut_apply.launches
    out, ref = _on_card_and_plain(lu_mod.lut_apply, lu, piv, g)
    assert lu_mod.lut_apply.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(lu_mod.lut_apply(lu, piv, _offset_view(g)), ref)


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
@pytest.mark.parametrize("impulse", [True, False], ids=["impulse", "random"])
def test_tdgfdn_kernel_at_the_directional_delays_matches_plain_on_card(cuda_device, impulse):
    """The directional presets' 27 delays, T = 131072: the lines variant
    (coefficients in shared memory, history in device memory), bit for bit,
    twice alike."""
    from diffgfdn_torch.config import preset_config

    delays = tuple(int(d) for d in preset_config("directional_1000Hz_res0.6m").delay_length_samps)
    assert td_mod.kernel_plan(delays, td_mod.shared_memory_limit(cuda_device)).variant == (
        td_mod.LINES)
    args = [x.to(cuda_device) for x in _td_inputs(delays, 131072, impulse, seed=27)]
    before = td_mod.delay_line_outputs.launches
    out, ref = _on_card_and_plain(lambda *a: td_mod.delay_line_outputs(delays, *a), *args)
    assert td_mod.delay_line_outputs.launches == before + 1
    assert out.shape == (131072, 27)
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


# the band-parallel trainer's shapes: the 4-band group of the eight octave
# bands stacks 4 x 3 x 65537 loop blocks of 4 x 4 and 4 x 12 absorption cascades
BANDS = 4


def _vmapped_launches(fn, leaves, g, counters):
    """fn vmapped over the leading (band) axis of the leaves, forward and
    backward, on the kernels and on the plain versions; returns the launches
    of each counter in the kernels' run, and (outputs, grads) of both runs."""
    runs = []
    for plain in (False, True):
        xs = [x.detach().clone().requires_grad_() for x in leaves]
        before = [c.launches for c in counters]
        with plain_versions() if plain else contextlib.nullcontext():
            y = torch.func.vmap(fn)(*xs)
            y.backward(g)
        torch.cuda.synchronize()
        if not plain:
            launched = [c.launches - b for c, b in zip(counters, before)]
        runs.append((y.detach(), [x.grad for x in xs]))
    return launched, runs


@pytest.mark.cuda
def test_band_stacked_inverse_launches_b1_and_b2_once(cuda_device):
    m = torch.from_numpy(cinv_systems(BANDS * 3 * 65537, 4, seed=7)).to(cuda_device)
    m = m.reshape(BANDS, 3, 65537, 4, 4)
    g = torch.randn(m.shape, dtype=torch.complex64, device=cuda_device)
    launched, ((p, (dm,)), (p_p, (dm_p,))) = _vmapped_launches(
        linalg.cinv, [m], g, [cinv_mod.cinv, cinv_mod.neg_ptgpt])
    assert launched == [1, 1]
    assert torch.equal(p, p_p) and torch.equal(dm, dm_p)


@pytest.mark.cuda
def test_band_stacked_solve_launches_b5_and_b6_once(cuda_device):
    m, b = systems(BANDS * 3 * 65537, 4, seed=8)
    m = torch.from_numpy(m).to(cuda_device).reshape(BANDS, 3, 65537, 4, 4)
    b = torch.from_numpy(b).to(cuda_device).reshape(BANDS, 3, 65537, 4)
    g = torch.randn(b.shape, dtype=torch.complex64, device=cuda_device)
    launched, ((x, (dm, db)), (x_p, (dm_p, db_p))) = _vmapped_launches(
        linalg.csolve1, [m, b], g, [lu_mod.lu_solve, lu_mod.lut_apply])
    assert launched == [1, 1]
    assert torch.equal(x, x_p)
    for out, ref in ((dm, dm_p), (db, db_p)):
        assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.cuda
def test_band_stacked_cascade_launches_b3_and_b4_once(cuda_device):
    num, den, z = cascade(BANDS * 12, 11, 65537, seed=9)
    num, den = (torch.from_numpy(x).to(cuda_device).reshape(BANDS, 12, 11, 3)
                for x in (num, den))
    z = torch.from_numpy(z).to(cuda_device)
    g = torch.randn((BANDS, 12, 65537), dtype=torch.complex64, device=cuda_device)
    launched, ((h, (dn, dd)), (h_p, (dn_p, dd_p))) = _vmapped_launches(
        lambda a, d: sos_mod.sos_cascade_response(a, d, z), [num, den], g,
        [sos_mod.sos_cascade_response, sos_mod.sos_cascade_backward])
    assert launched == [1, 1]
    for out, ref in ((h, h_p), (dn, dn_p), (dd, dd_p)):
        assert max_rel(out.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.cuda
def test_band_parallel_step_on_kernels_matches_plain_versions(cuda_device, tmp_path):
    """One step of a 2-band group at nfft 2^14 (scalar heads, GEQ absorption,
    the colorless loss): each kernel launches once, and the losses (1e-6
    relative) and gradients (1e-3 relative L2) match the plain versions'."""
    from diffgfdn_torch.cli import run_subband_training as rst
    from diffgfdn_torch.data import arrays_from_room_dataset, synthetic_three_room_dataset

    nfft = 2 ** 14
    room = synthetic_three_room_dataset(tmp_path, fs=32000.0, nfft=nfft, num_rec_per_room=4,
                                        rir_len_s=0.5)
    room.common_decay_times = np.array([[0.3, 0.4, 0.35]] * 4) * np.linspace(1.2, 0.8, 4)[:, None]
    room.band_centre_hz = [250.0, 500.0, 1000.0, 2000.0]
    group = [rst.create_config(f, "unused", str(tmp_path), nfft, batch_size=8)
             for f in (500.0, 1000.0)]
    arrays = arrays_from_room_dataset(room)
    trainer = rst.band_parallel_trainer(group, room, arrays, np.arange(8), cuda_device)
    idx = torch.arange(8, device=cuda_device)
    counters = [cinv_mod.cinv, cinv_mod.neg_ptgpt, sos_mod.sos_cascade_response,
                lu_mod.lu_solve, lu_mod.lut_apply]
    before = [c.launches for c in counters]
    loss, _ = trainer.loss_and_grads(idx)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1] * 5
    grads = {k: p.grad.clone() for k, p in trainer.params.items()}
    with plain_versions():
        loss_p, _ = trainer.loss_and_grads(idx)
    assert torch.all(torch.abs(loss - loss_p) <= 1e-6 * torch.abs(loss_p))
    for k, p in trainer.params.items():
        for b in range(2):
            err = float(torch.linalg.vector_norm(grads[k][b] - p.grad[b])
                        / torch.linalg.vector_norm(p.grad[b]))
            assert err <= 1e-3, (k, b, err)


# ------------------- the energy-decay losses (B8 EDC, B9 EDR) -------------------

DECAY_ROWS, DECAY_NFFT, DECAY_MIXING = 32, 131072, 640
DECAY_WINDOWS = (38720, 46592)  # the three-room and fullband cells' EDC windows
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5  # loss relative; gradient max abs error / max |plain|


def _decaying_rows(device, rows=DECAY_ROWS, n=DECAY_NFFT, seed=0, tau=8000.0):
    """RIR-like rows: noise under an exponential decay (float32, on the card)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = rng.randn(rows, n) * np.exp(-t / (tau * rng.uniform(0.8, 1.2, (rows, 1))))
    return torch.tensor(x, dtype=torch.float32, device=device)


def _offset_target(d, seed):
    """A target in dB at 0.5-3 dB from d on either side, so that no sign of
    target - D is left to rounding."""
    gen = torch.Generator(device=d.device).manual_seed(seed)
    size = torch.rand(d.shape, generator=gen, device=d.device) * 2.5 + 0.5
    sign = torch.where(torch.rand(d.shape, generator=gen, device=d.device) < 0.5, -1.0, 1.0)
    return (d + sign * size).contiguous()


def _loss_and_grad(fn, x):
    x = x.detach().requires_grad_()
    loss = fn(x)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


def _held_to_plain(fn, x, counters):
    before = [c.launches for c in counters]
    loss, grad = _loss_and_grad(fn, x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1] * len(counters)
    with plain_versions():
        loss_p, grad_p = _loss_and_grad(fn, x)
    rel = float(torch.abs(loss - loss_p) / torch.abs(loss_p))
    err = float(torch.max(torch.abs(grad - grad_p)) / torch.max(torch.abs(grad_p)))
    assert rel <= LOSS_TOL and err <= GRAD_TOL, (rel, err)


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", DECAY_WINDOWS)
@pytest.mark.parametrize("masked", [False, True])
def test_edc_loss_kernels_match_plain_on_card(cuda_device, t_len, masked):
    """B8 forward and backward at the cells' windows sliced from rows of
    131072 samples (read in place at the row stride): the loss within 1e-6
    relative of the plain version's, the gradient (the whole rows, zero
    outside the window) within 1e-5 of its largest value."""
    from diffgfdn_torch.kernels import decay
    from diffgfdn_torch.ops.basic import db, schroeder_backward_int

    x = _decaying_rows(cuda_device, seed=t_len)
    start, end = DECAY_MIXING, DECAY_MIXING + t_len
    target = _offset_target(db(schroeder_backward_int(x[:, start:end]), is_squared=True), 1)
    mask = None
    if masked:
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        mask = torch.bernoulli(torch.rand(t_len, generator=gen, device=cuda_device),
                               generator=gen)
    _held_to_plain(lambda r: decay.edc_window_loss(target, r[:, start:end], mask), x,
                   [decay.edc_loss_forward, decay.edc_loss_backward])


@pytest.mark.cuda
def test_edc_loss_kernel_tail_energy_matches_float64(cuda_device):
    """B8's E over the last tenth of the fullband window, read back from its
    local derivative (a target far above D gives h = -10 / ((E + eps) ln 10)),
    within 1e-5 relative of the float64 reverse integral: summed from the end,
    the tail some 60 dB below the window's start keeps its digits."""
    from diffgfdn_torch.kernels import decay

    t_len = DECAY_WINDOWS[1]
    x = 100.0 * _decaying_rows(cuda_device, seed=3, tau=t_len / 6.9)
    start = DECAY_MIXING
    target = torch.full((DECAY_ROWS, t_len), 1000.0, device=cuda_device)
    _, h, _ = decay.edc_loss_forward(x[:, start:start + t_len], target, None, DECAY_ROWS, True)
    e = -10.0 / (h.double() * decay.LN10) - decay.EPS_F32
    w = x[:, start:start + t_len].double() ** 2
    ref = torch.flip(torch.cumsum(torch.flip(w, (-1,)), -1), (-1,))
    # the last tenth but its last 100 samples, whose energy may come near eps
    tail = slice(t_len - t_len // 10, t_len - 100)
    assert float(torch.max(ref[:, tail.stop] / ref[:, 0])) < 1e-4
    err = float(torch.max(torch.abs(e[:, tail] - ref[:, tail]) / ref[:, tail]))
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("erb,weighted", [(False, False), (False, True), (True, True)])
def test_edr_loss_kernels_match_plain_on_card(cuda_device, erb, weighted):
    """B9 forward and backward on the STFT of 32 rows of 131072 samples
    (4096 / 2048: 2049 bins x 63 frames, complex, read through the
    transpose), and on its 64 ERB bands: the loss within 1e-6 relative of
    the plain version's, the gradient within 1e-5 of its largest value."""
    from diffgfdn_torch.kernels import decay
    from diffgfdn_torch.ops.stft import edr_from_stft, erb_filterbank, stft

    x = _decaying_rows(cuda_device, seed=5)
    fb = None
    if erb:
        fb = torch.as_tensor(erb_filterbank(32000.0, 4096, 64)[0], dtype=torch.float32,
                             device=cuda_device)

    def features(r):
        s = stft(r, 4096, 2048)
        return s if fb is None else torch.matmul(fb, torch.abs(s))

    with plain_versions():
        target = _offset_target(edr_from_stft(features(x)), 4)
    abs_sum = torch.sum(torch.abs(target), dim=(-2, -1))
    weights = None
    if weighted:
        weights = torch.linspace(2.0, 1.0, target.shape[-2], device=cuda_device)
    _held_to_plain(lambda r: decay.edr_features_loss(target, abs_sum, features(r), weights), x,
                   [decay.edr_loss_forward, decay.edr_loss_backward])


@pytest.mark.cuda
def test_decay_kernels_give_the_same_bits_on_two_launches(cuda_device):
    """No float atomics: two calls of each forward and backward agree bit for bit."""
    from diffgfdn_torch.kernels import decay
    from diffgfdn_torch.ops.stft import stft

    x = _decaying_rows(cuda_device, seed=6)
    target = torch.zeros((DECAY_ROWS, DECAY_WINDOWS[0]), device=cuda_device)
    s = stft(x, 4096, 2048)
    edr_target = torch.zeros(s.shape, device=cuda_device)
    abs_sum = torch.ones(DECAY_ROWS, device=cuda_device)
    runs = []
    for _ in range(2):
        a = _loss_and_grad(lambda r: decay.edc_window_loss(
            target, r[:, DECAY_MIXING:DECAY_MIXING + DECAY_WINDOWS[0]]), x)
        b = _loss_and_grad(lambda r: decay.edr_features_loss(
            edr_target, abs_sum, stft(r, 4096, 2048)), x)
        runs.append(a + b)
    assert all(torch.equal(p, q) for p, q in zip(*runs))


@pytest.mark.cuda
def test_a_captured_loss_step_launches_b8_and_b9_and_no_scan(cuda_device):
    """The trainer's EDC and EDR losses (``_omni_losses``, masked EDC) and
    their backward captured in a ``StepGraph`` at the three-room cell's
    shapes: each replay adds one call of each of B8 / B9 forward and
    backward to the counters, and a profiled replay runs their kernels and
    no PyTorch scan."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    from diffgfdn_torch.kernels import decay
    from diffgfdn_torch.ops.basic import db, schroeder_backward_int
    from diffgfdn_torch.ops.stft import edr_from_stft, stft
    from diffgfdn_torch.training.scan import StepGraph
    from diffgfdn_torch.training.trainer import _omni_losses

    x = _decaying_rows(cuda_device, seed=7)
    start, end = DECAY_MIXING, DECAY_MIXING + DECAY_WINDOWS[0]
    with plain_versions():
        edr = edr_from_stft(stft(x * 1.1, 4096, 2048))
    batch = {"target_edc_db": db(schroeder_backward_int(x[:, start:end] * 1.1), True),
             "target_edr_db": edr, "target_edr_abs_sum": torch.sum(torch.abs(edr), dim=(-2, -1))}
    cfg = SimpleNamespace(edc_loss_weight=1.0, edr_loss_weight=1.0, reduced_pole_radius=1.0)
    h = torch.fft.rfft(x, dim=-1).requires_grad_()
    mask = torch.bernoulli(torch.full((end - start,), 0.5, device=cuda_device))

    def step(inputs):
        h.grad = None
        losses = _omni_losses(cfg, batch, h * inputs["scale"], start, end, 4096, 2048,
                              inputs["mask"], None, None)
        total = sum(losses.values())
        total.backward()
        return total.detach(), h.grad

    graph = StepGraph(step, cuda_device, torch.cuda.graph_pool_handle())
    scale = torch.ones((), device=cuda_device)
    for _ in range(2):  # the warm-up, the capture
        graph(scale=scale, mask=mask)
    counters = [decay.edc_loss_forward, decay.edc_loss_backward, decay.edr_loss_forward,
                decay.edr_loss_backward]
    before = [c.launches for c in counters]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph(scale=scale, mask=mask)
        torch.cuda.synchronize()
    assert graph.replays == 3
    assert [c.launches - b for c, b in zip(counters, before)] == [3, 3, 3, 3]
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not any("scan_innermost_dim" in n for n in names)
    for symbol in ("edc_loss_fwd_kernel", "edc_loss_bwd_kernel", "edr_loss_fwd_kernel",
                   "edr_loss_bwd_kernel"):
        assert sum(symbol in n for n in names) == 3, symbol
