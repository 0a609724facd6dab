"""The EDC and EDR losses' autograd functions (``kernels/decay.py``) on the CPU.

CPU tensors take the plain versions: the port's earlier PyTorch forward
(flip, cumsum, flip) and the analytic backward that the kernels B8 / B9
also compute. Held here against autograd through the earlier code of
``losses/gfdn.py`` (restated below), in float32 (loss 1e-6 relative,
gradient 1e-5 of its largest value) and by ``gradcheck`` in float64; over a
time mask on and off, an all-zero tail (E = 0), exact ties (target = D),
ERB-grouped real input, frequency weights, batched and unbatched inputs;
the ``vmap`` rules against a loop over bands; the wrappers' dispatch and
argument checks. The kernels themselves are held to the plain versions on
the card (``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import counted_wrappers, decay
from diffgfdn_torch.losses.gfdn import edc_loss_from_rir, edr_loss_from_rir
from diffgfdn_torch.ops.basic import db, schroeder_backward_int
from diffgfdn_torch.ops.stft import edr_from_stft, erb_filterbank, stft

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
N, START, END = 600, 40, 520  # row length and EDC window
WIN, HOP = 64, 32  # EDR frames: 33 bins x 17 frames at N = 600


def earlier_edc_loss(target, trunc, mask=None):
    """``edc_loss_from_rir`` as the port computed it before the kernels."""
    err = torch.abs(target - db(schroeder_backward_int(trunc), is_squared=True))
    if mask is None:
        return torch.mean(err)
    items = err.numel() // err.shape[-1]
    return torch.sum(err * mask) / (torch.sum(mask) * items + 1e-9)


def earlier_edr_loss(target, abs_sum, s, weights=None):
    """``edr_loss_from_rir`` after its STFT (and ERB grouping), as before."""
    freq_loss = torch.sum(torch.abs(target - edr_from_stft(s)), dim=-1)
    if weights is not None:
        freq_loss = freq_loss * weights
    if target.dim() == 3:
        return torch.sum(torch.sum(freq_loss, dim=-1) / abs_sum)
    return torch.sum(freq_loss) / abs_sum


def rirs(shape, seed, dtype=torch.float32, zero_tail=0):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1])
    x = rng.randn(*shape) * np.exp(-t / 150.0)
    if zero_tail:
        x[..., -zero_tail:] = 0.0
    return torch.tensor(x, dtype=dtype)


def offset(d, seed, ties=False):
    """A target 0.5-3 dB from d on either side; with ``ties`` every third
    element equal to d (|target - D| = 0 exactly)."""
    gen = torch.Generator().manual_seed(seed)
    size = torch.rand(d.shape, generator=gen, dtype=d.dtype) * 2.5 + 0.5
    sign = torch.where(torch.rand(d.shape, generator=gen, dtype=d.dtype) < 0.5, -1.0, 1.0)
    out = d + sign * size
    if ties:
        out.view(-1)[::3] = d.reshape(-1)[::3]
    return out


def value_and_grad(fn, x):
    x = x.detach().clone().requires_grad_()
    loss = fn(x)
    (grad,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), grad


def assert_close(new, ref):
    (v, g), (v_ref, g_ref) = new, ref
    assert abs(v - v_ref) <= LOSS_TOL * abs(v_ref), (v, v_ref)
    err = float(torch.max(torch.abs(g - g_ref)) / torch.max(torch.abs(g_ref)))
    assert err <= GRAD_TOL, err


EDC_CASES = {
    "batched": dict(shape=(4, N)),
    "masked": dict(shape=(4, N), masked=True),
    "unbatched": dict(shape=(N,)),
    "unbatched_masked": dict(shape=(N,), masked=True),
    "stacked": dict(shape=(2, 3, N), masked=True),
    "zero_tail": dict(shape=(4, N), zero_tail=120),
    "ties": dict(shape=(4, N), masked=True, ties=True),
}


@pytest.mark.parametrize("case", sorted(EDC_CASES))
def test_edc_loss_matches_autograd_through_the_earlier_code(case):
    """The EDC loss over a window sliced from whole rows and its analytic
    backward against autograd through the earlier loss on the cut rows; the
    gradient is zero outside the window (and where E = 0 or target = D)."""
    kw = EDC_CASES[case]
    x = rirs(kw["shape"], seed=1, zero_tail=kw.get("zero_tail", 0))
    e = schroeder_backward_int(x[..., START:END])
    target = offset(db(e, is_squared=True), seed=2, ties=kw.get("ties", False))
    mask = torch.bernoulli(torch.rand(END - START, generator=torch.Generator().manual_seed(3))) \
        if kw.get("masked") else None
    new = value_and_grad(lambda r: edc_loss_from_rir(target, r[..., START:END], mask), x)
    ref = value_and_grad(lambda r: earlier_edc_loss(target, r[..., START:END], mask), x)
    assert_close(new, ref)
    assert torch.all(new[1][..., :START] == 0) and torch.all(new[1][..., END:] == 0)
    if "zero_tail" in kw:
        assert torch.all(new[1][..., END - 1] == 0)


def test_edc_loss_of_cut_rows_is_the_windowed_loss():
    """A window sliced from whole rows (read at its row stride) and the same
    window copied out give the same loss."""
    x = rirs((3, N), seed=4)
    target = offset(db(schroeder_backward_int(x[:, START:END]), is_squared=True), seed=5)
    whole = edc_loss_from_rir(target, x[:, START:END])
    cut = edc_loss_from_rir(target, x[:, START:END].contiguous())
    assert float(whole) == pytest.approx(float(cut), rel=1e-7)


def _edr_inputs(shape, erb, seed):
    x = rirs(shape, seed=seed)
    fb = torch.tensor(erb_filterbank(8000.0, WIN, 12)[0], dtype=torch.float32) if erb else None

    def features(r):
        s = stft(r, WIN, HOP)
        return s if fb is None else torch.matmul(fb, torch.abs(s))

    return x, fb, features


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("erb", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_edr_loss_matches_autograd_through_the_earlier_code(batched, erb, weighted):
    """The EDR loss from the complex STFT (read through its transpose) or
    its ERB-grouped magnitudes, weighted or not, batched or one RIR, and its
    analytic backward, against autograd through the earlier code."""
    x, fb, features = _edr_inputs((3, N) if batched else (N,), erb, seed=6)
    target = offset(edr_from_stft(features(x)), seed=7)
    abs_sum = torch.sum(torch.abs(target), dim=(-2, -1))
    weights = torch.linspace(2.0, 1.0, target.shape[-2]) if weighted else None
    new = value_and_grad(lambda r: edr_loss_from_rir(target, abs_sum, r, WIN, HOP, fb, weights),
                         x)
    ref = value_and_grad(lambda r: earlier_edr_loss(target, abs_sum, features(r), weights), x)
    assert_close(new, ref)


def test_edr_loss_with_ties_and_a_zero_tail_matches_autograd():
    """Exact ties (target = D) and silent last frames (E = 0) give no
    gradient, as autograd's sgn(0) = 0 does."""
    x, _, features = _edr_inputs((2, N), False, seed=8)
    x[:, -2 * WIN:] = 0.0
    target = offset(edr_from_stft(features(x)), seed=9, ties=True)
    abs_sum = torch.sum(torch.abs(target), dim=(-2, -1))
    new = value_and_grad(lambda r: edr_loss_from_rir(target, abs_sum, r, WIN, HOP), x)
    ref = value_and_grad(lambda r: earlier_edr_loss(target, abs_sum, features(r)), x)
    assert_close(new, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_edc_loss_backward_passes_gradcheck_in_float64(masked):
    x = rirs((2, 48), seed=10, dtype=torch.float64).requires_grad_()
    target = offset(db(schroeder_backward_int(x.detach()[:, 8:40]), is_squared=True), seed=11)
    mask = torch.tensor([1.0, 0.0] * 16, dtype=torch.float64) if masked else None
    assert torch.autograd.gradcheck(
        lambda r: decay.edc_window_loss(target, r[:, 8:40], mask), (x,))


@pytest.mark.parametrize("complex_input", [True, False])
def test_edr_loss_backward_passes_gradcheck_in_float64(complex_input):
    gen = torch.Generator().manual_seed(12)
    dtype = torch.complex128 if complex_input else torch.float64
    s = torch.randn((2, 5, 7), generator=gen, dtype=dtype).requires_grad_()
    with torch.no_grad():
        target = offset(edr_from_stft(s), seed=13)
    abs_sum = torch.sum(torch.abs(target), dim=(-2, -1))
    weights = torch.linspace(2.0, 1.0, 5, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda v: decay.edr_features_loss(target, abs_sum, v, weights), (s,))


@pytest.mark.parametrize("loss", ["edc", "edr"])
def test_vmap_over_bands_matches_a_loop(loss):
    """Under ``torch.func.vmap`` the band axis is folded into the rows: the
    losses and the gradients of their sum equal a loop over the bands."""
    bands = 3
    x = rirs((bands, 4, N), seed=14)
    if loss == "edc":
        target = offset(db(schroeder_backward_int(x[..., START:END]), is_squared=True), seed=15)
        mask = torch.bernoulli(torch.rand(END - START, generator=torch.Generator().manual_seed(16)))

        def fn(r, t):
            return edc_loss_from_rir(t, r[..., START:END], mask)
        extra = ()
    else:
        target = offset(edr_from_stft(stft(x, WIN, HOP)), seed=17)
        abs_sum = torch.sum(torch.abs(target), dim=(-2, -1))

        def fn(r, t, a):
            return edr_loss_from_rir(t, a, r, WIN, HOP)
        extra = (abs_sum,)
    xv = x.clone().requires_grad_()
    out = torch.func.vmap(fn)(xv, target, *extra)
    out.sum().backward()
    xl = x.clone().requires_grad_()
    ref = torch.stack([fn(xl[b], target[b], *(e[b] for e in extra)) for b in range(bands)])
    ref.sum().backward()
    assert torch.allclose(out, ref, rtol=1e-6, atol=0)
    err = float(torch.max(torch.abs(xv.grad - xl.grad)) / torch.max(torch.abs(xl.grad)))
    assert err <= GRAD_TOL


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    x = rirs((2, N), seed=18).requires_grad_()
    target = offset(db(schroeder_backward_int(x.detach()[:, START:END]), is_squared=True), 19)
    edr_target = offset(edr_from_stft(stft(x.detach(), WIN, HOP)), 20)
    before = {k: w.launches for k, w in counted_wrappers().items()}
    loss = edc_loss_from_rir(target, x[:, START:END]) + edr_loss_from_rir(
        edr_target, torch.sum(torch.abs(edr_target), dim=(-2, -1)), x, WIN, HOP)
    loss.backward()
    assert {k: w.launches for k, w in counted_wrappers().items()} == before
    assert {"edc_loss", "edc_loss_backward", "edr_loss", "edr_loss_backward"} <= set(before)


def test_no_gradient_wanted_saves_no_local_derivative():
    x = rirs((2, N), seed=21)
    target = torch.zeros(2, END - START)
    _, h, norm = decay.edc_loss_forward(x[:, START:END], target, None, 2, False)
    assert h.numel() == 0 and float(norm) == 2 * (END - START)
    s = stft(x, WIN, HOP)
    _, h = decay.edr_loss_forward(s, torch.zeros(s.shape), torch.ones(2), None, 2, False)
    assert h.numel() == 0


@pytest.mark.parametrize("bad", ["window", "target_grad", "edr_dims", "edr_target_grad",
                                 "vmapped_mask", "vmapped_weights"])
def test_the_front_ends_refuse_what_they_do_not_take(bad):
    x = rirs((2, N), seed=22)
    target = torch.zeros(2, END - START)
    s = stft(x, WIN, HOP)
    edr_target = torch.zeros(s.shape)
    with pytest.raises(ValueError):
        if bad == "window":
            decay.edc_window_loss(target, x[:, START:])
        elif bad == "target_grad":
            decay.edc_window_loss(target.requires_grad_(), x[:, START:END])
        elif bad == "edr_dims":
            decay.edr_features_loss(edr_target[None], torch.ones(1, 2), s[None])
        elif bad == "edr_target_grad":
            decay.edr_features_loss(edr_target.requires_grad_(), torch.ones(2), s)
        elif bad == "vmapped_mask":
            torch.func.vmap(lambda m: decay.edc_window_loss(target, x[:, START:END], m))(
                torch.ones(2, END - START))
        else:
            torch.func.vmap(lambda w: decay.edr_features_loss(edr_target, torch.ones(2), s, w))(
                torch.ones(2, s.shape[-2]))


def test_the_kernel_checks_refuse_other_dtypes_and_layouts():
    """What the CUDA path raises on (the checks run before any launch)."""
    x = rirs((2, N), seed=23)
    with pytest.raises(ValueError):
        decay._edc_check(x.double())
    with pytest.raises(ValueError):
        decay._edc_check(x.t())
    with pytest.raises(ValueError):
        decay._edc_check(x, torch.zeros(4, 2).t())
    with pytest.raises(ValueError):
        decay._edr_check(torch.zeros(2, 3, 4, dtype=torch.complex128))


@pytest.mark.parametrize("rows,t_len,run,chunks", [
    (32, 38720, 5, 31),  # the three-room cell: 992 blocks on 132 SMs
    (32, 46592, 6, 31),  # fullband
    (8, 38720, 2, 76),  # a validation remainder of 8
    (2, 100, 1, 1),
])
def test_edc_plan_fills_the_card_from_the_shape_it_sees(rows, t_len, run, chunks):
    assert decay.edc_plan(rows, t_len, 132) == (run, chunks)
    assert (run - 1) * decay.EDC_THREADS * decay.EDC_BLOCKS_PER_SM * 132 < rows * t_len or run == 1
