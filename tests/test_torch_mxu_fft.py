"""The port's matmul irfft (``ops/mxu_fft.py``) against numpy and JAX's, on
JAX's cases (``tests/test_mxu_fft.py``), and the directional loss with and
without it against JAX's.

Bounds: 1e-5 of the largest value against ``numpy.fft.irfft`` and against
JAX's ``irfft_matmul`` on the same input; the directional loss with and
without ``use_matmul_irfft`` 1e-5 relative, its gradient 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.losses import directional_edc_loss_from_sh
from diffgfdn_torch.ops.mxu_fft import ifft_matmul_unscaled, irfft_matmul
from diffgfdn_torch.training.trainer import DirectionalGFDNTrainer, GFDNTrainer
from diffgfdn_tpu.losses import directional_edc_loss_from_sh as jax_directional_loss
from diffgfdn_tpu.ops.mxu_fft import irfft_matmul as jax_irfft_matmul

PEAK_TOL = 1e-5  # max abs error / max |reference|
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _peak_err(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", [16, 128, 4096])
def test_irfft_matmul_matches_numpy_and_jax(n, record_property):
    """16 is the square split, 128 the unequal one (n1 != n2)."""
    x = np.random.RandomState(0).randn(3, n)
    h = np.fft.rfft(x, n).astype(np.complex64)
    got = irfft_matmul(torch.from_numpy(h), n).numpy()
    err_np = _peak_err(got, np.fft.irfft(h, n))
    err_jax = _peak_err(got, jax_irfft_matmul(jnp.asarray(h), n))
    record_property("err_numpy", float(err_np))
    record_property("err_jax", float(err_jax))
    assert got.dtype == np.float32 and got.shape == (3, n)
    assert err_np <= PEAK_TOL and err_jax <= PEAK_TOL


@pytest.mark.parametrize("window", [(0, 128), (16, 64), (1, 7), (65, 125)])
def test_irfft_matmul_windows_match_numpy_and_jax(window):
    n = 128
    s, e = window
    h = np.fft.rfft(np.random.RandomState(1).randn(2, n), n).astype(np.complex64)
    got = irfft_matmul(torch.from_numpy(h), n, s, e).numpy()
    ref = np.fft.irfft(h, n)
    assert got.shape == (2, e - s)
    assert np.abs(got - ref[:, s:e]).max() <= PEAK_TOL * np.abs(ref).max()
    jref = np.asarray(jax_irfft_matmul(jnp.asarray(h), n, s, e))
    assert np.abs(got - jref).max() <= PEAK_TOL * np.abs(jref).max()


def test_ifft_matmul_unscaled_matches_numpy():
    m = 64
    rng = np.random.RandomState(2)
    z = (rng.randn(2, m) + 1j * rng.randn(2, m)).astype(np.complex64)
    got = ifft_matmul_unscaled(torch.from_numpy(z), m).numpy()
    assert _peak_err(got, np.fft.ifft(z, m) * m) <= PEAK_TOL
    part = ifft_matmul_unscaled(torch.from_numpy(z), m, 2, 6).numpy()  # rows t2 in [2, 6)
    assert part.shape == (2, 4 * 8)
    ref = (np.fft.ifft(z, m) * m).reshape(2, 8, 8)[:, 2:6].reshape(2, -1)
    assert _peak_err(part, ref) <= PEAK_TOL


@pytest.mark.parametrize("n,lo,hi", [(96, 10, 80), (100, 0, None), (128, 130, 200), (4, 0, 4)])
def test_irfft_matmul_falls_back_where_jax_does(n, lo, hi):
    """Lengths that are not powers of two (or below 8) and empty windows take
    ``torch.fft.irfft`` with the same slicing."""
    rng = np.random.RandomState(0)
    h = (rng.randn(3, n // 2 + 1) + 1j * rng.randn(3, n // 2 + 1)).astype(np.complex64)
    got = irfft_matmul(torch.from_numpy(h), n, lo, hi).numpy()
    want = np.fft.irfft(h, n, axis=-1)[..., lo:hi]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)
    jwant = np.asarray(jax_irfft_matmul(jnp.asarray(h), n, lo, hi))
    np.testing.assert_allclose(got, jwant, atol=2e-6)


def _loss_inputs(decaying: bool):
    """JAX's case (white SH spectra, F = 257), or SH responses that decay
    as a room's do (nfft 4096, the window 32 .. 2080)."""
    rng = np.random.RandomState(3 if not decaying else 4)
    if decaying:
        n = 4096
        x = rng.randn(2, 4, n) * np.exp(-np.arange(n) / 600.0)
        h = np.fft.rfft(x, n)
        h_ri = np.stack([h.real, h.imag], -1).astype(np.float32)
        edc_len, env_len, scale = 2048, 3000, 200.0
    else:
        h_ri = rng.randn(2, 4, 257, 2).astype(np.float32) * 0.1
        edc_len, env_len, scale = 300, 300, 50.0
    analysis = rng.randn(6, 4).astype(np.float32)
    amps = rng.rand(2, 6, 3).astype(np.float32)
    env = np.exp(-np.arange(env_len)[None, :] / (scale * (1 + np.arange(3))[:, None]))
    return h_ri, analysis, amps, env.astype(np.float32), edc_len


def _port_loss(inputs, flag):
    h_ri, analysis, amps, env, edc_len = inputs
    h = torch.tensor(h_ri, requires_grad=True)
    loss = directional_edc_loss_from_sh(
        torch.complex(h[..., 0], h[..., 1]), torch.from_numpy(analysis),
        torch.from_numpy(amps), torch.from_numpy(env), 32, edc_len, use_matmul_irfft=flag)
    loss.backward()
    return float(loss.detach()), h.grad.numpy()


def _jax_loss(inputs, flag):
    h_ri, analysis, amps, env, edc_len = inputs

    def loss(x):
        return jax_directional_loss(x[..., 0] + 1j * x[..., 1], analysis, jnp.asarray(amps),
                                    jnp.asarray(env), 32, edc_len, use_matmul_irfft=flag)

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(h_ri))
    return float(value), np.asarray(grad)


def _read_by_irfft(grad: np.ndarray) -> np.ndarray:
    """The gradient on the inputs an irfft reads: the imaginary parts of the
    DC and Nyquist bins are left out (``torch.fft.irfft`` ignores them, the
    four-step transform does not, and a model's H is real at z = +-1)."""
    keep = np.ones(grad.shape, bool)
    keep[..., 0, 1] = keep[..., -1, 1] = False
    return grad[keep]


def test_directional_loss_with_matmul_irfft_matches_native(record_property):
    """On decaying SH responses the two transforms give the loss within 1e-5
    and its gradient within 1e-4; on JAX's white-noise case the EDC's last
    samples carry too little energy for that (float32 rounding of a few
    samples moves the dB error), and the port's difference between the two
    is JAX's own."""
    inputs = _loss_inputs(decaying=True)
    (v0, g0), (v1, g1) = _port_loss(inputs, False), _port_loss(inputs, True)
    loss_rel = abs(v1 - v0) / abs(v0)
    grad_rel = np.linalg.norm(_read_by_irfft(g1 - g0)) / np.linalg.norm(_read_by_irfft(g0))
    record_property("loss_rel", float(loss_rel))
    record_property("grad_rel_l2", float(grad_rel))
    assert loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL
    white = _loss_inputs(decaying=False)
    port_gap = _port_loss(white, True)[0] - _port_loss(white, False)[0]
    jax_gap = _jax_loss(white, True)[0] - _jax_loss(white, False)[0]
    record_property("white_noise_gap_port", float(port_gap))
    record_property("white_noise_gap_jax", float(jax_gap))
    assert abs(port_gap - jax_gap) <= 1e-5 * abs(_jax_loss(white, False)[0])


@pytest.mark.parametrize("decaying", [False, True])
def test_directional_loss_with_matmul_irfft_matches_jax(decaying, record_property):
    """The port's loss and gradient with the switch on against JAX's with it
    on, within C3's bounds (loss 1e-3 relative, gradient 1e-2 relative L2)."""
    inputs = _loss_inputs(decaying)
    (v, g), (jv, jg) = _port_loss(inputs, True), _jax_loss(inputs, True)
    loss_rel = abs(v - jv) / abs(jv)
    grad_rel = np.linalg.norm(g - jg) / np.linalg.norm(jg)
    record_property("loss_rel", float(loss_rel))
    record_property("grad_rel_l2", float(grad_rel))
    assert loss_rel <= 1e-3 and grad_rel <= 1e-2


def test_trainers_leave_the_matmul_irfft_off():
    """``use_mxu_fft`` is off by default, as in the JAX trainer."""
    assert GFDNTrainer.use_mxu_fft is False
    assert DirectionalGFDNTrainer.use_mxu_fft is False
