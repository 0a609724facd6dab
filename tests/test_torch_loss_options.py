"""The loss options (ROADMAP A5) in the port against the JAX package.

* ``ops/stft.erb_filterbank`` and ``losses.frequency_weighting`` (the
  documented intent: weights fall from 2 to 1 above 1 kHz) on JAX's
  fixtures: float64 equal / 1e-6 in float32;
* ``edr_loss`` and ``edr_loss_from_rir`` with ERB grouping and frequency
  weights, ``edc_loss(band_responses=...)`` (linear, mask ignored) and
  ``reg_loss`` (the SVF cascades' impulse responses through the cascade
  kernel's plain version here): values 1e-3 relative and gradients 1e-2
  relative L2 on seeded spectra and cascades;
* ``reg_loss`` on the single-position SVF head of JAX's fixture
  (tests/test_plot_and_misc.py: 100 ms at 8 kHz): its value and its
  gradient in the head's parameters;
* the grid trainer with ``use_reg_loss``, ``use_erb_edr_loss`` and
  ``use_frequency_weighting`` (SVF heads, GEQ absorption): H 1e-3, the
  losses 1e-3 and every gradient 1e-2, one Adam step 1e-6. The regularizer
  runs over 20 ms there: over the default 500 ms both packages' values are
  float32 rounding, some 3e8 times the float64 value (ROADMAP C19).

The band-parallel trainer with the three options:
test_torch_loss_options_band.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffgfdn_torch.losses import edc_loss, edr_loss, frequency_weighting, reg_loss
from diffgfdn_torch.ops.stft import erb_filterbank
from diffgfdn_tpu.losses import gfdn as jlosses
from diffgfdn_tpu.ops import stft as jstft
from torch_option_parity import adam_error, assert_step, option_models, step_errors, UPDATE_TOL
from torch_port_helpers import rel_l2

OPS_TOL = 1e-6
LOSS_TOL = 1e-3  # the loss functions' values, relative (the trainer's bounds)
GRAD_TOL = 1e-2  # and their gradients, relative L2
# the regularizer over 20 ms: over the default 500 ms the heads' impulse
# responses have decayed below float32's rounding of the irfft long before
# the last eighth, so both packages' late sums are rounding (ROADMAP C19)
OPTIONS = {"trainer_config": {"use_reg_loss": True, "use_erb_edr_loss": True,
                              "use_frequency_weighting": True,
                              "output_filt_ir_len_ms": 20.0}}


def test_erb_filterbank_and_frequency_weights_match_jax(record_property):
    fb, centres = erb_filterbank(32000.0, 4096, 64)
    jfb, jcentres = jstft.erb_filterbank(32000.0, 4096, 64)
    np.testing.assert_array_equal(fb, jfb)
    np.testing.assert_array_equal(centres, jcentres)
    assert fb.shape == (64, 2049) and (fb >= 0).all()
    errs = []
    for freqs in (centres, np.fft.rfftfreq(1024, d=1.0 / 8000.0)):
        w = frequency_weighting(freqs)
        errs.append(float(np.abs(w.numpy() - np.asarray(jlosses.frequency_weighting(freqs))).max()))
        assert w.dtype == torch.float32
    w = frequency_weighting(np.array([20.0, 1000.0, 8000.0])).numpy()
    assert w[0] > 1.9 and abs(w[1] - 1.5) < 1e-6 and w[2] < 1.1  # falls with frequency
    record_property("weights_max_abs_err", max(errs))
    assert max(errs) <= OPS_TOL


def _spectra(seed: int, batch: int = 3, nfft: int = 1024):
    rng = np.random.RandomState(seed)
    t = np.arange(nfft) / 8000.0
    rirs = rng.randn(2, batch, nfft) * np.exp(-6.9 * t / np.array([0.08, 0.1])[:, None, None])
    return np.fft.rfft(rirs, axis=-1).astype(np.complex64)


def _value_and_grad(fn, x: np.ndarray):
    """fn's value and gradient in the real and imaginary parts of x (torch)."""
    re = torch.tensor(x.real, requires_grad=True)
    im = torch.tensor(x.imag, requires_grad=True)
    out = fn(torch.complex(re, im))
    out.backward()
    return float(out.detach()), np.concatenate([re.grad.numpy().ravel(), im.grad.numpy().ravel()])


def _jax_value_and_grad(fn, x: np.ndarray):
    val, (gre, gim) = jax.value_and_grad(
        lambda re, im: fn((re + 1j * im).astype(jnp.complex64)), argnums=(0, 1))(
            jnp.asarray(x.real), jnp.asarray(x.imag))
    return float(val), np.concatenate([np.asarray(gre).ravel(), np.asarray(gim).ravel()])


def test_loss_functions_match_jax(record_property):
    target, achieved = _spectra(0)
    fb, centres = erb_filterbank(8000.0, 256, 64)
    erb, jerb = torch.tensor(fb, dtype=torch.float32), jnp.asarray(fb, jnp.float32)
    weights = frequency_weighting(centres)
    jweights = jlosses.frequency_weighting(centres)
    bands = _spectra(1, batch=1)[0][0] / 40.0  # (F,) band responses, as a (1, F) stack
    resp = np.stack([bands, np.conj(bands)])
    errs = {}
    cases = {
        "edr_erb_weighted": (
            lambda a: edr_loss(torch.from_numpy(target), a, 256, 128, erb_filters=erb,
                               frequency_weights=weights),
            lambda a: jlosses.edr_loss(jnp.asarray(target), a, 256, 128, erb_filters=jerb,
                                       frequency_weights=jweights)),
        "edr_weighted": (
            lambda a: edr_loss(torch.from_numpy(target), a, 256, 128,
                               frequency_weights=frequency_weighting(
                                   np.fft.rfftfreq(256, 1 / 8000.0))),
            lambda a: jlosses.edr_loss(jnp.asarray(target), a, 256, 128,
                                       frequency_weights=jlosses.frequency_weighting(
                                           np.fft.rfftfreq(256, 1 / 8000.0)))),
        "edc_band": (
            lambda a: edc_loss(torch.from_numpy(target), a, 160, 800,
                               band_responses=torch.from_numpy(resp)),
            lambda a: jlosses.edc_loss(jnp.asarray(target), a, 160, 800,
                                       band_responses=jnp.asarray(resp))),
    }
    for name, (fn, jfn) in cases.items():
        val, grad = _value_and_grad(fn, achieved)
        jval, jgrad = _jax_value_and_grad(jfn, achieved)
        errs[name] = (abs(val - jval) / abs(jval), rel_l2(grad, jgrad))
    num, den = _ringing_cascades(2, 3, 5, seed=4)
    num_t = torch.tensor(num, requires_grad=True)
    val = reg_loss(num_t, torch.from_numpy(den), 400)
    val.backward()
    jval, jgrad = jax.value_and_grad(lambda n: jlosses.reg_loss(
        n, jnp.asarray(den), 400))(jnp.asarray(num))
    errs["reg"] = (abs(float(val.detach()) - float(jval)) / abs(float(jval)),
                   rel_l2(num_t.grad.numpy(), np.asarray(jgrad)))
    record_property("value_rel_and_grad_rel_l2", errs)
    for name, (v, g) in errs.items():
        assert v <= LOSS_TOL and g <= GRAD_TOL, (name, v, g)


def _ringing_cascades(b: int, g: int, k: int, seed: int):
    """(num, den) (b, g, k, 3) float32 biquads with poles at radius 0.985-0.995,
    so that their impulse responses still ring in the last eighth of 400
    samples (far above float32's rounding of the irfft)."""
    rng = np.random.RandomState(seed)
    r = rng.uniform(0.985, 0.995, (b, g, k))
    theta = rng.uniform(0.1, 3.0, (b, g, k))
    den = np.stack([np.ones_like(r), -2.0 * r * np.cos(theta), r * r], axis=-1)
    return rng.randn(b, g, k, 3).astype(np.float32), den.astype(np.float32)


def test_trainer_step_and_adam_match_jax(tmp_path, record_property):
    m = option_models(tmp_path, OPTIONS, svf=True)
    errs = step_errors(m)
    assert set(errs["losses"]) >= {"edc_loss", "edr_loss", "reg_loss"}
    assert_step(errs, record_property)
    upd = adam_error(m, errs["ref_grads"])
    record_property("adam_update_max_abs_diff", upd)
    assert upd <= UPDATE_TOL


def _reg_loss_f64(num: np.ndarray, den: np.ndarray, n: int) -> float:
    """``reg_loss`` in float64 numpy: the cascades' responses, their irfft,
    the late / early sums and the softmax."""
    zinv = np.exp(-1j * np.linspace(0.0, np.pi, n // 2 + 1))
    num, den = num.astype(np.float64), den.astype(np.float64)
    resp = np.prod((num[..., 0:1] + num[..., 1:2] * zinv + num[..., 2:3] * zinv ** 2)
                   / (den[..., 0:1] + den[..., 1:2] * zinv + den[..., 2:3] * zinv ** 2), axis=-2)
    h = np.fft.irfft(resp, n, axis=-1)
    n0 = int(round(n / 8))
    gamma = np.abs(h[..., n - n0:]).sum(-1) / (np.abs(h[..., :n0]).sum(-1) + 1e-12)
    w = np.exp(gamma - gamma.max(-1, keepdims=True))
    return float(np.sum(w / w.sum(-1, keepdims=True) * gamma))


def test_reg_loss_over_500_ms_is_float32_rounding(tmp_path, record_property):
    """ROADMAP C19: at the narrow config's initial SVF heads the cascades
    decay within milliseconds. Over the default 500 ms (4000 samples at 8
    kHz) the late eighth is below float32's irfft rounding, so both
    packages' values are rounding, orders of magnitude above the float64
    value; over 20 ms (160 samples) both are within 1e-3 of it."""
    m = option_models(tmp_path, OPTIONS, svf=True)
    from diffgfdn_torch.data import arrays_from_room_dataset
    from diffgfdn_torch.training.trainer import upload_model_inputs

    data = upload_model_inputs(arrays_from_room_dataset(m.port_room), torch.device("cpu"))
    batch = {k: v if k in ("z_values", "mesh_2d") else v[:4] for k, v in data.items()}
    with torch.no_grad():
        head = m.model.output_filter_params(batch)
    num, den = head["biquad_num"].numpy(), head["biquad_den"].numpy()
    values = {}
    for n in (4000, 160):
        port = float(reg_loss(torch.from_numpy(num), torch.from_numpy(den), n))
        ref = float(jlosses.reg_loss(jnp.asarray(num), jnp.asarray(den), n))
        values[n] = (port, ref, _reg_loss_f64(num, den, n))
    record_property("reg_port_jax_float64", values)
    port, ref, f64 = values[4000]
    assert port > 1e3 * f64 and ref > 1e3 * f64
    port, ref, f64 = values[160]
    assert abs(port - f64) <= LOSS_TOL * f64 and abs(ref - f64) <= LOSS_TOL * f64
