"""Warped-Prony IIR absorption (ROADMAP A4) in the port against the JAX package.

* ``ops/prony.py`` is a copy of JAX's: its fits equal JAX's in float64 on
  JAX's fixtures (tests/test_ops_filters.py), and so do
  ``decay_times_to_gain_filters_prony`` and ``absorption_arrays(use_prony=True)``;
* ``ops/biquad.py iir_frequency_response`` (Horner in z^-1, complex64)
  within 1e-6 of JAX's on JAX's Butterworth fixture;
* the feedback loop with ``iir_coeffs`` on JAX's loop fixture
  (tests/test_absorption_filters_path.py): P(z) within 1e-4 relative L2;
* a GFDN built from ``absorption_arrays(use_prony=True)`` (no config
  selects it: both packages' ``build_gfdn_model`` call it without
  ``use_prony``, so the test patches it in both, as a caller would build
  the model): served RIRs from a JAX checkpoint within 1e-3 relative L2
  and 0.01 dB, the time domain (``filter_bank_from_iir``) within 1e-4 of
  JAX's peak.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as sig
import torch

from diffgfdn_torch.ops import absorption, prony
from diffgfdn_torch.ops.biquad import iir_frequency_response
from diffgfdn_torch.models import FeedbackLoop
from diffgfdn_torch.training import build
from diffgfdn_tpu.config.schema import CouplingMatrixType as JaxCouplingMatrixType
from diffgfdn_tpu.models import FeedbackLoop as JaxFeedbackLoop
from diffgfdn_tpu.ops import absorption as jabsorption
from diffgfdn_tpu.ops import biquad as jbiquad
from diffgfdn_tpu.ops import prony as jprony
from diffgfdn_tpu.ops.basic import get_frequency_samples
from diffgfdn_tpu.training import build as jbuild
from torch_option_parity import (
    EDC_TOL_DB,
    option_models,
    RIR_TOL,
    SERVE_NFFT,
    served_errors,
    TD_TOL,
    time_domain_error,
)
from torch_port_helpers import rel_l2

OPS_TOL = 1e-6
FS = 8000.0
DELAYS = (499, 601, 727, 809)
BANDS = np.array([125.0, 250.0, 500.0, 1000.0, 2000.0])


def test_prony_fits_equal_jax():
    b_true, a_true = sig.butter(4, 0.25)
    h = sig.lfilter(b_true, a_true, np.eye(1, 256)[0])
    for got, want in zip(prony.prony(h, 4, 4), jprony.prony(h, 4, 4)):
        np.testing.assert_array_equal(got, want)
    fs, n_fft = 32000.0, 1024
    freqs = np.array([63.0, 125, 250, 500, 1000, 2000, 4000, 8000])
    mags = np.linspace(1.0, 0.4, len(freqs))
    kw = dict(cutoff=(20, fs / 2 - 4e3), rolloff_dc_db=-60, rolloff_nyq_db=-100)
    interp, _ = prony.interpolate_magnitude_spectrum(mags, freqs, fs, n_fft, **kw)
    jinterp, _ = jprony.interpolate_magnitude_spectrum(mags, freqs, fs, n_fft, **kw)
    np.testing.assert_array_equal(interp, jinterp)
    ir = prony.tf2minphase(interp, is_time_domain=True)
    np.testing.assert_array_equal(ir, jprony.tf2minphase(jinterp, is_time_domain=True))
    for got, want in zip(prony.prony_warped(ir, fs, 8, 8), jprony.prony_warped(ir, fs, 8, 8)):
        np.testing.assert_array_equal(got, want)
    t60 = np.linspace(0.5, 0.25, len(BANDS))
    np.testing.assert_array_equal(
        absorption.decay_times_to_gain_filters_prony(BANDS, t60, DELAYS, FS),
        jabsorption.decay_times_to_gain_filters_prony(BANDS, t60, DELAYS, FS))


def test_iir_response_and_loop_match_jax(record_property):
    b, a = sig.butter(4, 0.3)
    w, _ = sig.freqz(b, a, worN=64)
    z = np.exp(1j * w)
    h = iir_frequency_response(torch.from_numpy(b), torch.from_numpy(a), torch.from_numpy(z))
    jh = np.asarray(jbiquad.iir_frequency_response(jnp.asarray(b), jnp.asarray(a),
                                                   jnp.asarray(z)))
    resp_err = float(np.abs(h.numpy() - jh).max())
    coeffs = absorption.decay_times_to_gain_filters_prony(
        BANDS, np.linspace(0.5, 0.25, len(BANDS)), DELAYS, FS, filter_order=8,
        num_freq_bins=1024)
    jloop = JaxFeedbackLoop(sample_rate=FS, num_groups=2, num_delay_lines_per_group=2,
                            delays=DELAYS, coupling_matrix_type=JaxCouplingMatrixType.SCALAR,
                            iir_coeffs=coeffs)
    zs = get_frequency_samples(129)
    params = jloop.init(jax.random.PRNGKey(0), zs)
    p_ref = np.asarray(jloop.apply(params, zs))
    loop = FeedbackLoop(2, 2, DELAYS, iir_coeffs=coeffs)
    assert loop.use_absorption_filters and loop.iir_coeffs_host is not None
    loop.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params["params"].items()})
    with torch.no_grad():
        p = loop(torch.from_numpy(np.asarray(zs))).numpy()
    p_err = rel_l2(p, p_ref)
    record_property("iir_response_max_abs_err", resp_err)
    record_property("loop_p_rel_l2", p_err)
    assert resp_err <= OPS_TOL and p_err <= 1e-4


def test_prony_model_served_and_time_domain_match_jax(tmp_path, monkeypatch, record_property):
    for mod in (build, jbuild):
        monkeypatch.setattr(mod, "absorption_arrays",
                            functools.partial(mod.absorption_arrays, use_prony=True))
    m = option_models(tmp_path, {"decay_filter_config": {"use_absorption_filters": True}},
                      svf=False, nfft=SERVE_NFFT, rooms_hook=_per_band)
    fl = m.model.feedback_loop
    assert fl.iir_coeffs is not None and fl.sos_coeffs is None
    assert m.jmodel.iir_coeffs is not None
    np.testing.assert_array_equal(fl.iir_coeffs_host, np.asarray(m.jmodel.iir_coeffs))
    served = served_errors(m)
    td = time_domain_error(m)
    record_property("served", served)
    record_property("time_domain_max_abs_over_peak", td)
    assert served["rel_l2"] <= RIR_TOL and served["edc_db"] <= EDC_TOL_DB, served
    assert td <= TD_TOL


def _per_band(jax_room, port_room):
    """Per-band decay times on both datasets (filters are fitted to them),
    with scalar heads."""
    cdt = np.stack([np.array((1.0, 1.5, 1.2))] * 4) * np.linspace(1.2, 0.8, 4)[:, None]
    for room in (jax_room, port_room):
        room.common_decay_times = cdt
        room.band_centre_hz = [250.0, 500.0, 1000.0, 2000.0]


def test_time_domain_against_the_float64_frequency_path(tmp_path, monkeypatch, record_property):
    """ROADMAP C19: the served frequency path evaluates the order-8 IIR
    responses by Horner in complex64 from float32 coefficients, as the JAX
    package does; with them in complex128 from the float64 design, the exact
    time domain (decays near 0.5 s, 8192 samples, C5) agrees with the
    frequency path within 2e-3 of the peak and 0.01 dB of EDC over 0.5 s.
    The complex64 path's own error is recorded beside it."""
    from diffgfdn_torch.inference import make_rir_synthesis_fn, make_time_domain_synthesis_fn
    from diffgfdn_torch.models import feedback_loop as fl_mod
    from torch_port_helpers import edc_db

    monkeypatch.setattr(build, "absorption_arrays",
                        functools.partial(build.absorption_arrays, use_prony=True))
    m = option_models(tmp_path, {"decay_filter_config": {"use_absorption_filters": True}},
                      svf=False, nfft=8192, rooms_hook=_half_second)
    model, room = m.model, m.port_room
    batch = {"listener_position": torch.from_numpy(room.receiver_position[:4].astype(np.float32)),
             "norm_listener_position": torch.from_numpy(
                 room.norm_receiver_position[:4].astype(np.float32))}
    td = make_time_domain_synthesis_fn(model, 8192)(batch).numpy()
    z = torch.from_numpy(np.exp(1j * np.linspace(0.0, np.pi, 4097)).astype(np.complex64))
    served = make_rir_synthesis_fn(model)({**batch, "z_values": z}).numpy()
    fl = model.feedback_loop
    fl.iir_coeffs = torch.as_tensor(fl.iir_coeffs_host, dtype=torch.float64)
    monkeypatch.setattr(fl_mod, "iir_frequency_response", functools.partial(
        fl_mod.iir_frequency_response, dtype=torch.complex128))
    wide = make_rir_synthesis_fn(model)({**batch, "z_values": z}).numpy()
    half = int(0.5 * FS)
    errs = {name: (float(np.abs(td - f).max() / np.abs(f).max()),
                   float(np.abs(edc_db(td) - edc_db(f))[:, :half].max()))
            for name, f in (("complex128", wide), ("complex64", served))}
    record_property("max_abs_over_peak_and_edc_db", errs)
    assert errs["complex128"][0] <= 2e-3 and errs["complex128"][1] <= 0.01, errs


def _half_second(jax_room, port_room):
    """Per-band decay times near 0.5 s (the time domain and the frequency
    path then agree within the float32 floor of the irfft, C5)."""
    cdt = np.stack([np.array((0.45, 0.55, 0.5))] * 4) * np.linspace(1.1, 0.9, 4)[:, None]
    for room in (jax_room, port_room):
        room.common_decay_times = cdt
        room.band_centre_hz = [250.0, 500.0, 1000.0, 2000.0]
