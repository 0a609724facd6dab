"""The port's ``analysis.py`` against the JAX package's on the CPU.

Every function on seeded inputs, including the cases of
``tests/test_cli_and_analysis.py``: both copies run the same float64 numpy
and scipy on their own ``ops`` (``basic``, ``filterbanks``, ``geq``), so each
output must agree within 1e-10 of the reference's largest magnitude (the
bound; the measured error is recorded).
"""

import numpy as np
import pytest

from diffgfdn_torch import analysis as port
from diffgfdn_tpu import analysis as ref
from diffgfdn_tpu.ops.basic import LOG10E6

FS = 8000.0
BANDS = [125.0, 250.0, 500.0, 1000.0, 2000.0]
TOL = 1e-10


def _cs_rir(t60s, amps, n, fs=FS, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    env = sum(a * np.exp(-t * LOG10E6 / T) for a, T in zip(amps, t60s))
    return rng.randn(n) * np.sqrt(env)


def _close(got, want, record_property, name="max_rel") -> None:
    """Every array of (possibly nested tuples of) outputs within TOL of the
    reference's largest magnitude."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, record_property, name)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) / scale if scale > 0 else float(np.abs(got).max())
    record_property(name, err)
    assert err <= TOL


@pytest.mark.parametrize("get_ir", [False, True])
def test_octave_filtering(record_property, get_ir):
    x = _cs_rir([0.15, 0.35], [1.0, 0.3], 4096)
    _close(port.octave_filtering(x, FS, BANDS, get_filter_ir=get_ir),
           ref.octave_filtering(x, FS, BANDS, get_filter_ir=get_ir), record_property)


@pytest.mark.parametrize("axis", [0, -1])
def test_schroeder_edc(record_property, axis):
    x = np.random.RandomState(1).randn(300, 4)
    _close(port.schroeder_edc(x, axis=axis), ref.schroeder_edc(x, axis=axis), record_property)


@pytest.mark.parametrize("noise", [True, False])
def test_calculate_amplitudes_least_squares(record_property, noise):
    t60s = np.array([0.15, 0.35])
    rir = _cs_rir(t60s, [1.0, 0.3], 4096)
    filtered = ref.octave_filtering(rir, FS, BANDS)
    cdt = np.stack([t60s * (1.0 + 0.1 * b) for b in range(len(BANDS))], axis=1)
    for decays in (t60s, cdt):
        _close(port.calculate_amplitudes_least_squares(decays, FS, filtered, BANDS,
                                                       include_noise_term=noise),
               ref.calculate_amplitudes_least_squares(decays, FS, filtered, BANDS,
                                                      include_noise_term=noise),
               record_property)


@pytest.mark.parametrize("n", [4096, 4097])
def test_get_amps_for_rir(record_property, n):
    """Both parities of the truncated length (the odd one drops a sample)."""
    rir = _cs_rir([0.2], [1.0], n)
    _close(port.get_amps_for_rir(rir, np.array([0.2]), BANDS, FS),
           ref.get_amps_for_rir(rir, np.array([0.2]), BANDS, FS), record_property)


def test_edc_design_matrix(record_property):
    t = np.arange(500) / FS
    ramp = np.linspace(500, 1, 500)
    for args in ((t, np.array([0.1, 0.4])), (t, 0.3, ramp)):
        _close(port._edc_design_matrix(*args), ref._edc_design_matrix(*args), record_property)


@pytest.mark.parametrize("refine", [True, False])
def test_fit_edc_fixed_order(record_property, refine):
    """The noiseless two-exponential EDC of JAX's own test."""
    t = np.arange(int(1.0 * FS)) / FS
    edc = np.exp(-t * LOG10E6 / 0.1) + 1e-2 * np.exp(-t * LOG10E6 / 0.5)
    grid = np.geomspace(0.05, 3.0, 14)
    _close(port._fit_edc_fixed_order(edc, t, 2, grid, refine=refine),
           ref._fit_edc_fixed_order(edc, t, 2, grid, refine=refine), record_property)


@pytest.mark.parametrize("case", ["one_slope", "two_slopes", "auto_order", "noise_floor"])
def test_estimate_decay_params(record_property, case):
    """The single- and two-slope fits, the order selection and the noise
    floor of JAX's tests."""
    if case == "one_slope":
        rir, kw = _cs_rir([0.25], [1.0], 8192), dict(
            n_slopes=1, f_bands=[500.0, 1000.0], t60_grid=np.array([0.1, 0.18, 0.25, 0.35, 0.5]))
    elif case == "two_slopes":
        rir, kw = _cs_rir([0.1, 0.5], [1.0, 1e-2], 8000), dict(
            n_slopes=2, f_bands=[500.0, 2000.0])
    elif case == "auto_order":
        rir, kw = _cs_rir([0.1, 0.5], [1.0, 1e-2], 8000, seed=2), dict(
            n_slopes=0, f_bands=[1000.0], max_slopes=2)
    else:
        rir = _cs_rir([0.12], [1.0], 12000, seed=7)
        rir = rir + 3e-3 * np.random.RandomState(7).randn(len(rir))
        kw = dict(n_slopes=1, f_bands=[1000.0])
    n = kw.pop("n_slopes")
    _close(port.estimate_decay_params(rir, n, FS, **kw),
           ref.estimate_decay_params(rir, n, FS, **kw), record_property)


def test_estimate_edc_parameters(record_property):
    rir = _cs_rir([0.1, 0.4], [1.0, 3e-2], 8000, seed=4)
    _close(port.estimate_edc_parameters(rir, [500.0, 1000.0], n_slopes=2, fs=FS),
           ref.estimate_edc_parameters(rir, [500.0, 1000.0], n_slopes=2, fs=FS),
           record_property)


@pytest.mark.parametrize("norm", [False, True])
def test_amplitudes_to_initial_level(record_property, norm):
    rng = np.random.RandomState(5)
    bands = len(ref.octave_bands(end_freq=4000.0))
    decays = rng.uniform(0.2, 1.5, (bands, 2))
    amps = rng.uniform(0.01, 1.0, (bands, 2))
    norm_vals = rng.uniform(0.5, 2.0, (bands, 1)) if norm else None
    kw = dict(max_freq=4000.0, norm_vals=norm_vals)
    _close(port.amplitudes_to_initial_level(decays, amps, FS, 2048, **kw),
           ref.amplitudes_to_initial_level(decays, amps, FS, 2048, **kw), record_property)
