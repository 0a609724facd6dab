"""The port's native streaming renderer (``diffgfdn_torch/native``): equal to
the JAX package's library, which is built from the same source; within 1e-4
of the port's block recursion (``kernels/tdgfdn.py``, whose plain version
runs here) and, with SOS absorption, within 5e-4 of its filtered recursion,
as tests/test_native.py holds the JAX library to JAX's core.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels.tdgfdn import (
    delay_line_outputs,
    delay_line_outputs_filtered,
    filter_bank_from_sos,
)
from diffgfdn_torch.native import native_available, NativeGFDNRenderer
from diffgfdn_torch.native import tdfdn as port_tdfdn
from diffgfdn_torch.ops.absorption import (
    decay_times_to_gain_filters_geq,
    decay_times_to_gain_per_sample,
)
from diffgfdn_tpu.native import NativeGFDNRenderer as JaxNativeGFDNRenderer

DELAYS = (163, 179, 191, 211, 223, 227)
FS = 8000.0
TD_TOL = 1e-4  # vs the block recursion, absolute (outputs of order 1)
FILTERED_TOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native_available():
        pytest.fail("the native renderer did not build (g++)")


def _setup(seed=0):
    rng = np.random.RandomState(seed)
    gains = []
    for k, t60 in enumerate((0.05, 0.08, 0.06)):
        d = np.asarray(DELAYS[2 * k : 2 * k + 2])
        gains.append(np.asarray(decay_times_to_gain_per_sample(t60, d, FS)))
    a = np.linalg.qr(rng.randn(6, 6))[0].astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    c = rng.randn(3, 6).astype(np.float32)
    return np.concatenate(gains).astype(np.float32), a, b, c


def _sos():
    return decay_times_to_gain_filters_geq(
        np.array([250.0, 500.0, 1000.0, 2000.0]), np.array([0.08, 0.07, 0.06, 0.05]),
        np.asarray(DELAYS), FS,
    )  # (6, 7, 3, 2)


def test_library_is_built_in_the_checkout():
    path = port_tdfdn.library_path()
    assert path.exists() and path.parent.parts[-2:] == ("build", "diffgfdn_torch_native")


def test_library_of_another_cpu_is_not_loaded(monkeypatch):
    """The digest covers the host's -march=native target: a library that
    another CPU built (in a copied checkout) sits under another name."""
    here = port_tdfdn.library_path()
    monkeypatch.setattr(port_tdfdn, "_native_target", lambda: b"another-cpu")
    assert port_tdfdn.library_path() != here
    assert port_tdfdn.library_path().parent == here.parent


@pytest.mark.parametrize("filtered", [False, True], ids=["scalar", "sos"])
def test_native_equals_the_jax_library(filtered):
    gains, a, b, c = _setup(1)
    u = np.random.RandomState(2).randn(3000).astype(np.float32)
    sos = _sos() if filtered else None
    got = NativeGFDNRenderer(DELAYS, None if filtered else gains, a, b, sos_coeffs=sos)
    want = JaxNativeGFDNRenderer(DELAYS, None if filtered else gains, a, b, sos_coeffs=sos)
    for block in (u[:1300], u[1300:]):  # the state carries across calls in both
        assert np.array_equal(got.process(block, c, direct_gain=0.3),
                              want.process(block, c, direct_gain=0.3))


def test_native_matches_the_block_recursion(record_property):
    gains, a, b, c = _setup()
    u = np.random.RandomState(1).randn(4000).astype(np.float32)
    y = delay_line_outputs(DELAYS, *(torch.from_numpy(x) for x in (gains, a, b, u)))
    ref = (y.numpy() @ c.T).T + 0.3 * u
    out = NativeGFDNRenderer(DELAYS, gains, a, b).process(u, c, direct_gain=0.3)
    err = float(np.abs(out - ref).max())
    record_property("max_abs_err", err)
    assert err <= TD_TOL


def test_native_filtered_absorption_matches_the_filtered_recursion(record_property):
    rng = np.random.RandomState(4)
    sos = _sos()
    a = np.linalg.qr(rng.randn(6, 6))[0].astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    c = rng.randn(2, 6).astype(np.float32)
    u = rng.randn(3000).astype(np.float32)
    y = delay_line_outputs_filtered(DELAYS, filter_bank_from_sos(sos, DELAYS),
                                    torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(u))
    ref = (y.numpy() @ c.T).T
    renderer = NativeGFDNRenderer(DELAYS, None, a, b, sos_coeffs=sos)
    out = renderer.process(u, c)
    err = float(np.abs(out - ref).max())
    record_property("max_abs_err", err)
    assert err <= FILTERED_TOL
    # streaming in blocks keeps the filter state; reset clears it
    streamed = NativeGFDNRenderer(DELAYS, None, a, b, sos_coeffs=sos)
    parts = [streamed.process(u[i : i + 640], c) for i in range(0, 3000, 640)]
    assert np.allclose(np.concatenate(parts, axis=-1), out, atol=1e-5)
    streamed.reset()
    assert np.array_equal(streamed.process(u, c), out)


def test_native_refuses_mismatched_shapes():
    gains, a, b, c = _setup()
    renderer = NativeGFDNRenderer(DELAYS, gains, a, b)
    with pytest.raises(ValueError):
        renderer.process(np.zeros(10, np.float32), c[:, :4])
    with pytest.raises(ValueError):
        renderer.set_absorption_sos(_sos()[:4])
    with pytest.raises(ValueError):
        NativeGFDNRenderer(DELAYS, gains[:4], a, b)
