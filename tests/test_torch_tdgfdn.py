"""The port's time-domain GFDN core against the JAX package's, on the CPU.

``diffgfdn_torch.kernels.tdgfdn`` vs ``diffgfdn_tpu.kernels.tdgfdn`` on the
same numpy inputs: the broadband recursion (plain version of kernel B7)
against the JAX scan and the Pallas kernel in interpret mode, the exact
filtered path (SOS, IIR and gains banks; static and polynomial feedback),
the host filter-bank constants, and the synthesis helpers built on them.
Bounds: 1e-5 max |y| for the recursions (float32, sums in other orders);
the bank constants are the same float64 numpy in both packages, so they
must agree to 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import tdgfdn as td
from diffgfdn_torch.kernels.dispatch import plain_versions
from diffgfdn_torch.ops.absorption import (
    decay_times_to_gain_filters_geq,
    decay_times_to_gain_per_sample,
)
from diffgfdn_tpu.kernels import tdgfdn as jtd

TOL = 1e-5
SMALL = (37, 41, 43, 53)
# 12 lines spanning ~50k samples: the JAX Pallas path has no VMEM room for it
WIDE = tuple(int(d) for d in np.linspace(100, 50000, 12).astype(int))


def _loop(delays, seed):
    n = len(delays)
    rng = np.random.RandomState(seed)
    a = (np.linalg.qr(rng.randn(n, n))[0] * 0.999).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    if delays == WIDE:
        gains = np.full(n, 0.9995, np.float32)
    else:
        gains = np.asarray(decay_times_to_gain_per_sample(0.08, np.asarray(delays), 4000.0))
    return gains, a, b


def _signal(kind: str, t_len: int, seed: int) -> np.ndarray:
    if kind == "impulse":
        u = np.zeros(t_len, np.float32)
        u[0] = 1.0
        return u
    return np.random.RandomState(seed).randn(t_len).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _max_rel(a, ref) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _simulate(delays, gains, a, b, u):
    """Sample-serial float64 recursion; delay-line outputs (T, N)."""
    n = len(delays)
    buf = np.zeros((n, max(delays)))
    y_out = np.zeros((len(u), n))
    for t in range(len(u)):
        y = np.array([gains[i] * buf[i, t % delays[i]] for i in range(n)])
        y_out[t] = y
        x = a.astype(np.float64) @ y + b * u[t]
        for i in range(n):
            buf[i, t % delays[i]] = x[i]
    return y_out


@pytest.mark.parametrize("delays,t_len", [(SMALL, 512), (WIDE, 2048)], ids=["small", "wide"])
@pytest.mark.parametrize("kind", ["impulse", "random"])
def test_plain_matches_jax_scan_and_pallas_kernel(delays, t_len, kind, record_property):
    gains, a, b = _loop(delays, seed=len(delays))
    u = _signal(kind, t_len, seed=3)
    y = td.delay_line_outputs(delays, *_t(gains, a, b, u)).numpy()
    args = (jnp.asarray(gains), jnp.asarray(a), jnp.asarray(b), jnp.asarray(u))
    ref_scan = np.asarray(jtd.delay_line_outputs(delays, *args))
    ref_pallas = np.asarray(jtd.delay_line_outputs_pallas(delays, *args, interpret=True))
    assert y.shape == ref_scan.shape == (t_len, len(delays))
    err_scan, err_pallas = _max_rel(y, ref_scan), _max_rel(y, ref_pallas)
    record_property("max_rel_vs_jax_scan", err_scan)
    record_property("max_rel_vs_jax_pallas", err_pallas)
    assert err_scan <= TOL and err_pallas <= TOL


def test_plain_matches_float64_sample_recursion():
    gains, a, b = _loop(SMALL, seed=4)
    u = _signal("random", 400, seed=5)
    y = td.delay_line_outputs(SMALL, *_t(gains, a, b, u)).numpy()
    ref = _simulate(SMALL, gains.astype(np.float64), a, b.astype(np.float64), u)
    assert _max_rel(y, ref) <= TOL


def test_wrapper_takes_the_plain_version_on_the_cpu():
    gains, a, b = _loop(SMALL, seed=6)
    u = _signal("random", 300, seed=7)
    before = td.delay_line_outputs.launches
    y = td.delay_line_outputs(SMALL, *_t(gains, a, b, u))
    with plain_versions():
        y_plain = td.delay_line_outputs_plain(SMALL, *_t(gains, a, b, u))
    assert td.delay_line_outputs.launches == before
    assert torch.equal(y, y_plain) and y.dtype == torch.float32


def test_wrapper_rejects_bad_shapes_and_mixed_devices():
    gains, a, b = _loop(SMALL, seed=8)
    u = _signal("impulse", 64, seed=0)
    g_t, a_t, b_t, u_t = _t(gains, a, b, u)
    with pytest.raises(ValueError, match="feedback matrix"):
        td.delay_line_outputs(SMALL, g_t, a_t[:3], b_t, u_t)
    with pytest.raises(ValueError, match="different devices"):
        td.delay_line_outputs(SMALL, g_t, a_t, b_t, u_t.to("meta"))


def test_block_size_matches_jax():
    for delays in (SMALL, WIDE, (640, 700, 1440), (1, 3), (1024, 2048), (2047,)):
        assert td._block_size(delays) == jtd._block_size(delays)


def _sos_bank_inputs(delays):
    return decay_times_to_gain_filters_geq(
        np.array([250.0, 500.0, 1000.0]), np.array([0.08, 0.1, 0.06]), np.asarray(delays), 4000.0
    )


def _iir_coeffs(n, seed):
    """(N, 3, 2) stable second-order IIRs with gain below 1."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 3, 2))
    for i in range(n):
        r, th = 0.5 + 0.3 * rng.rand(), np.pi * rng.rand()
        out[i, :, 1] = [1.0, -2 * r * np.cos(th), r * r]
        out[i, :, 0] = 0.2 * rng.randn(3) + [0.5, 0.0, 0.0]
    return out


BANKS = {
    "sos": (lambda d: td.filter_bank_from_sos(_sos_bank_inputs(d), d),
            lambda d: jtd.filter_bank_from_sos(_sos_bank_inputs(d), d)),
    "iir": (lambda d: td.filter_bank_from_iir(_iir_coeffs(len(d), 1), d),
            lambda d: jtd.filter_bank_from_iir(_iir_coeffs(len(d), 1), d)),
    "gains": (lambda d: td.filter_bank_from_gains(np.linspace(0.9, 0.97, len(d)), d),
              lambda d: jtd.filter_bank_from_gains(np.linspace(0.9, 0.97, len(d)), d)),
}


@pytest.mark.parametrize("kind", sorted(BANKS))
def test_bank_constants_match_jax(kind):
    bank, ref = (make(SMALL) for make in BANKS[kind])
    assert bank.block == ref.block == td._block_size(SMALL)
    for name in ("h", "p", "q", "tl"):
        got, want = getattr(bank, name), getattr(ref, name)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-7


@pytest.mark.parametrize(
    "kind,poly", [("sos", False), ("iir", False), ("gains", False), ("gains", True)],
    ids=["sos", "iir", "gains", "gains_polynomial"],
)
def test_filtered_path_matches_jax(kind, poly, record_property):
    bank = BANKS[kind][0](SMALL)
    rng = np.random.RandomState(2)
    a = (np.linalg.qr(rng.randn(4, 4))[0] * 0.999).astype(np.float32)
    if poly:  # (order, N, N) polynomial coupling
        a = (np.stack([a, 0.3 * rng.randn(4, 4), 0.2 * rng.randn(4, 4)]) / 1.6).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    u = _signal("impulse", 600, seed=0)
    y = td.delay_line_outputs_filtered(SMALL, bank, *_t(a, b, u)).numpy()
    ref = np.asarray(jtd.delay_line_outputs_filtered(
        SMALL, BANKS[kind][1](SMALL), jnp.asarray(a), jnp.asarray(b), jnp.asarray(u)))
    err = _max_rel(y, ref)
    record_property("max_rel_vs_jax", err)
    assert err <= TOL


def test_synthesis_helpers_match_jax():
    gains, a, b = _loop(SMALL, seed=9)
    rng = np.random.RandomState(10)
    c = rng.randn(5, 4).astype(np.float32)
    u = _signal("random", 300, seed=11)
    out = td.time_domain_gfdn(SMALL, *_t(gains, a, b, c, u), direct_gain=0.5).numpy()
    ref = np.asarray(jtd.time_domain_gfdn(
        SMALL, *(jnp.asarray(x) for x in (gains, a, b, c, u)), direct_gain=0.5))
    assert out.shape == (5, 300) and _max_rel(out, ref) <= TOL

    rirs = td.synthesize_rirs_time_domain(SMALL, *_t(gains, a, b, c), 512).numpy()
    ref = np.asarray(jtd.synthesize_rirs_time_domain(
        SMALL, *(jnp.asarray(x) for x in (gains, a, b, c)), 512, use_pallas=False))
    assert rirs.shape == (5, 512) and _max_rel(rirs, ref) <= TOL

    direct = rng.randn(5).astype(np.float32)
    rirs = td.synthesize_rirs_time_domain_filtered(
        SMALL, BANKS["sos"][0](SMALL), *_t(a, b, c), 512, direct_gains=torch.from_numpy(direct)
    ).numpy()
    ref = np.asarray(jtd.synthesize_rirs_time_domain_filtered(
        SMALL, BANKS["sos"][1](SMALL), *(jnp.asarray(x) for x in (a, b, c)), 512,
        direct_gains=jnp.asarray(direct)))
    assert _max_rel(rirs, ref) <= TOL


def test_filtered_path_rejects_a_block_longer_than_the_minimum_delay():
    bank = BANKS["gains"][0]((128, 130))
    with pytest.raises(ValueError, match="minimum delay"):
        td.delay_line_outputs_filtered((64, 130), bank, *_t(np.eye(2, dtype=np.float32),
                                                             np.ones(2, np.float32),
                                                             np.ones(8, np.float32)))
