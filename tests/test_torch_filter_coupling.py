"""FILTER coupling (ROADMAP A4) in the port against the JAX package.

The group coupling is an FIR paraunitary matrix (order ``pu_matrix_order``,
the default 32): A(z) is a polynomial in z^-1 and the loop is dense, so the
SVF-head model inverts the whole (F, 12, 12) loop (B1 / B2 on the card) and
the scalar-head model solves it (B5 / B6). The algebra of ``ops/unitary.py``
on JAX's own fixtures (tests/test_ops_unitary_sph.py: float64 equal, or
1e-6 in float32); the loop's P(z) on JAX's loop fixture (tests/test_models.py);
then the narrow config of torch_port_helpers with FILTER coupling, both head
kinds, with the colorless loss (its sparsity term; the spectral weight 0, C2):
H 1e-3 relative L2, the trainer's losses 1e-3 and gradients 1e-2, one Adam
step 1e-6. Scalar heads, serving and the time domain:
test_torch_filter_coupling_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffgfdn_torch.config.schema import CouplingMatrixType
from diffgfdn_torch.models import FeedbackLoop
from diffgfdn_torch.ops import unitary
from diffgfdn_tpu.config.schema import CouplingMatrixType as JaxCouplingMatrixType
from diffgfdn_tpu.models import FeedbackLoop as JaxFeedbackLoop
from diffgfdn_tpu.ops import unitary as junitary
from diffgfdn_tpu.ops.absorption import decay_times_to_gain_per_sample
from diffgfdn_tpu.ops.basic import get_frequency_samples
from torch_option_parity import adam_error, assert_step, option_models, step_errors, UPDATE_TOL
from torch_port_helpers import rel_l2

OPS_TOL = 1e-6  # float32 ops, max abs error
# order 8, as JAX's loop fixture (the order-32 default is served in
# test_torch_filter_coupling_serving.py): JAX's compile of the step grows with it
FILTER = {"feedback_loop_config": {"coupling_matrix_type": "filter_matrix", "pu_matrix_order": 8},
          "trainer_config": {"use_colorless_loss": True, "spectral_loss_weight": 0.0}}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_paraunitary_algebra_matches_jax(record_property):
    """JAX's fixtures: fir_paraunitary (n 3, order 8 and 6), the Householder
    factor, the polynomial product and conjugate (float64), the checks and
    the frequency response."""
    errs = {}
    for seed, order in ((2, 8), (4, 6)):
        rng = np.random.RandomState(seed)
        x = rng.randn(3, 3).astype(np.float32)
        v = rng.randn(3, order - 1).astype(np.float32)
        v = v / np.linalg.norm(v, axis=0, keepdims=True)
        ju0 = junitary.orthogonal_from_skew(jnp.asarray(x))
        u0 = unitary.orthogonal_from_skew(_t(x))
        errs[f"u0_{order}"] = float(np.abs(u0.numpy() - np.asarray(ju0)).max())
        poly = unitary.fir_paraunitary(_t(ju0), _t(v))
        jpoly = np.asarray(junitary.fir_paraunitary(ju0, jnp.asarray(v)))
        assert poly.shape == (order, 3, 3)
        errs[f"fir_{order}"] = float(np.abs(poly.numpy() - jpoly).max())
        ok, err = unitary.is_paraunitary(poly, max_tol=1e-4)
        jok, jerr = junitary.is_paraunitary(jnp.asarray(jpoly), max_tol=1e-4)
        assert ok and jok and abs(err - jerr) <= OPS_TOL
        z = np.exp(1j * np.linspace(0.1, 3.0, 7)).astype(np.complex64)
        resp = unitary.paraunitary_frequency_response(_t(jpoly), _t(z)).numpy()
        jresp = np.asarray(junitary.paraunitary_frequency_response(jnp.asarray(jpoly),
                                                                   jnp.asarray(z)))
        errs[f"resp_{order}"] = float(np.abs(resp - jresp).max())
        for f in range(7):
            assert unitary.is_unitary(_t(resp[f]), max_tol=1e-4)[0]
        errs[f"householder_{order}"] = float(np.abs(
            unitary.householder_pu_factor(_t(v[:, 0])).numpy()
            - np.asarray(junitary.householder_pu_factor(jnp.asarray(v[:, 0])))).max())
    rng = np.random.RandomState(3)
    a, b = rng.randn(3, 2, 4), rng.randn(5, 4, 2)
    conv = unitary.matrix_convolution(_t(a), _t(b)).numpy()
    with jax.enable_x64(True):
        jconv = np.asarray(junitary.matrix_convolution(jnp.asarray(a), jnp.asarray(b)))
        jconj = np.asarray(junitary.hermitian_conjugate_polynomial_matrix(jnp.asarray(a)))
    np.testing.assert_array_equal(conv, jconv)
    np.testing.assert_array_equal(
        unitary.hermitian_conjugate_polynomial_matrix(_t(a)).numpy(), jconj)
    record_property("max_abs_err", errs)
    assert max(errs.values()) <= OPS_TOL, errs


def test_filter_loop_matches_jax(record_property):
    """JAX's loop fixture (6 lines in 3 groups at 16 kHz, scalar gains):
    the coupled (8, 6, 6) polynomial and P(z) at 16 bins, the JAX loop's
    initial parameters carried over."""
    fs, delays, t60s = 16000.0, (233, 311, 421, 461, 587, 613), (0.25, 0.45, 0.35)
    gains = np.concatenate([decay_times_to_gain_per_sample(t, np.asarray(delays[2 * k:2 * k + 2]),
                                                           fs) for k, t in enumerate(t60s)])
    jloop = JaxFeedbackLoop(sample_rate=fs, num_groups=3, num_delay_lines_per_group=2,
                            delays=delays, coupling_matrix_type=JaxCouplingMatrixType.FILTER,
                            coupling_matrix_order=8, gains=gains)
    z = get_frequency_samples(16)
    params = jloop.init(jax.random.PRNGKey(1), z)
    p_ref = np.asarray(jloop.apply(params, z))
    a_ref = np.asarray(jloop.apply(params, method=JaxFeedbackLoop.coupled_feedback_matrix))
    loop = FeedbackLoop(3, 2, delays, coupling_matrix_type=CouplingMatrixType.FILTER,
                        coupling_matrix_order=8, gains=gains)
    assert {n: tuple(p.shape) for n, p in loop.named_parameters()} == {
        "M": (3, 2, 2), "unit_vectors": (3, 7), "unitary_matrix": (3, 3)}
    loop.load_state_dict({k: _t(v) for k, v in params["params"].items()})
    with torch.no_grad():
        a = loop.coupled_feedback_matrix().numpy()
        p = loop(_t(np.asarray(z))).numpy()
    assert a.shape == (8, 6, 6) and not loop.is_block_diagonal
    a_err, p_err = float(np.abs(a - a_ref).max()), rel_l2(p, p_ref)
    record_property("coupled_matrix_max_abs_err", a_err)
    record_property("p_rel_l2", p_err)
    assert a_err <= OPS_TOL and p_err <= 1e-4


def check_step_and_adam(tmp_path, svf: bool, record_property) -> None:
    """One trainer step and one Adam step of the order-8 FILTER model against JAX."""
    m = option_models(tmp_path, FILTER, svf)
    fl = m.model.feedback_loop
    assert fl.coupling_matrix_type is CouplingMatrixType.FILTER and fl.unit_vectors.shape == (3, 7)
    errs = step_errors(m)
    assert set(errs["losses"]) >= {"spectral_loss", "sparsity_loss"}
    assert_step(errs, record_property)
    upd = adam_error(m, errs["ref_grads"])
    record_property("adam_update_max_abs_diff", upd)
    assert upd <= UPDATE_TOL


def test_step_and_adam_match_jax(tmp_path, record_property):
    """SVF heads with GEQ absorption (scalar heads: the serving file)."""
    check_step_and_adam(tmp_path, True, record_property)
