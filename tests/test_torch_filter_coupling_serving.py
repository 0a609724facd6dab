"""FILTER coupling (ROADMAP A4) served and synthesized by the port against JAX.

The order-8 step of scalar heads as test_torch_filter_coupling.py holds the
SVF heads' (H, losses, gradients, one Adam step). The narrow config of
torch_port_helpers with FILTER coupling of the default order 32
(``pu_matrix_order``), both head kinds, nfft 2^12 at 8 kHz: RIRs served
by ``InferDiffGFDN`` from a JAX checkpoint within 1e-3
relative L2 and 0.01 dB of EDC over 0.5 s, and the time domain (the exact
filtered block path: the scalar gains as a stateless filter bank, the
polynomial feedback A(z)) within 1e-4 of JAX's peak.
"""

import pytest

from test_torch_filter_coupling import check_step_and_adam
from torch_option_parity import (
    EDC_TOL_DB,
    option_models,
    RIR_TOL,
    SERVE_NFFT,
    served_errors,
    TD_TOL,
    time_domain_error,
)

FILTER = {"feedback_loop_config": {"coupling_matrix_type": "filter_matrix"}}


def test_scalar_heads_step_and_adam_match_jax(tmp_path, record_property):
    check_step_and_adam(tmp_path, False, record_property)


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads_geq", "scalar_heads"])
def test_served_and_time_domain_match_jax(tmp_path, svf, record_property):
    m = option_models(tmp_path, FILTER, svf, nfft=SERVE_NFFT)
    assert m.model.feedback_loop.unit_vectors.shape == (3, 31)
    served = served_errors(m)
    td = time_domain_error(m)
    record_property("served", served)
    record_property("time_domain_max_abs_over_peak", td)
    assert served["rel_l2"] <= RIR_TOL and served["edc_db"] <= EDC_TOL_DB, served
    assert td <= TD_TOL
