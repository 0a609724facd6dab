"""The backward plain versions B2 and B6 at the directional size N = 27.

Same inputs and bound as test_torch_backward_kernels.py (max abs error
<= 1e-4 max |ref| against the Pallas backward in interpret mode); kept
apart because interpreting the unrolled N = 27 Pallas kernels takes most of
the time.
"""

from test_torch_backward_kernels import lut_apply_vs_pallas, neg_ptgpt_vs_pallas
from torch_port_helpers import KERNEL_TOL as TOL

N, K = 27, 70


def test_neg_ptgpt_plain_matches_pallas_n27(record_property):
    err = neg_ptgpt_vs_pallas(N, K)
    record_property("max_rel", err)
    assert err <= TOL


def test_lut_apply_plain_matches_pallas_n27(record_property):
    err = lut_apply_vs_pallas(N, K)
    record_property("max_rel", err)
    assert err <= TOL
