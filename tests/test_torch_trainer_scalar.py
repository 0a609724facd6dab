"""The trainer's losses and gradients against JAX, scalar heads (EDC and EDR).

The same check and bounds as test_torch_trainer.py (total and each term
<= 1e-3 relative, every gradient leaf <= 1e-2 relative L2), with and
without the EDC mask; kept apart so that each file stays short.
"""

import pytest

from test_torch_trainer import check_losses_and_gradients


@pytest.mark.parametrize("mask", [False, True], ids=["scalar", "scalar_mask"])
def test_losses_and_gradients_match_jax(tmp_path, mask, record_property):
    check_losses_and_gradients(tmp_path, False, mask, record_property)
