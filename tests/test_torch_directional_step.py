"""The directional trainer at ambi order 2 (9 x 9 blocks) against the JAX
package, and the port's step: one sub-FDN inverse a step, the DC bin of odd
groups skipped (ROADMAP C10). Bounds as test_torch_directional_losses.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_module
from diffgfdn_torch.training import make_optimizer
from diffgfdn_torch.training.trainer import sub_fdn_bins
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from test_torch_directional_losses import _trainers, check_trainer_losses_and_gradients, IDX
from test_torch_directional_losses import rooms  # noqa: F401 (the module fixture)


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
def test_trainer_losses_and_gradients_match_jax_at_order_2(tmp_path, rooms, mask,
                                                           record_property):
    check_trainer_losses_and_gradients(tmp_path, rooms, 2, mask, record_property)


def test_step_evaluates_the_sub_fdn_inverse_once(tmp_path, rooms, monkeypatch):
    """A step's per-step normalization and colorless loss share one sub-FDN
    inverse (one call of B1's wrapper a step, with B2 behind it), and the
    step equals the normalization and loss evaluated separately."""
    _, _, trainer, cfg = _trainers(tmp_path, rooms, 2, False)
    _, _, twin, _ = _trainers(tmp_path, rooms, 2, False)
    for t in (trainer, twin):
        t.optimizer, t.scheduler = make_optimizer(cfg.trainer_config, t.model, 1)
    calls = []
    inner = cinv_module.cinv
    monkeypatch.setattr(cinv_module, "cinv", lambda m: calls.append(m.shape) or inner(m))
    idx = torch.from_numpy(IDX)
    total, _ = trainer.fit_step(idx)
    assert len(calls) == 1 and calls[0][0] == 3 * (trainer.data["z_values"].shape[0] - 1)
    twin._normalize_params()
    ref, _ = twin.loss_and_grads(twin.gather(idx))
    twin.optimizer.step()
    assert len(calls) == 3  # the separate normalization and loss invert twice
    assert torch.equal(total, ref)
    for (name, p), q in zip(trainer.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p, q), name


def test_sub_fdn_terms_skip_the_dc_bin_of_odd_groups(tmp_path, rooms):
    """ROADMAP C10: every exp(skew(M)) of odd order has the eigenvalue 1, so
    the lossless 9-line loops are singular at z = 1; JAX's inverse there is
    set by rounding (orders of magnitude above every other bin). The port's
    trainer evaluates the sub-FDN terms without that bin for odd groups."""
    jtrainer, params, trainer, _ = _trainers(tmp_path, rooms, 2, False)
    z = trainer.data["z_values"]
    assert trainer.model.num_delay_lines_per_group == 9
    assert torch.equal(sub_fdn_bins(trainer.model, z), z[1:])
    h, _ = jtrainer.model.apply(params, jnp.asarray(z.numpy()), method=JaxDiffGFDN.sub_fdn_output)
    h = np.abs(np.asarray(h))
    assert h[0].min() > 1e3 * np.median(h)
    even = type("Even", (), {"num_delay_lines_per_group": 4})()
    assert sub_fdn_bins(even, z) is z
