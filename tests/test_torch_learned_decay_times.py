"""Learnable common decay times (ROADMAP A7) in the port against the JAX package.

``decay_filter_config.learn_common_decay_times``: each group's T60 is a
``feedback_loop.common_decay_times`` parameter whose per-line gains
(``ops/absorption.decay_times_to_gain_per_sample`` on tensors) carry its
gradient. Checked against JAX:

* ``absorption_arrays``: per-band decay times (bands, groups) start each
  group at its mean over the bands, broadband ones as given, equal to JAX's;
  with no decay times the init is U(0.1, 2.0), the leaf JAX's (G,);
* the gains and their gradient through the tensor branch (float32, 1e-6);
* the narrow config with SVF heads (per-band decay times): H 1e-3 relative
  L2, the trainer's losses 1e-3 and gradients 1e-2 (the decay times' among
  them), one Adam step 1e-6 (the new leaf labelled "other", as in JAX);
* scalar heads: RIRs served from a JAX checkpoint 1e-3 / 0.01 dB, the time
  domain (B7's plain version on the learned gains) 1e-4 of JAX's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.ops.absorption import decay_times_to_gain_per_sample
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.training.build import absorption_arrays
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.ops.absorption import decay_times_to_gain_per_sample as jax_gains
from diffgfdn_tpu.training.build import absorption_arrays as jax_absorption_arrays
from torch_option_parity import (
    adam_error,
    assert_step,
    EDC_TOL_DB,
    option_models,
    RIR_TOL,
    SERVE_NFFT,
    served_errors,
    step_errors,
    TD_TOL,
    time_domain_error,
    UPDATE_TOL,
)
from torch_port_helpers import raw_config

OPS_TOL = 1e-6
LEARN = {"decay_filter_config": {"learn_common_decay_times": True}}


def test_absorption_arrays_and_gains_match_jax(tmp_path, record_property):
    raw = raw_config(tmp_path, svf=True)
    raw["decay_filter_config"]["learn_common_decay_times"] = True
    cfg, jcfg = DiffGFDNConfig.from_dict(raw), JaxDiffGFDNConfig.model_validate(raw)
    per_band = np.array([[1.0, 1.5, 1.2], [0.8, 1.1, 1.0], [0.6, 0.9, 0.7]])
    for cdt in (per_band, per_band[0], None):
        got = absorption_arrays(cfg, cdt, None)
        want = jax_absorption_arrays(jcfg, cdt, None)
        assert got == want and got["learn_common_decay_times"]
    assert absorption_arrays(cfg, per_band, None)["common_decay_times_init"] == tuple(
        per_band.mean(axis=0))
    model = build_gfdn_model(cfg, None, device="cpu")
    t0 = model.feedback_loop.common_decay_times.detach()
    assert t0.shape == (3,) and bool(((t0 >= 0.1) & (t0 <= 2.0)).all())
    delays = np.asarray(cfg.delay_length_samps, np.float32).reshape(3, 4)
    t = torch.tensor([0.7, 1.3, 0.9], requires_grad=True)
    g = decay_times_to_gain_per_sample(t[:, None], torch.from_numpy(delays), 8000.0)
    g.sum().backward()
    jg, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(jax_gains(x[:, None], jnp.asarray(delays), 8000.0)))(
            jnp.asarray([0.7, 1.3, 0.9], jnp.float32))
    gain_err = float(np.abs(g.detach().numpy().sum() - float(jg)))
    grad_err = float(np.abs(t.grad.numpy() - np.asarray(jgrad)).max())
    np.testing.assert_array_equal(
        decay_times_to_gain_per_sample(0.7, delays[0], 8000.0),
        np.asarray(jax_gains(0.7, delays[0], 8000.0)))
    record_property("gain_sum_abs_err", gain_err)
    record_property("gain_grad_max_abs_err", grad_err)
    assert gain_err <= OPS_TOL * 12 and grad_err <= OPS_TOL


def test_step_and_adam_match_jax(tmp_path, record_property):
    m = option_models(tmp_path, LEARN, svf=True)
    fl = m.model.feedback_loop
    assert fl.learn_common_decay_times and not fl.use_absorption_filters
    np.testing.assert_allclose(fl.common_decay_times.detach().numpy(),
                               np.asarray(m.port_room.common_decay_times).mean(axis=0),
                               rtol=1e-6)
    errs = step_errors(m)
    assert "['params']['feedback_loop']['common_decay_times']" in errs["grads"]
    assert_step(errs, record_property)
    upd = adam_error(m, errs["ref_grads"])
    record_property("adam_update_max_abs_diff", upd)
    assert upd <= UPDATE_TOL


def test_served_and_time_domain_match_jax(tmp_path, record_property):
    m = option_models(tmp_path, LEARN, svf=False, nfft=SERVE_NFFT)
    served = served_errors(m)
    td = time_domain_error(m)
    record_property("served", served)
    record_property("time_domain_max_abs_over_peak", td)
    assert served["rel_l2"] <= RIR_TOL and served["edc_db"] <= EDC_TOL_DB, served
    assert td <= TD_TOL
