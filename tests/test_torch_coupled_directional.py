"""The coupled directional model (ROADMAP A10: ``use_zero_coupling: false``
at ambi order 2) in the port against the JAX package.

Learned Givens angles couple the three 9-line groups, so the loop is one
dense 27 x 27 system per bin and the transposed drive q = P^T b runs as one
(F, 27, 27) solve (B5 / B6 on the card) instead of three 9 x 9 blocks. The
sub-FDN terms still take each group's own 9 x 9 loop, without the DC bin
(C10). Checked against JAX on the synthetic spatial dataset at 8 kHz
(directional_raw_config, 2 x 16 skip MLP):

* the directional trainer's losses 1e-3 relative and every gradient
  (the angles' among them) 1e-2 relative L2, the SH responses H 1e-3
  relative L2, one Adam step 1e-6 (the angles labelled "coupling"), at
  ambi order 1 (12 dense lines) and, in the slow set, 2;
* serving and the time domain: test_torch_coupled_directional_serving.py.
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_spatial_dataset
from diffgfdn_torch.losses import make_decay_envelopes
from diffgfdn_torch.training import build_gfdn_model, DirectionalGFDNTrainer
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import gather_batch
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.losses.spatial import make_decay_envelopes as jax_make_decay_envelopes
from diffgfdn_tpu.training.trainer import DirectionalGFDNTrainer as JaxDirectionalGFDNTrainer
from test_torch_directional_losses import _envelopes
from torch_option_parity import adam_error, OptionModels, UPDATE_TOL
from torch_port_helpers import (
    directional_raw_config,
    jax_directional_model_and_params,
    rel_l2,
    spatial_rooms,
)

BATCH = 4
IDX = np.array([0, 9, 21, 40])
H_TOL = 1e-3
LOSS_TOL = 1e-3
GRAD_TOL = 1e-2


def coupled_raw(tmp_path, order: int = 2) -> dict:
    raw = directional_raw_config(tmp_path, order, batch=BATCH, spectral_loss_weight=0.0)
    raw["feedback_loop_config"] = dict(use_zero_coupling=False)
    return raw


def coupled_models(tmp_path, rooms, order: int = 2) -> OptionModels:
    raw = coupled_raw(tmp_path, order)
    jroom, room = rooms
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jmodel, params = jax_directional_model_and_params(jcfg, jroom, BATCH)
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                             variant="directional", device="cpu",
                             desired_directions=room.desired_directions)
    load_jax_params(model, params)
    assert not model.feedback_loop.is_block_diagonal
    assert model.feedback_loop.alpha.shape == (3,)
    return OptionModels(raw, jcfg, jmodel, params, cfg, model, jroom, room)


@pytest.mark.parametrize("order", [1, pytest.param(2, marks=pytest.mark.slow)])
def test_step_and_adam_match_jax(tmp_path, order, record_property):
    """Ambi order 1 (a dense 12 x 12 loop) in the quick set; order 2 (27 x
    27: JAX's compile of its gradient takes some 50 s here) in the slow set;
    the card runs order 2 (chip_smoke.py phase 14 (c))."""
    m = coupled_models(tmp_path, spatial_rooms(tmp_path), order)
    times, length = _envelopes(m.jax_room, m.jcfg)
    jtrainer = JaxDirectionalGFDNTrainer(
        m.jmodel, m.jcfg.trainer_config, 1, common_decay_times=m.jax_room.common_decay_times,
        sample_rate=m.jcfg.sample_rate,
        directional_envelopes=np.asarray(jax_make_decay_envelopes(times, length,
                                                                  m.jcfg.sample_rate)))
    jbatch = gather_batch(jax_arrays(m.jax_room), IDX)
    key = jax.random.PRNGKey(11)
    inputs = {k: jbatch[k] for k in ("z_values", "listener_position", "norm_listener_position")}

    def total(p):
        losses = jtrainer._losses(p, jbatch, key)
        return sum(losses.values()), (losses, m.jmodel.apply(p, inputs)[0])

    (ref_total, (ref_losses, h_ref)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(m.params)
    trainer = DirectionalGFDNTrainer(
        m.model, m.cfg.trainer_config, 1, common_decay_times=m.port_room.common_decay_times,
        sample_rate=m.cfg.sample_rate, device="cpu",
        directional_envelopes=make_decay_envelopes(times, length, m.cfg.sample_rate))
    trainer.upload_arrays(arrays_from_spatial_dataset(m.port_room))
    batch = trainer.gather(torch.from_numpy(IDX))
    with torch.no_grad():
        h = m.model(batch).numpy()
    tot, losses = trainer.loss_and_grads(batch)
    assert sorted(losses) == sorted(ref_losses)
    loss_errs = {k: abs(float(losses[k]) - float(v)) / (abs(float(v)) or 1.0)
                 for k, v in ref_losses.items()}
    loss_errs["total"] = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(m.model)))
    flat = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat)
    grad_errs = {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(v)) for p, v in flat}
    assert "['params']['feedback_loop']['alpha']" in grad_errs
    h_err = rel_l2(h, np.asarray(h_ref))
    upd = adam_error(m, ref_grads)
    record_property("h_rel_l2", h_err)
    record_property("loss_rel", loss_errs)
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    record_property("adam_update_max_abs_diff", upd)
    assert h_err <= H_TOL
    assert max(loss_errs.values()) <= LOSS_TOL, loss_errs
    assert max(grad_errs.values()) <= GRAD_TOL, grad_errs
    assert upd <= UPDATE_TOL
