"""What the port's ``utils/plot.py`` unblocks, against the JAX package.

``save_feedback_matrix_animation`` writes its GIF from the port's
checkpoints, and the matrices it animates equal JAX's from the same
parameters (1e-6 of the largest value), SCALAR and FILTER coupling. The
common-slopes trainer writes a beamformer map per resolution, named as
JAX's. (That importing the port loads no matplotlib is
test_torch_hygiene.py's.)
"""

import jax
import numpy as np
import pytest

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.training import build_gfdn_model, save_checkpoint
from diffgfdn_torch.training.save_results import (
    feedback_matrices,
    save_feedback_matrix_animation,
)
from diffgfdn_torch.utils.params import jax_params_from_torch
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
from torch_port_helpers import raw_config

MATRIX_TOL = 1e-6


COUPLINGS = {"scalar": {"use_zero_coupling": False},
             "filter": {"coupling_matrix_type": "filter_matrix", "pu_matrix_order": 4}}


@pytest.mark.parametrize("coupling", sorted(COUPLINGS))
def test_feedback_matrix_animation_from_port_checkpoints(tmp_path, coupling, record_property):
    import torch

    raw = raw_config(tmp_path, svf=False)
    raw["feedback_loop_config"] = COUPLINGS[coupling]
    cfg = DiffGFDNConfig.from_dict(raw)
    cdt = np.array([1.0, 1.5, 1.2])
    model = build_gfdn_model(cfg, cdt, device="cpu")
    train_dir = tmp_path / "train"
    with torch.no_grad():
        for epoch in (-1, 0, 1):  # three checkpoints, the loop's parameters moved each time
            for p in model.feedback_loop.parameters():
                p.add_(0.05 * (epoch + 2) * torch.ones_like(p))
            save_checkpoint(train_dir, epoch, jax_params_from_torch(model))
    out = save_feedback_matrix_animation(model, train_dir, 2)
    assert out == str(train_dir / "feedback_matrix.gif") and (train_dir / "feedback_matrix.gif"
                                                                ).stat().st_size > 0
    mats, coups = feedback_matrices(model, train_dir, 2)
    assert len(mats) == 3 and (coups is None) == (coupling == "filter")

    from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint

    jmodel = jax_build_gfdn_model(JaxDiffGFDNConfig.model_validate(raw), common_decay_times=cdt,
                                  use_pallas_inverse=False)
    errs = []
    for epoch, mat in zip((-1, 0, 1), mats):
        params = jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(train_dir, epoch))
        want = np.asarray(jmodel.apply(
            params, method=lambda m: m.feedback_loop.coupled_feedback_matrix()))
        errs.append(float(np.abs(mat - want).max() / np.abs(want).max()))
        if coups is not None:
            want_c = np.abs(np.asarray(jmodel.apply(
                params, method=lambda m: m.feedback_loop.coupling_matrix())))
            errs.append(float(np.abs(coups[epoch + 1] - want_c).max()))
    record_property("max_rel", errs)
    assert max(errs) <= MATRIX_TOL, errs
    assert save_feedback_matrix_animation(model, tmp_path / "empty", 2) is None


def test_spatial_trainer_writes_beamformer_maps(tmp_path):
    from diffgfdn_torch.config import SpatialSamplingConfig
    from diffgfdn_torch.data import generate_spatial_three_room_pickle, SpatialThreeRoomDataset
    from diffgfdn_torch.training import run_training_spatial_sampling

    room = SpatialThreeRoomDataset(generate_spatial_three_room_pickle(
        tmp_path / "sp.pkl", grid_spacing_m=1.2, rir_len_s=0.1, decay_times=(0.03, 0.05, 0.04)))
    cfg = SpatialSamplingConfig.from_dict(dict(
        batch_size=8, seed=0, max_epochs=1, lr=5e-3, train_dir=str(tmp_path / "cs"),
        use_directional_rirs=True,
        dnn_config=dict(mlp_config=dict(num_neurons_per_layer=8, num_hidden_layers=1),
                        num_fourier_features=2)))
    run_training_spatial_sampling(cfg, room, grid_resolutions=[2.4], device="cpu")
    assert (tmp_path / "cs" / "beamformer_map_grid_resolution_m=2.400.png").stat().st_size > 0
