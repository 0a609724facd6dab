"""A whole 4-epoch common-slopes run against the JAX package: the same flax
initialization, split and seed through JAX's ``fit_indexed`` and the port's,
directional and omni. Each epoch's train and valid loss within 1e-3 relative
at epoch 1 and within 1e-2 at epoch 4 (recorded per epoch).
"""

import numpy as np
import pytest

from diffgfdn_torch.data import arrays_from_spatial_dataset, split_by_grid_resolution
from diffgfdn_torch.training import collapse_amplitudes_to_omni, SpatialSamplingTrainer
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.data.spatial_dataset import split_by_grid_resolution as jax_split
from diffgfdn_tpu.training.spatial_trainer import (
    collapse_amplitudes_to_omni as jax_collapse,
    SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
)
from torch_port_helpers import cs_configs, cs_models, cs_raw_config, cs_room_path, cs_rooms
from torch_port_helpers import CS_RESOLUTION_M

EPOCHS = 4
FIRST_TOL, LAST_TOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return cs_rooms(cs_room_path(tmp_path_factory.mktemp("cs_run")))


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_four_epoch_run_matches_jax(tmp_path, rooms, directional, record_property):
    jax_room, room = rooms
    if not directional:
        jax_room, room = jax_collapse(jax_room), collapse_amplitudes_to_omni(room)
    jcfg, cfg = cs_configs(cs_raw_config(tmp_path / "port", directional, EPOCHS))
    jcfg.train_dir = str(tmp_path / "jax")
    jmodel, params, model = cs_models(jcfg, cfg, jax_room)
    train_idx, valid_idx = split_by_grid_resolution(room, CS_RESOLUTION_M)
    for a, b in zip((train_idx, valid_idx), jax_split(jax_room, CS_RESOLUTION_M)):
        assert np.array_equal(a, b)

    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room,
                                         grid_resolution_m=CS_RESOLUTION_M)
    jtrainer.fit_indexed(params, jax_arrays(jax_room), train_idx, valid_idx, seed=jcfg.seed)
    trainer = SpatialSamplingTrainer(model, cfg, room, grid_resolution_m=CS_RESOLUTION_M,
                                     device="cpu")
    trainer.fit_indexed(arrays_from_spatial_dataset(room), train_idx, valid_idx, seed=cfg.seed)

    for name, port, ref in (("train", trainer.train_loss, jtrainer.train_loss),
                            ("valid", trainer.valid_loss, jtrainer.valid_loss)):
        assert len(port) == len(ref) == EPOCHS
        errs = [abs(p - r) / abs(r) for p, r in zip(port, ref)]
        record_property(f"{name}_loss_rel_per_epoch", errs)
        assert errs[0] <= FIRST_TOL and max(errs) <= LAST_TOL, (name, errs)
    assert trainer.train_loss[-1] < trainer.train_loss[0]
    ckpt = tmp_path / "port" / f"grid_resolution={CS_RESOLUTION_M:.1f}" / "checkpoints"
    assert sorted(p.name for p in ckpt.glob("model_e*.ckpt")) == [
        f"model_e{e}.ckpt" for e in range(EPOCHS)]
